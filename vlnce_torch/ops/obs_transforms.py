"""Observation transformers on batched NHWC tensors.

Port of vlnce_tpu/ops/obs_transforms.py (reference
habitat_extensions/obs_transformers.py:21-145 plus habitat's
ResizeShortestEdge): per-sensor center crops, pano frame stacking (rgb,
rgb_1..rgb_11 -> one [B, 12, H, W, C] tensor) and shortest-edge resize. All
transforms take and return the batched obs dict on the policy's device.
Every resize goes through `fused_resize_normalize`, so on a CUDA tensor it is
one launch of the resize kernel.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from vlnce_torch.envs import spaces
from vlnce_torch.ops.preprocess import fused_resize_normalize
from vlnce_torch.registry import registry


class ObservationTransformer:
    def transform_observation_space(self, observation_space: spaces.Dict) -> spaces.Dict:
        return observation_space

    def __call__(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    @classmethod
    def from_config(cls, config):
        raise NotImplementedError


def center_crop(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """x: [..., H, W, C] -> center crop to hw (a view)."""
    H, W = x.shape[-3], x.shape[-2]
    th, tw = hw
    top = max(0, (H - th) // 2)
    left = max(0, (W - tw) // 2)
    return x[..., top : top + th, left : left + tw, :]


def resize_bilinear(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """[..., H, W, C] bilinear resize with the 2-tap half-pixel matrices of
    cv2/torch bilinear (not an antialiased resize). Integer images come back
    in their dtype, rounded half to even and clipped to [0, 255]; float
    images come back as f32."""
    if x.dtype == torch.uint8:
        out_dtype = torch.uint8
    elif x.dtype.is_floating_point:
        x, out_dtype = x.float(), torch.float32
    else:
        raise ValueError(f"resize_bilinear: takes u8 or float images, got {x.dtype}")
    flat = x.reshape((-1,) + tuple(x.shape[-3:])).contiguous()
    y = fused_resize_normalize(flat, tuple(hw), normalize=False, out_dtype=out_dtype, scale_values=False)
    return y.reshape(tuple(x.shape[:-3]) + tuple(y.shape[1:]))


@registry.register_obs_transformer(name="CenterCropperPerSensor")
class CenterCropperPerSensor(ObservationTransformer):
    """reference obs_transformers.py:21-86."""

    def __init__(self, sensor_crops: List[Tuple[str, Tuple[int, int]]]):
        self.sensor_crops = {k: tuple(v) for k, v in sensor_crops}

    def transform_observation_space(self, observation_space: spaces.Dict) -> spaces.Dict:
        out = dict(observation_space.spaces)
        for key, hw in self.sensor_crops.items():
            if key in out and tuple(out[key].shape[-3:-1]) != hw:
                s = out[key]
                new_shape = s.shape[:-3] + (hw[0], hw[1], s.shape[-1])
                out[key] = spaces.Box(s.low.min(), s.high.max(), new_shape, s.dtype)
        return spaces.Dict(out)

    def __call__(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out = dict(batch)
        for key, hw in self.sensor_crops.items():
            if key in out and tuple(out[key].shape[-3:-1]) != hw:
                x = out[key]
                if x.shape[-3] < hw[0] or x.shape[-2] < hw[1]:
                    x = resize_bilinear(x, hw)  # upscale-then-crop degenerate case
                out[key] = center_crop(x, hw)
        return out

    @classmethod
    def from_config(cls, config):
        return cls(config.RL.POLICY.OBS_TRANSFORMS.CENTER_CROPPER_PER_SENSOR.SENSOR_CROPS)


@registry.register_obs_transformer(name="ObsStack")
class ObsStack(ObservationTransformer):
    """Stack sensor rewrites (rgb, rgb_1, ...) into one leading frame axis
    (reference obs_transformers.py:89-145)."""

    def __init__(self, sensor_rewrites: List[Tuple[str, List[str]]]):
        self.rewrite_dict = {target: list(srcs) for target, srcs in sensor_rewrites}

    def transform_observation_space(self, observation_space: spaces.Dict) -> spaces.Dict:
        out = dict(observation_space.spaces)
        for target, srcs in self.rewrite_dict.items():
            if not all(s in out for s in srcs):
                continue
            first = out[srcs[0]]
            for s in srcs:
                out.pop(s, None)
            out[target] = spaces.Box(first.low.min(), first.high.max(), (len(srcs),) + tuple(first.shape), first.dtype)
        return spaces.Dict(out)

    def __call__(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out = dict(batch)
        for target, srcs in self.rewrite_dict.items():
            if not all(s in out for s in srcs):
                continue
            frames = [out.pop(s) for s in srcs]
            out[target] = torch.stack(frames, dim=1)  # [B, F, H, W, C]
        return out

    @classmethod
    def from_config(cls, config):
        return cls(config.RL.POLICY.OBS_TRANSFORMS.OBS_STACK.SENSOR_REWRITES)


@registry.register_obs_transformer(name="ResizeShortestEdge")
class ResizeShortestEdge(ObservationTransformer):
    """habitat's shortest-edge resize (used by the RxR configs)."""

    def __init__(self, size: int, trans_keys=("rgb", "depth", "semantic")):
        self.size = int(size)
        self.trans_keys = trans_keys

    def _target_hw(self, h: int, w: int) -> Tuple[int, int]:
        scale = self.size / min(h, w)
        return (int(h * scale), int(w * scale))

    def transform_observation_space(self, observation_space: spaces.Dict) -> spaces.Dict:
        out = dict(observation_space.spaces)
        for key in self.trans_keys:
            if key in out:
                s = out[key]
                th, tw = self._target_hw(s.shape[-3], s.shape[-2])
                if (th, tw) != tuple(s.shape[-3:-1]):
                    out[key] = spaces.Box(s.low.min(), s.high.max(), s.shape[:-3] + (th, tw, s.shape[-1]), s.dtype)
        return spaces.Dict(out)

    def __call__(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out = dict(batch)
        for key in self.trans_keys:
            if key in out:
                h, w = out[key].shape[-3], out[key].shape[-2]
                th, tw = self._target_hw(h, w)
                if (th, tw) != (h, w):
                    out[key] = resize_bilinear(out[key], (th, tw))
        return out

    @classmethod
    def from_config(cls, config):
        return cls(config.RL.POLICY.OBS_TRANSFORMS.RESIZE_SHORTEST_EDGE.SIZE)


def get_active_obs_transforms(config) -> List[ObservationTransformer]:
    return [
        registry.get_obs_transformer(name).from_config(config)
        for name in config.RL.POLICY.OBS_TRANSFORMS.ENABLED_TRANSFORMS
    ]


def apply_obs_transforms_batch(batch: Dict[str, torch.Tensor], transforms) -> Dict[str, torch.Tensor]:
    for t in transforms:
        batch = t(batch)
    return batch


def apply_obs_transforms_obs_space(observation_space: spaces.Dict, transforms) -> spaces.Dict:
    for t in transforms:
        observation_space = t.transform_observation_space(observation_space)
    return observation_space
