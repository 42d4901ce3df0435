"""Depth/RGB encoder wrappers: spatial embeddings, pooling heads and the
precomputed-feature bypass (port of
vlnce_tpu/models/encoders/visual_wrappers.py; reference
vlnce_baselines/models/encoders/resnet_encoders.py:17-229).

Observations are NHWC ([B, H, W, C]); outputs follow the reference's
channel-first convention ([B, C, h, w], flattened to [B, C, P] by callers).
`depth_features` / `rgb_features` in the obs dict bypass the backbones
(DAgger's frozen-encoder caching rides on it). A backbone that is not
`trainable` has `requires_grad` off and runs under `torch.no_grad()` (the
JAX wrappers' `stop_gradient`). After a forward that ran the backbone, its
output is left in `cached_features` for the caller to read (the JAX wrappers
`sow` it); after a forward that took the bypass it is None.

With `spatial_output` (CMA) an encoder returns its map with the learned
spatial embedding appended as 64 channels; without it (Seq2Seq) it returns
ReLU(Linear(flattened map)) of `output_size` in f32: the depth map as it is,
the RGB map after a global average pool to [B, C, 1, 1]. What is cached is
what precedes that head, so a DAgger store of Seq2Seq holds the unpooled
depth map and the pooled RGB vector.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vlnce_torch.models.encoders.resnet import GNResNetEncoder, tv_resnet


def _nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    """A [B, H, W, C] tensor as a [B, C, H, W] view: channels_last in memory
    when the input is contiguous NHWC, with no copy."""
    return x.permute(0, 3, 1, 2)


def _spatial(x: torch.Tensor, emb: nn.Embedding) -> torch.Tensor:
    """Append the learned [h*w, 64] spatial embedding as 64 channels."""
    b, _, h, w = x.shape
    spatial = emb.weight.T.reshape(1, 64, h, w).to(x.dtype).expand(b, 64, h, w)
    return torch.cat([x, spatial], dim=1)


def _head(in_features: int, out_features: int) -> nn.Sequential:
    """The non-spatial head, by the reference's names (`<name>.1.weight`)."""
    return nn.Sequential(nn.Flatten(), nn.Linear(in_features, out_features), nn.ReLU(True))


class VlnResnetDepthEncoder(nn.Module):
    """GroupNorm ResNet over depth (reference resnet_encoders.py:17-115):
    [B, C+64, h, w] with `spatial_output`, else [B, output_size]
    (`visual_fc`)."""

    def __init__(self, input_hw: Tuple[int, int] = (256, 256), backbone: str = "resnet50",
                 resnet_baseplanes: int = 32, compute_dtype: torch.dtype = torch.float32, trainable: bool = False,
                 spatial_output: bool = True, output_size: int = 128):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.trainable = trainable
        self.spatial_output = spatial_output
        self.output_size = output_size
        self.cached_features = None
        self.visual_encoder = GNResNetEncoder(
            input_hw, 1, resnet_baseplanes, resnet_baseplanes // 2, backbone
        )
        if not trainable:
            self.visual_encoder.requires_grad_(False)
        c, h, w = self.visual_encoder.output_shape_chw()
        if spatial_output:
            self.spatial_embeddings = nn.Embedding(h * w, 64)
        else:
            self.visual_fc = _head(c * h * w, output_size)

    @property
    def output_shape(self):
        c, h, w = self.visual_encoder.output_shape_chw()
        return (c + 64, h, w) if self.spatial_output else (self.output_size,)

    def forward(self, observations):
        if "depth_features" in observations:
            x = observations["depth_features"]  # [B, C, h, w] (cached)
            self.cached_features = None
        else:
            depth = _nhwc_to_nchw(observations["depth"].to(self.compute_dtype))
            with torch.set_grad_enabled(self.trainable and torch.is_grad_enabled()):
                x = self.visual_encoder(depth)
            self.cached_features = x
        if self.spatial_output:
            return _spatial(x, self.spatial_embeddings)
        return self.visual_fc(x.float())


class TorchVisionResNetEncoder(nn.Module):
    """ImageNet ResNet over RGB with frozen eval-mode BatchNorm (reference
    resnet_encoders.py:118-229): spatial output [B, C+64, 4, 4], or with
    `spatial_output` off [B, output_size] (`fc` over the global average
    pool). Inputs are scaled to [0, 1] and, with normalize_visual_inputs,
    ImageNet-normalized (reference:182-192)."""

    def __init__(self, version: str = "resnet50", normalize_visual_inputs: bool = False,
                 single_spatial_filter: bool = True, compute_dtype: torch.dtype = torch.float32,
                 trainable: bool = False, spatial_output: bool = True, output_size: int = 256):
        super().__init__()
        self.normalize_visual_inputs = normalize_visual_inputs
        # reference quirk (resnet_encoders.py:160-162): with
        # single_spatial_filter=False the global avgpool is kept and the 4x4
        # adaptive pool then just broadcasts the pooled vector spatially
        self.single_spatial_filter = single_spatial_filter
        self.compute_dtype = compute_dtype
        self.trainable = trainable
        self.cached_features = None
        self.spatial_output = spatial_output
        self.output_size = output_size
        self.cnn, self.resnet_layer_size = tv_resnet(version)
        if not trainable:
            self.cnn.requires_grad_(False)
        if spatial_output:
            self.spatial_embeddings = nn.Embedding(16, 64)
        else:
            self.fc = _head(self.resnet_layer_size, output_size)

    @property
    def output_shape(self):
        return (self.resnet_layer_size + 64, 4, 4) if self.spatial_output else (self.output_size,)

    def forward(self, observations):
        if "rgb_features" in observations:
            x = observations["rgb_features"]  # [B, C, h, w] (cached)
            self.cached_features = None
        else:
            dt = self.compute_dtype
            rgb = observations["rgb"].to(dt) / 255.0  # [B, H, W, 3]
            if self.normalize_visual_inputs:
                mean = torch.tensor([0.485, 0.456, 0.406], dtype=dt, device=rgb.device)
                std = torch.tensor([0.229, 0.224, 0.225], dtype=dt, device=rgb.device)
                rgb = (rgb - mean) / std
            with torch.set_grad_enabled(self.trainable and torch.is_grad_enabled()):
                feats = self.cnn(_nhwc_to_nchw(rgb))
            if not self.spatial_output:
                x = feats.mean(dim=(2, 3), keepdim=True)  # the global average pool
            elif self.single_spatial_filter:
                x = F.adaptive_avg_pool2d(feats, (4, 4))
            else:
                x = feats.mean(dim=(2, 3), keepdim=True).expand(-1, -1, 4, 4)
            self.cached_features = x
        if self.spatial_output:
            return _spatial(x, self.spatial_embeddings)
        return self.fc(x.float())
