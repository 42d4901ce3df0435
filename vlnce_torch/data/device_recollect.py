"""Recollection rendered on the card: the GT trajectories re-rendered along
their actions, with no env pool.

Port of vlnce_tpu/trainers/device_recollect.py; here it sits beside its one
caller, data/recollection.py. The recollect trainer
re-simulates the ground-truth action sequences every epoch to regenerate
the observations (reference common/recollection_dataset.py:167-228). With
the device-resident grid world the actions are known up front, so a chunk
of B episodes is one render-and-step loop on the card: each step renders
every camera, reads the progress sensor, then applies the step's action
(`envs/device_sim.py`). STOP-padded tails do not move the agent, so padded
steps re-render the final pose; each episode is cut back to its GT length.

- **One env step is one replay of a CUDA graph** (`ops/graphs.StepGraph`):
  the chunk's scenes, start poses and [T_pad, B] actions are copied into
  the graph's input tensors (one upload per chunk), the pose, tilt and step
  counter g live in fixed tensors, and step g writes row g of the
  [T_pad, B, ...] outputs. Graphs are kept per (cameras, B, T_pad,
  ...) in a FIFO of at most _RENDER_CACHE_MAX that the caller owns.
- **The wire path** (`render_gt_episodes_on_device`, CUDA.ON_DEVICE_RECOLLECT)
  buckets T_pad to a multiple of 8 and reads the chunk back in one copy (its
  outputs are views of one byte buffer). f32 depth leaves as f16 and is
  upcast on the host, as in the JAX package: the frames are those of JAX.
- **The resident path** (`render_gt_batch_resident`, CUDA.RECOLLECT_RESIDENT)
  runs the obs transforms inside the render step (for RxR, the resize
  kernel B2 twice per step) and keeps the batch on the card, time-major
  [T_pad, N, ...] in natural shapes (the JAX package flattens them to
  [T_pad, N, F] for the TPU's tiles), T_pad bucketed to `length_quantum`.
  It feeds the IL accumulation step with no host round trip.

Left out of the JAX module: the mesh argument, which shards the render
over the chips of one process. Across ranks each rank renders its own
`rank_slice` of the episodes on its own card (`data/recollection.py`), as
the JAX package does under several processes.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from vlnce_torch.data.collate import _pad_to, inflection_weights
from vlnce_torch.envs.device_sim import (
    SceneBatch,
    camera_specs_from_config,
    episode_batch_arrays,
    progress_batch,
    render_batch,
    scene_batch,
    scene_inputs,
    step_batch,
    step_tilt,
    upload,
)
from vlnce_torch.envs.scene_import import apply_scene_geometry
from vlnce_torch.ops.graphs import StepGraph, cached_in
from vlnce_torch.ops.obs_transforms import apply_obs_transforms_batch

_RENDER_CACHE_MAX = 32


def _motion(sim_cfg) -> Tuple[float, float, float, bool]:
    """(forward step, turn angle, tilt angle, allow sliding) of the simulator."""
    return (float(sim_cfg.FORWARD_STEP_SIZE), math.radians(float(sim_cfg.TURN_ANGLE)),
            math.radians(float(getattr(sim_cfg, "TILT_ANGLE", sim_cfg.TURN_ANGLE))),
            bool(sim_cfg.HABITAT_SIM_V0.ALLOW_SLIDING))


class RenderSteps:
    """The render loop of a chunk of B episodes along [T_pad, B] actions.
    `load()` copies a chunk into the input tensors, `run()` replays the
    step T_pad times; `out` holds the [T_pad, B, ...] frames and progress.
    With `transforms` (the resident path) the obs transforms run inside the
    step; without (the wire path) f32 frames are written as f16 and every
    output is a view of one byte buffer, `packed`, for a single read-back."""

    def __init__(self, specs, motion, scenes: SceneBatch, pos, heading, actions, transforms=None, eager: bool = False):
        device = pos.device
        T_pad, B = actions.shape
        forward_step, turn_angle, tilt_angle, allow_sliding = motion
        self.T_pad, self.B = T_pad, B
        # the first chunk's inputs, so that the warm-up renders real scenes
        self.scenes = SceneBatch(*(t.clone() for t in scenes))
        self.pos, self.heading, self.actions = pos.clone(), heading.clone(), actions.clone()
        self.tilt = torch.zeros(B, device=device)
        self.g = torch.zeros(1, dtype=torch.int64, device=device)

        def compute():
            obs = render_batch(self.scenes, self.pos, self.heading, specs, tilt=self.tilt)
            obs["progress"] = progress_batch(self.scenes, self.pos)
            if transforms is None:
                obs = {k: v.to(torch.float16) if v.dtype == torch.float32 and k != "progress" else v
                       for k, v in obs.items()}
            else:
                obs = apply_obs_transforms_batch(obs, transforms)
            a = self.actions.index_select(0, self.g)[0]
            pos, heading = step_batch(self.scenes, self.pos, self.heading, a, forward_step, turn_angle, allow_sliding)
            return obs, pos, heading, step_tilt(self.tilt, a, tilt_angle)

        def commit(results):
            obs, pos, heading, tilt = results
            for k, v in obs.items():
                self.out[k].index_copy_(0, self.g, v[None])
            self.pos.copy_(pos)
            self.heading.copy_(heading)
            self.tilt.copy_(tilt)
            self.g.add_(1)

        with torch.no_grad():
            probe = compute()[0]  # the outputs' shapes and types
        shapes = {k: ((T_pad,) + tuple(v.shape), v.dtype) for k, v in probe.items()}
        del probe
        if transforms is None:
            self.packed, self.out = _packed(shapes, device)
        else:
            self.packed, self.out = None, {k: torch.empty(s, dtype=dt, device=device) for k, (s, dt) in shapes.items()}
        self.step = StepGraph(compute, commit, device, eager=eager)

    def load(self, scenes: SceneBatch, pos, heading, actions) -> None:
        for dst, src in zip(self.scenes, scenes):
            dst.copy_(src)
        self.pos.copy_(pos)
        self.heading.copy_(heading)
        self.actions.copy_(actions)
        self.tilt.zero_()
        self.g.zero_()

    def run(self) -> None:
        self.step.run(self.T_pad)

    def read_back(self) -> Dict[str, np.ndarray]:
        """The wire path's outputs on the host, from one copy."""
        host = self.packed.cpu().numpy().copy()  # on the CPU, .cpu() is the tensor itself
        out = {}
        for k, v in self.out.items():
            offset = v.data_ptr() - self.packed.data_ptr()
            dtype = torch.empty(0, dtype=v.dtype).numpy().dtype
            out[k] = host[offset : offset + v.numel() * v.element_size()].view(dtype).reshape(tuple(v.shape))
        return out


def _packed(shapes: Dict[str, Tuple[tuple, torch.dtype]], device) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One byte buffer on `device` and a view of it per name, each at a
    16-byte aligned offset."""
    sizes = {k: math.prod(shape) * torch.empty(0, dtype=dtype).element_size() for k, (shape, dtype) in shapes.items()}
    offsets = np.cumsum([0] + [-(-n // 16) * 16 for n in sizes.values()])
    packed = torch.zeros(max(int(offsets[-1]), 16), dtype=torch.uint8, device=device)
    return packed, {k: packed[int(o) : int(o) + sizes[k]].view(dtype).reshape(shape)
                    for (k, (shape, dtype)), o in zip(shapes.items(), offsets)}


def _chunk(config, episodes: List, trajectories: Dict, instr_uuid: str, quantum: int, device, instruction: bool):
    """A chunk's GT actions STOP-padded to T_pad (max length rounded up to
    `quantum`), and its scenes, start poses, actions (and instruction) on
    `device` in one upload. Returns (trajs, T_pad, host arrays, SceneBatch,
    device arrays)."""
    trajs = [trajectories[ep.episode_id] for ep in episodes]
    T_pad = -(-max(len(t) for t in trajs) // quantum) * quantum
    actions = np.zeros((T_pad, len(episodes)), np.int32)
    for b, traj in enumerate(trajs):
        actions[: len(traj), b] = [step[1] for step in traj]
    arrays = episode_batch_arrays(episodes, instr_uuid=instr_uuid, task_cfg=config.TASK_CONFIG)
    wanted = ("pos", "heading") + (("instruction",) if instruction else ())
    scene = scene_inputs(episodes)
    on_dev = upload({**{f"scene.{k}": v for k, v in scene.items()}, **{k: arrays[k] for k in wanted},
                     "actions": actions}, device)
    scenes, _ = scene_batch({k: on_dev.pop(f"scene.{k}") for k in scene})
    return trajs, T_pad, arrays, scenes, on_dev


def _render(config, kind: str, T_pad: int, scenes, on_dev, transforms, cache: Optional[Dict], eager: bool) -> RenderSteps:
    """The cached render loop of this chunk's shape, loaded and run."""
    sim_cfg = config.TASK_CONFIG.SIMULATOR
    apply_scene_geometry(sim_cfg)  # real-scene grids, if configured
    specs, motion = camera_specs_from_config(sim_cfg), _motion(sim_cfg)
    key = (kind, tuple(specs), tuple(scenes.occupancy.shape), T_pad, motion,
           tuple(type(t).__name__ for t in transforms or ()), eager)
    steps = cached_in({} if cache is None else cache, key, lambda: RenderSteps(
        specs, motion, scenes, on_dev["pos"], on_dev["heading"], on_dev["actions"], transforms, eager), _RENDER_CACHE_MAX)
    steps.load(scenes, on_dev["pos"], on_dev["heading"], on_dev["actions"])
    steps.run()
    return steps


def render_gt_batch_resident(config, episodes: List, trajectories: Dict, coef: float, instr_uuid: str = "instruction",
                             length_quantum: int = 16, transforms=(), device=None, cache: Optional[Dict] = None,
                             eager: bool = False):
    """One training batch rendered on the card and kept there
    (CUDA.RECOLLECT_RESIDENT): the obs transforms ran inside the render
    step, so the observations are the policy's inputs, time-major. Returns
    (obs {k: [T_pad, N, ...]} on the card, the instruction broadcast over
    T_pad among them; prev, masks, corrected, weights [T_pad, N] numpy built
    as the collate builds them). Padded steps re-render the final pose where
    the host path fills 1.0: loss-identical, since padded steps carry zero
    inflection weight and the RNN is causal."""
    device = torch.device(device or config.CUDA.DEVICE)
    trajs, T_pad, _, scenes, on_dev = _chunk(config, episodes, trajectories, instr_uuid, max(1, length_quantum), device,
                                             instruction=True)
    steps = _render(config, "resident", T_pad, scenes, on_dev, list(transforms), cache, eager)
    # the next batch of this shape overwrites the graph's outputs (perhaps
    # on the prefetch thread while this one trains): the batch is a copy
    obs = {k: v.clone() for k, v in steps.out.items()}
    instr = on_dev["instruction"]
    obs[instr_uuid] = instr[None].expand((T_pad,) + tuple(instr.shape))

    def column(i):
        return [_pad_to(np.asarray([s[i] for s in t], np.int64), T_pad, 0) for t in trajs]

    prev, corrected = np.stack(column(0), axis=1), np.stack(column(2), axis=1)
    weights = np.stack([_pad_to(inflection_weights(np.asarray([s[2] for s in t], np.int64), coef), T_pad, 0.0)
                        for t in trajs], axis=1)
    masks = np.ones((T_pad, len(episodes)), np.float32)
    masks[0] = 0.0
    return obs, prev, masks, corrected, weights


def render_gt_episodes_on_device(config, episodes: List, trajectories: Dict, coef: float,
                                 instr_uuid: str = "instruction", device=None, cache: Optional[Dict] = None,
                                 eager: bool = False) -> List[Tuple[Dict[str, np.ndarray], np.ndarray, np.ndarray,
                                                                    np.ndarray]]:
    """One chunk of episodes -> the (obs [T], prev [T], oracle [T], weights
    [T]) tuples TeacherRecollectionDataset.episodes() yields, with the
    observations rendered on the card along the GT actions (CUDA.
    ON_DEVICE_RECOLLECT) and read back in one copy."""
    device = torch.device(device or config.CUDA.DEVICE)
    trajs, T_pad, arrays, scenes, on_dev = _chunk(config, episodes, trajectories, instr_uuid, 8, device,
                                                  instruction=False)
    seq = _render(config, "wire", T_pad, scenes, on_dev, None, cache, eager).read_back()
    out = []
    for b, traj in enumerate(trajs):
        T_ep = len(traj)
        obs = {k: v[:T_ep, b].astype(np.float32) if v.dtype == np.float16 else v[:T_ep, b].copy()
               for k, v in seq.items()}
        obs[instr_uuid] = np.repeat(arrays["instruction"][b][None], T_ep, axis=0)
        oracle = np.asarray([s[2] for s in traj], np.int64)
        out.append((obs, np.asarray([s[0] for s in traj], np.int64), oracle, inflection_weights(oracle, coef)))
    return out
