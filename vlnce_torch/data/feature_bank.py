"""Precomputed visual features per (node, heading) of a scene: the route by
which scenes that cannot be rendered on the card ride its closed loops.

Port of vlnce_tpu/data/feature_bank.py. The policy never needs pixels when
frozen-encoder features are given: the visual encoders take
``rgb_features`` / ``depth_features`` observation keys in place of the
frames (models/encoders/visual_wrappers.py), the reference's precompute
contract (habitat_extensions/sensors.py:186-196,
resnet_encoders.py:92-95). So a scene's features are computed once at every
(node, heading bin) pose, with any renderer (`encode_scene_bank` renders
the grid world on the card), and the loops on the card (scan eval and
DAgger collection with CUDA.FEATURE_BANK_DIR) look them up at each step in
place of rendering:

    nearest node = argmin over the nodes' squared distances
    heading bin  = round(heading / bin) mod H   (half to even)
    features     = bank[b, node, bin]            (one gather, f16 -> f32)

The JAX package contracts one-hot matrices with the bank (the TPU's rule:
table lookups as matmuls); here they are gathers, as in envs/device_sim.py.
A one-hot contraction of f16 values in f32 is exact, so both give the same
numbers.

Bank schema (one ``{scene}.npz`` per scene, the JAX package's, so each
package reads banks the other wrote):
    node_pos        [M, 2]  f32   world (x, z) per node
    num_headings    scalar  int   H heading bins, bin k = k * 2pi/H
    rgb_features    [M, H, F_rgb]   f16 (flattened encoder features)
    depth_features  [M, H, F_depth] f16
    rgb_shape / depth_shape         the features' shapes before flattening
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from vlnce_torch.envs.device_sim import SceneBatch, progress_batch, render_batch, upload
from vlnce_torch.ops.obs_transforms import apply_obs_transforms_batch
from vlnce_torch.utils.logging import logger


class FeatureBankBatch(NamedTuple):
    """Per-episode bank tensors stacked on a leading env axis. The node axis
    is padded to the batch's largest M; padding nodes sit at 1e9, so that the
    nearest-node argmin never selects them."""

    node_pos: torch.Tensor  # [B, M, 2] f32
    rgb: torch.Tensor  # [B, M, H, F_rgb] f16
    depth: torch.Tensor  # [B, M, H, F_depth] f16
    rgb_shape: Tuple[int, ...]
    depth_shape: Tuple[int, ...]

    @property
    def num_headings(self) -> int:
        return int(self.rgb.shape[2])

    def clone(self) -> "FeatureBankBatch":
        return self._replace(node_pos=self.node_pos.clone(), rgb=self.rgb.clone(), depth=self.depth.clone())

    def copy_(self, src: "FeatureBankBatch") -> None:
        """Another chunk's banks of the same shapes into these tensors (a
        captured step reads them in place)."""
        for dst, t in ((self.node_pos, src.node_pos), (self.rgb, src.rgb), (self.depth, src.depth)):
            dst.copy_(t)


def save_scene_bank(path: str, node_pos: np.ndarray, rgb_features: np.ndarray, depth_features: np.ndarray,
                    rgb_shape: Tuple[int, ...], depth_shape: Tuple[int, ...]) -> None:
    """One scene's bank as an npz of the schema above. Unlike the JAX
    package's writer it does not compress: zlib gains little on f16
    features and is slow, and every chunk of a loop that loads the bank
    would pay the inflation again. Each package's loader reads either."""
    M, H = rgb_features.shape[:2]
    np.savez(
        path,
        node_pos=node_pos.astype(np.float32),
        num_headings=np.int32(H),
        rgb_features=rgb_features.astype(np.float16).reshape(M, H, -1),
        depth_features=depth_features.astype(np.float16).reshape(M, H, -1),
        rgb_shape=np.asarray(rgb_shape, np.int32),
        depth_shape=np.asarray(depth_shape, np.int32),
    )


def _scene_key(scene_id: str) -> str:
    return os.path.splitext(os.path.basename(str(scene_id)))[0]


def _bank_path(bank_dir: str, scene_id: str) -> str:
    sid = _scene_key(scene_id)
    path = os.path.join(bank_dir, f"{sid}.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"feature bank for scene {sid!r} not found at {path}; write it with "
            f"vlnce_torch.data.feature_bank.encode_scene_bank and save_scene_bank"
        )
    return path


def load_bank_shapes(bank_dir: str, episode) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """The feature shapes recorded in an episode's scene bank, read without
    loading the feature arrays (npz members load on access)."""
    with np.load(_bank_path(bank_dir, episode.scene_id)) as z:
        return tuple(int(x) for x in z["rgb_shape"]), tuple(int(x) for x in z["depth_shape"])


def load_bank_batch(bank_dir: str, episodes: List, m_quantum: int = 64, device="cpu") -> FeatureBankBatch:
    """The scene banks of a batch of episodes, stacked, in one upload. The
    node axis M is padded up to a multiple of `m_quantum`: the loops' step
    graphs are cached by shape, and chunks over scenes with different node
    counts then share one."""
    cache: Dict[str, dict] = {}
    loaded = []
    for ep in episodes:
        sid = _scene_key(ep.scene_id)
        if sid not in cache:
            with np.load(_bank_path(bank_dir, ep.scene_id)) as z:
                cache[sid] = {k: z[k] for k in z.files}
        loaded.append(cache[sid])

    H = int(loaded[0]["num_headings"])
    rgb_shape = tuple(int(x) for x in loaded[0]["rgb_shape"])
    depth_shape = tuple(int(x) for x in loaded[0]["depth_shape"])
    if any(int(z["num_headings"]) != H for z in loaded):
        raise ValueError("feature banks disagree on num_headings")

    M = max(z["node_pos"].shape[0] for z in loaded)
    if m_quantum > 1:
        M = -(-M // m_quantum) * m_quantum
    B = len(loaded)
    node_pos = np.full((B, M, 2), 1e9, np.float32)
    rgb = np.zeros((B, M, H, loaded[0]["rgb_features"].shape[-1]), np.float16)
    depth = np.zeros((B, M, H, loaded[0]["depth_features"].shape[-1]), np.float16)
    for b, z in enumerate(loaded):
        m = z["node_pos"].shape[0]
        node_pos[b, :m] = z["node_pos"]
        rgb[b, :m] = z["rgb_features"]
        depth[b, :m] = z["depth_features"]
    on_dev = upload({"node_pos": node_pos, "rgb": rgb, "depth": depth}, device)
    logger.info(f"feature bank batch: {B} episodes, M<={M} nodes x {H} headings, "
                f"{(rgb.nbytes + depth.nbytes) / 2**20:.1f} MiB on {torch.device(device)}")
    return FeatureBankBatch(on_dev["node_pos"], on_dev["rgb"], on_dev["depth"], rgb_shape, depth_shape)


def lookup_features(bank: FeatureBankBatch, pos: torch.Tensor, heading: torch.Tensor, max_dist: float = 0.0,
                    return_distance: bool = False):
    """The features at each env's nearest (node, heading bin), by gathers;
    nothing in it reads a value back, so it runs inside a captured step.

    pos [B, 3] world position, heading [B] radians (counter-clockwise, the
    device sim's convention). Returns {"rgb_features": [B, *rgb_shape],
    "depth_features": [B, *depth_shape]} in f32. With `max_dist` > 0, an env
    farther than it from every node gets zero features (a pose that left the
    bank's coverage must not see a far node's view); with `return_distance`
    also the nearest node's distance [B]."""
    B, M, H = bank.rgb.shape[:3]
    xz = torch.stack([pos[:, 0], pos[:, 2]], dim=-1)  # [B, 2]
    d2 = ((bank.node_pos - xz[:, None, :]) ** 2).sum(dim=-1)  # [B, M]
    d2min, node = d2.min(dim=-1)  # the first minimum, as argmin
    bin_w = torch.full_like(heading, 2.0 * math.pi / H)  # a divisor tensor: a true division, not a reciprocal
    hbin = torch.remainder(torch.round(heading / bin_w).to(torch.int64), H)
    rows = torch.arange(B, device=pos.device)
    rgb = bank.rgb[rows, node, hbin].float()
    depth = bank.depth[rows, node, hbin].float()
    if max_dist and max_dist > 0.0:
        covered = (d2min <= float(max_dist) ** 2).float()[:, None]
        rgb = rgb * covered
        depth = depth * covered
    obs = {"rgb_features": rgb.reshape((B,) + bank.rgb_shape), "depth_features": depth.reshape((B,) + bank.depth_shape)}
    if return_distance:
        return obs, torch.sqrt(d2min)
    return obs


def check_bank_coverage(bank_dir: str, episodes: List, max_dist: float) -> None:
    """At load time: every episode's start must lie within `max_dist` of a
    bank node (a missing node or another scene's bank fails here, not as a
    rollout on zero features)."""
    if not max_dist or max_dist <= 0.0:
        return
    worst = (None, 0.0)
    for ep in episodes:
        with np.load(_bank_path(bank_dir, ep.scene_id)) as z:
            nodes = z["node_pos"]
        p = np.asarray(ep.start_position, np.float64)
        d = float(np.min(np.hypot(nodes[:, 0] - p[0], nodes[:, 1] - p[-1])))
        if d > worst[1]:
            worst = (ep.episode_id, d)
    if worst[1] > max_dist:
        raise ValueError(
            f"feature bank does not cover episode {worst[0]}: start is {worst[1]:.2f} m from the nearest bank node "
            f"(CUDA.FEATURE_BANK_MAX_DIST={max_dist}); regenerate the bank with denser nodes or raise the radius"
        )


def lattice_nodes(scene, spacing: float) -> np.ndarray:
    """A scene's navigable cells on a lattice `spacing` meters apart -> [M, 2]
    world (x, z): the bank generator's nodes where no connectivity graph is
    given (a copy of scripts/generate_feature_bank.lattice_nodes). Of the
    k x k lattice phases, the one covering the most navigable cells."""
    n = scene.occupancy.shape[0]
    res = scene.cell_to_world(1, 0)[0] - scene.cell_to_world(0, 0)[0]
    k = max(1, int(round(spacing / res)))
    nav = ~scene.occupancy.astype(bool)
    best, best_count = (0, 0), -1
    for oi in range(min(k, n)):
        for oj in range(min(k, n)):
            count = int(nav[oi::k, oj::k].sum())
            if count > best_count:
                best, best_count = (oi, oj), count
    if best_count <= 0:
        raise RuntimeError(f"no navigable lattice nodes in scene {scene.scene_id}")
    oi, oj = best
    return np.asarray([scene.cell_to_world(i, j) for i in range(oi, n, k) for j in range(oj, n, k) if nav[i, j]],
                      np.float32)


@torch.no_grad()
def encode_poses(policy, transforms, specs, scene_batch: SceneBatch, pos: np.ndarray, heading: np.ndarray,
                 instr_shape: Tuple[int, ...] = (8,), instr_uuid: str = "instruction"):
    """Render a batch of poses with the device sim on the policy's device and
    run the policy's frozen encoders. Returns (rgb [N, F], depth [N, F],
    rgb_shape, depth_shape) as numpy f32."""
    n = pos.shape[0]
    device = policy.device
    on_dev = upload({"pos": pos.astype(np.float32), "heading": heading.astype(np.float32)}, device)
    obs = render_batch(scene_batch, on_dev["pos"], on_dev["heading"], specs)
    obs["progress"] = progress_batch(scene_batch, on_dev["pos"])
    obs[instr_uuid] = torch.zeros((n,) + tuple(instr_shape), dtype=torch.int32, device=device)
    batch = apply_obs_transforms_batch(obs, transforms)
    _, _, feats = policy.act_with_features(
        batch, policy.initial_rnn_states(n), torch.zeros(n, 1, dtype=torch.long, device=device),
        torch.ones(n, 1, device=device), deterministic=True,
    )
    rgb, depth = feats["rgb_features"].float().cpu().numpy(), feats["depth_features"].float().cpu().numpy()
    return rgb.reshape(n, -1), depth.reshape(n, -1), tuple(rgb.shape[1:]), tuple(depth.shape[1:])


def encode_scene_bank(policy, transforms, specs, scene, nodes: np.ndarray, headings: np.ndarray, chunk: int = 256,
                      instr_shape: Tuple[int, ...] = (8,), instr_uuid: str = "instruction"):
    """Encode every (node, heading) pose of one scene, `chunk` poses per
    forward -> (rgb [M, H, F_rgb], depth [M, H, F_depth], rgb_shape,
    depth_shape), ready for `save_scene_bank`. (The JAX package pads the last
    chunk to `chunk` poses so that one compiled program serves the run; the
    forward here is eager, so the last chunk is simply shorter.)"""
    M, H = nodes.shape[0], len(headings)
    total = M * H
    # every (node, heading) pose, node-major
    pos = np.zeros((total, 3), np.float32)
    pos[:, 0] = np.repeat(nodes[:, 0], H)
    pos[:, 2] = np.repeat(nodes[:, 1], H)
    head = np.tile(np.asarray(headings, np.float32), M)
    width = min(chunk, total)
    grid = scene.occupancy.shape
    scenes = SceneBatch(**upload({
        "occupancy": np.broadcast_to(scene.occupancy.astype(bool), (width,) + grid),
        "wall_colors": np.broadcast_to(scene.wall_colors, (width,) + scene.wall_colors.shape),
        "floor_color": np.broadcast_to(scene.floor_color, (width, 3)),
        "ceil_color": np.broadcast_to(scene.ceil_color, (width, 3)),
        "goal_field": np.ones((width,) + grid, np.float32),
        "d0": np.ones((width,), np.float32),
        "origin_xz": np.broadcast_to(np.asarray(scene.origin, np.float32), (width, 2)),
    }, policy.device))
    rgb_rows, depth_rows = [], []
    rgb_shape = depth_shape = None
    for lo in range(0, total, width):
        hi = min(lo + width, total)
        part = scenes if hi - lo == width else SceneBatch(*(t[: hi - lo] for t in scenes))
        rgb, depth, rgb_shape, depth_shape = encode_poses(policy, transforms, specs, part, pos[lo:hi], head[lo:hi],
                                                          instr_shape=instr_shape, instr_uuid=instr_uuid)
        rgb_rows.append(rgb)
        depth_rows.append(depth)
    return (np.concatenate(rgb_rows).reshape(M, H, -1), np.concatenate(depth_rows).reshape(M, H, -1),
            rgb_shape, depth_shape)
