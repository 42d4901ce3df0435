"""Device-resident grid world: the host GridWorldSim's scenes, dynamics,
expert and raycast renderer as torch ops on batched tensors.

Port of vlnce_tpu/envs/device_sim.py. The host simulator
(envs/gridworld.py) steps one env at a time in float64 numpy; this module
runs the same world for a batch of B envs on the policy's device in float32,
so that a closed loop (render -> obs transforms -> act -> collision-filtered
step) needs no host round trip per step (trainers/scan_eval.py,
trainers/device_dagger.py).

Where the JAX module takes one env and is vmapped, every function here takes
the env axis B first: occupancy [B, N, N], pos [B, 3], heading [B], and so
on. A point lookup `grid[b, ci, cj]` is a gather on the flattened grid
(`_lookup`), exact for every dtype (the JAX module's one-hot contraction
exists only because a dynamic gather lowers to the TPU's scalar unit). The
dtypes and the clipping are JAX's: positions and angles are f32, a world
coordinate becomes a cell by truncation toward zero and a clip, rays are
sampled every 0.6 x _RES, RGB is u8 as `(color * shade).to(uint8)`, depth
is f32 normalized as the camera's spec says. Nothing here synchronizes with
the host: every shape is static and no value is read back, so a step of
these ops can be captured in a CUDA graph (the x, z columns of a pose are
the slice `[:, 0::2]`, not a list index, which would copy the list from the
host).

Imported real-scene geometry (`SIMULATOR.GEOMETRY_DIR`,
`CONNECTIVITY_GRAPHS`; envs/scene_import.py) reaches these functions
through `get_scene`, as procedural scenes do: an imported scene keeps its
native world frame, so `SceneBatch.origin_xz` is nonzero, and chunks of
mixed grid sizes pad to their largest (`scene_inputs`).

A batch's goal fields are built on its device (`scene_batch`, one launch of
ops/goal_field's kernel on the card), not by the host's Dijkstra: the host
uploads only the goals' cells.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from vlnce_torch.envs.gridworld import _RES, get_scene
from vlnce_torch.ops.goal_field import goal_distance_fields
from vlnce_torch.utils.profiling import annotate

_WALL_HEIGHT = 2.0
_EYE = 1.0  # _EYE_HEIGHT_FRAC * _WALL_HEIGHT
_TWO_PI = 2.0 * math.pi


class CameraSpec(NamedTuple):
    """Static per-camera render parameters."""

    uuid: str
    height: int
    width: int
    hfov_deg: float
    orientation_y: float
    kind: str  # "rgb" | "depth"
    min_depth: float = 0.0
    max_depth: float = 10.0
    normalize_depth: bool = True


def camera_specs_from_config(sim_config) -> List[CameraSpec]:
    """The cameras GridWorldSim.__init__ parses from the same config."""
    depth_cfg = getattr(sim_config, "DEPTH_SENSOR", None)
    min_d = float(depth_cfg.MIN_DEPTH) if depth_cfg else 0.0
    max_d = float(depth_cfg.MAX_DEPTH) if depth_cfg else 10.0
    norm_d = bool(depth_cfg.NORMALIZE_DEPTH) if depth_cfg else True
    specs = []
    for name in sim_config.AGENT_0.SENSORS:
        cam = getattr(sim_config, name, None)
        if cam is None:
            continue
        kind = "depth" if "DEPTH" in name else "rgb"
        orientation_y = float(cam.ORIENTATION[1]) if "ORIENTATION" in cam else 0.0
        specs.append(
            CameraSpec(cam.UUID, int(cam.HEIGHT), int(cam.WIDTH), float(cam.HFOV), orientation_y, kind, min_d, max_d, norm_d)
        )
    return specs


def upload(arrays: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """numpy arrays -> tensors on `device` in one host-to-device copy: the
    arrays are packed into one pinned byte buffer (each at a 16-byte
    offset), copied once, and viewed back in their dtypes and shapes."""
    device = torch.device(device)
    if device.type != "cuda":
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in arrays.items()}
    offsets, total = {}, 0
    for k, v in arrays.items():
        offsets[k] = total
        total += -(-np.asarray(v).nbytes // 16) * 16
    host = torch.empty(max(total, 16), dtype=torch.uint8, pin_memory=True)
    host_np = host.numpy()
    for k, v in arrays.items():
        v = np.ascontiguousarray(v)
        host_np[offsets[k] : offsets[k] + v.nbytes] = v.reshape(-1).view(np.uint8)
    buf = host.to(device, non_blocking=True)
    out = {}
    for k, v in arrays.items():
        v = np.asarray(v)
        dtype = torch.from_numpy(np.zeros(0, v.dtype)).dtype
        out[k] = buf[offsets[k] : offsets[k] + v.nbytes].view(dtype).reshape(v.shape)
    return out


class SceneBatch(NamedTuple):
    """Per-episode scene and goal tensors, stacked on a leading env axis.
    `origin_xz` anchors each grid in world coordinates (the x, z of cell
    [0, 0]'s corner); procedural scenes sit at (0, 0)."""

    occupancy: torch.Tensor  # [B, N, N] bool, True = blocked
    wall_colors: torch.Tensor  # [B, N, N, 3] uint8
    floor_color: torch.Tensor  # [B, 3] uint8
    ceil_color: torch.Tensor  # [B, 3] uint8
    goal_field: torch.Tensor  # [B, N, N] f32 geodesic meters to the episode's goals (inf = unreachable)
    d0: torch.Tensor  # [B] f32 start geodesic distance (the progress sensor's denominator)
    origin_xz: torch.Tensor  # [B, 2] f32 world (x, z) of cell [0, 0]'s corner


def _pad_grid(a: np.ndarray, n: int, fill) -> np.ndarray:
    """Pad a [N, N, ...] grid to [n, n, ...] with `fill` (blocked occupancy,
    +inf fields), so out-of-scene lookups read as boundary walls."""
    if a.shape[0] == n:
        return a
    pad = [(0, n - a.shape[0]), (0, n - a.shape[1])] + [(0, 0)] * (a.ndim - 2)
    return np.pad(a, pad, constant_values=fill)


def scene_inputs(episodes) -> Dict[str, np.ndarray]:
    """The host arrays `scene_batch` builds a batch's SceneBatch from, for
    one `upload`: the scenes' grids padded to the batch's largest
    (occupancy blocked, wall colours 0), their colours and origins; the
    batch's distinct goals, `field_cells` [F, 3] int32 (a row of the batch
    on the goal's scene, and the goal's cell as the host's Dijkstra snaps it,
    BaseScene.snap_goal_cell); each episode's goals as rows of field_cells,
    `goal_index` [B, G] int32, padded with F (no goal); `start_cell` [B, 2]
    int32; `d0` [B] f32, the episode's annotated start distance
    (info["geodesic_distance"], as the host progress sensor reads it), or -1
    where the field at the start cell gives it."""
    occ, colors, floor, ceil, origins, starts, d0s, rows = [], [], [], [], [], [], [], []
    index: Dict[Tuple[str, int, int], int] = {}
    field_cells: List[Tuple[int, int, int]] = []
    for b, ep in enumerate(episodes):
        scene = get_scene(ep.scene_id)
        occ.append(scene.occupancy)
        colors.append(scene.wall_colors)
        floor.append(scene.floor_color)
        ceil.append(scene.ceil_color)
        origins.append(scene.origin)
        row = []
        for goal in ep.goals:
            g = np.asarray(goal.position, dtype=np.float64)
            cell = scene.snap_goal_cell(*scene.world_to_cell(float(g[0]), float(g[-1])))
            key = (ep.scene_id, *cell)
            if key not in index:
                index[key] = len(field_cells)
                field_cells.append((b, *cell))
            row.append(index[key])
        rows.append(row)
        s = np.asarray(ep.start_position, dtype=np.float64)
        starts.append(scene.world_to_cell(float(s[0]), float(s[-1])))
        info = getattr(ep, "info", None) or {}
        d0 = float(info.get("geodesic_distance") or 0.0)
        d0s.append(d0 if d0 > 0.0 else -1.0)
    n = max(a.shape[0] for a in occ)
    goal_index = np.full((len(rows), max(len(r) for r in rows)), len(field_cells), np.int32)
    for b, row in enumerate(rows):
        goal_index[b, : len(row)] = row
    return {
        "occupancy": np.stack([_pad_grid(a, n, True) for a in occ]),
        "wall_colors": np.stack([_pad_grid(a, n, 0) for a in colors]),
        "floor_color": np.stack(floor),
        "ceil_color": np.stack(ceil),
        "origin_xz": np.array(origins, dtype=np.float32),
        "field_cells": np.array(field_cells, dtype=np.int32).reshape(-1, 3),
        "goal_index": goal_index,
        "start_cell": np.array(starts, dtype=np.int32),
        "d0": np.array(d0s, dtype=np.float32),
    }


def goal_fields(occupancy, field_cells, goal_index, start_cell, d0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Episodes' goal fields on the device: the distinct goals' fields
    (`field_cells` [F, 3] int32, rows of `occupancy` [R, N, N]) in one
    launch of `goal_distance_fields` (f64, equal to the host's Dijkstra
    fields); each episode's field the minimum of its goals' (`goal_index`
    [E, G], padded with F: the host's min over goals,
    GridWorldSim.geodesic_distance) in f32, +inf in the padding; d0 [E] the
    given distance, else (where it is below 0) max(field at `start_cell`
    [E, 2], 1e-6) in f32. Returns (goal_field [E, N, N], d0, fields
    [F + 1, N, N] f32): an episode's field of its k-th goal is
    fields[goal_index[:, k]], the last row +inf. Nothing reads back from the
    device."""
    n = occupancy.shape[-1]
    fields = goal_distance_fields(occupancy, field_cells, _RES)
    fields = torch.cat([fields, fields.new_full((1, n, n), math.inf)])
    index = goal_index.long()
    start = start_cell[:, 0].long() * n + start_cell[:, 1].long()
    at_start = fields.reshape(-1, n * n)[index, start[:, None]].amin(dim=1)
    d0 = torch.where(d0 < 0, at_start.clamp(min=1e-6).to(torch.float32), d0)
    fields = fields.to(torch.float32)  # the cast commutes with the minimum over goals
    goal_field = fields[index[:, 0]]
    for k in range(1, index.shape[1]):
        goal_field = torch.minimum(goal_field, fields[index[:, k]])
    return goal_field, d0, fields


def scene_batch(t: Dict[str, torch.Tensor]) -> Tuple[SceneBatch, torch.Tensor]:
    """The SceneBatch of `scene_inputs`' arrays on the device, its goal
    fields and d0 by `goal_fields` in the span `scan.field_build`. Returns
    (SceneBatch, fields [F + 1, N, N] f32), as `goal_fields` returns them."""
    with annotate("scan.field_build"):
        goal_field, d0, fields = goal_fields(t["occupancy"], t["field_cells"], t["goal_index"], t["start_cell"], t["d0"])
        scenes = SceneBatch(t["occupancy"], t["wall_colors"], t["floor_color"], t["ceil_color"], goal_field, d0,
                            t["origin_xz"])
    return scenes, fields


def build_scene_batch(episodes, device="cpu") -> SceneBatch:
    """The scenes of a batch of episodes on `device`, in one upload."""
    return scene_batch(upload(scene_inputs(episodes), device))[0]


def scene_arrays(episodes) -> Dict[str, np.ndarray]:
    """`build_scene_batch` on the CPU as host arrays, by SceneBatch field."""
    return {k: v.numpy() for k, v in build_scene_batch(episodes)._asdict().items()}


# ---------------------------------------------------------------------------
# lookups and navigation primitives (batched over the leading env axis)
# ---------------------------------------------------------------------------


def _lookup(grid: torch.Tensor, ci: torch.Tensor, cj: torch.Tensor) -> torch.Tensor:
    """grid[b, ci[b, ...], cj[b, ...]] as one gather on the flattened grid.
    grid [B, N, M] or [B, N, M, C] of any dtype; ci, cj integer [B, ...] in
    range. Returns grid's dtype, shape ci.shape (+ [C])."""
    B, n, m = grid.shape[:3]
    idx = (ci.long() * m + cj.long()).reshape(B, -1)
    if grid.dim() == 3:
        return grid.reshape(B, n * m).gather(1, idx).reshape(ci.shape)
    c = grid.shape[3]
    flat = grid.reshape(B, n * m, c)
    return flat.gather(1, idx[:, :, None].expand(-1, -1, c)).reshape(tuple(ci.shape) + (c,))


def _linspace(start: float, stop: float, num: int, device) -> torch.Tensor:
    """jnp.linspace in f32: start * (1 - s) + stop * s with s = i / (num - 1),
    and the endpoint exact."""
    div = num - 1
    s = torch.arange(div, dtype=torch.float32, device=device) / div
    out = _full(start, device) * (1 - s) + _full(stop, device) * s
    return torch.cat([out, _full(stop, device).reshape(1)])


def _full(value: float, device) -> torch.Tensor:
    """An f32 scalar made on `device` by a fill, not a host copy (which a
    CUDA graph's capture refuses)."""
    return torch.full((), value, dtype=torch.float32, device=device)


def _origin(origin: Optional[torch.Tensor], like: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ox, oz) [B]; zeros for origin None."""
    if origin is None:
        z = like.new_zeros(like.shape[0])
        return z, z
    return origin[:, 0], origin[:, 1]


def _expand(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """[B] -> [B, 1, ..., 1] broadcasting against `like` [B, ...]."""
    return v.reshape((-1,) + (1,) * (like.dim() - 1))


def _cell_index(x: torch.Tensor, z: torch.Tensor, n: int, origin=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """World x, z [B, ...] -> cell indices: truncation toward zero, then a
    clip to the grid (gridworld.py's world_to_cell)."""
    ox, oz = _origin(origin, x)
    ci = ((x - _expand(ox, x)) / _RES).to(torch.int32).clamp(0, n - 1)
    cj = ((z - _expand(oz, z)) / _RES).to(torch.int32).clamp(0, n - 1)
    return ci, cj


def is_navigable(occupancy: torch.Tensor, pos: torch.Tensor, origin=None) -> torch.Tensor:
    """occupancy [B, N, N]; pos [B, ..., 3] -> bool [B, ...]."""
    ci, cj = _cell_index(pos[..., 0], pos[..., 2], occupancy.shape[1], origin)
    return ~_lookup(occupancy, ci, cj)


def _advance(occupancy, start, delta, ts, origin=None):
    """Walk start -> start + delta at fractions ts ([K] or [B, K]), stopping
    before the first blocked sample (the host step_filter's forward walk).
    Returns (pos [B, 3], fully_reached [B])."""
    if ts.dim() == 1:
        ts = ts[None, :]
    cands = start[:, None, :] + delta[:, None, :] * ts[:, :, None]  # [B, K, 3]
    nav = is_navigable(occupancy, cands, origin)  # [B, K]
    k = torch.cumprod(nav.to(torch.int32), dim=1).sum(dim=1)  # leading-True count
    idx = (k - 1).clamp(min=0)
    picked = cands.gather(1, idx[:, None, None].expand(-1, 1, 3))[:, 0]
    pos = torch.where((k > 0)[:, None], picked, start)
    return pos, k == cands.shape[1]


def _slide(occupancy, pos, end, ts, origin=None):
    """Habitat's allow_sliding after a blocked walk: advance along x, then z,
    where the axis' full remaining move lands on a free cell."""
    remaining = end - pos
    for axis in (0, 2):
        shift = torch.zeros_like(pos)
        shift[:, axis] = remaining[:, axis]
        target_ok = is_navigable(occupancy, pos + shift, origin)
        slid, _ = _advance(occupancy, pos, shift, ts, origin)
        pos = torch.where(target_ok[:, None], slid, pos)
    return pos


def step_filter(occupancy, start, end, n_steps: int, allow_sliding: bool, origin=None) -> torch.Tensor:
    """Collision-filtered move with optional axis sliding (the host's
    GridWorldSim.step_filter for a fixed move length). `n_steps` must equal
    the host's max(2, int(length / (0.25 * _RES))) so that the sample
    fractions coincide. start, end [B, 3] -> [B, 3]."""
    delta = end - start
    ts = _linspace(0.0, 1.0, n_steps + 1, start.device)[1:]
    pos, reached = _advance(occupancy, start, delta, ts, origin)
    if allow_sliding:
        pos = _slide(occupancy, pos, end, ts, origin)
    # sliding runs only after a blocked walk; a full walk returns `end` exactly
    return torch.where(reached[:, None], end, pos)


def step_discrete(occupancy, pos, heading, action, forward_step: float, turn_angle: float, allow_sliding: bool,
                  origin=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One discrete step (STOP / FORWARD / LEFT / RIGHT) of every env, as
    GridWorldSim.step moves the agent. pos [B, 3], heading [B], action [B]
    integer -> (pos, heading)."""
    fwd = torch.stack([-torch.sin(heading), torch.zeros_like(heading), -torch.cos(heading)], dim=-1)
    n_steps = max(2, int(forward_step / (0.25 * _RES)))
    moved = step_filter(occupancy, pos, pos + fwd * forward_step, n_steps, allow_sliding, origin)
    new_pos = torch.where((action == 1)[:, None], moved, pos)
    new_heading = torch.where(
        action == 2, torch.remainder(heading + turn_angle, _TWO_PI),
        torch.where(action == 3, torch.remainder(heading - turn_angle, _TWO_PI), heading),
    )
    return new_pos, new_heading


def step_tilt(tilt: torch.Tensor, action: torch.Tensor, tilt_angle: float) -> torch.Tensor:
    """LOOK_UP / LOOK_DOWN camera pitch, clamped to +-60 degrees (the RxR
    action space's extra axis; the pose is unaffected)."""
    third_pi = math.pi / 3
    return torch.where(
        action == 4, torch.clamp(tilt + tilt_angle, max=third_pi),
        torch.where(action == 5, torch.clamp(tilt - tilt_angle, min=-third_pi), tilt),
    )


def step_batch(scenes: SceneBatch, pos, heading, actions, forward_step: float, turn_angle: float,
               allow_sliding: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    return step_discrete(scenes.occupancy, pos, heading, actions, forward_step, turn_angle, allow_sliding, scenes.origin_xz)


def expert_action(occupancy, field, goal_xz, pos, heading, goal_radius: float, turn_angle: float,
                  max_descent: int = 8, origin=None) -> torch.Tensor:
    """The oracle action of every env: ShortestPathFollower.get_next_action
    with the sensor's None -> STOP (tasks/shortest_path_follower.py,
    tasks/sensors.py).

    `field` [B, N, N] is the distance field of each episode's FIRST goal (the
    sensor passes episode.goals[0].position), goal_xz [B, 2] that goal. The
    host follower scans a greedy descent over the field
    (get_straight_shortest_path_points); here the descent runs `max_descent`
    steps unrolled and keeps the first cell center farther than 0.5 x 0.25 m
    from the agent, else the goal: the same target. Assumes the agent stands
    on a free cell (the dynamics keep it there). Returns int32 [B]: 0 STOP,
    1 FORWARD, 2 LEFT, 3 RIGHT."""
    n = field.shape[1]
    ox, oz = _origin(origin, pos)
    px, pz = pos[:, 0], pos[:, 2]
    ci, cj = _cell_index(px, pz, n, origin)
    d_goal = _lookup(field, ci, cj)
    stop = (d_goal <= goal_radius) | ~torch.isfinite(d_goal)

    # the 8-neighbourhood and the cell itself in the host's row-major (di, dj)
    # sweep; argmin takes the first minimum, the host's first-strict-minimum rule
    nine = torch.arange(9, dtype=torch.int32, device=pos.device)
    dis, djs = nine // 3 - 1, nine % 3 - 1
    i, j = ci, cj
    descending = ~stop
    found = torch.zeros_like(stop)
    tx = torch.zeros_like(px)
    tz = torch.zeros_like(pz)
    for _ in range(max_descent):
        fij = _lookup(field, i, j)
        cont = descending & (fij > _RES)
        ni, nj = i[:, None] + dis, j[:, None] + djs  # [B, 9]
        inb = (ni >= 0) & (ni < n) & (nj >= 0) & (nj < n)
        nic, njc = ni.clamp(0, n - 1), nj.clamp(0, n - 1)
        nav = ~_lookup(occupancy, nic, njc)
        vals = torch.where(inb & nav, _lookup(field, nic, njc), torch.full_like(fij[:, None], math.inf))
        k = torch.argmin(vals, dim=1, keepdim=True)
        step_ok = cont & (vals.gather(1, k)[:, 0] < fij)
        i = torch.where(step_ok, ni.gather(1, k)[:, 0], i)
        j = torch.where(step_ok, nj.gather(1, k)[:, 0], j)
        cx = ox + (i.to(torch.float32) + 0.5) * _RES
        cz = oz + (j.to(torch.float32) + 0.5) * _RES
        far = torch.hypot(cx - px, cz - pz) > 0.5 * 0.25
        newly = step_ok & far & ~found
        tx = torch.where(newly, cx, tx)
        tz = torch.where(newly, cz, tz)
        found = found | newly
        descending = step_ok & ~found
    tx = torch.where(found, tx, goal_xz[:, 0])
    tz = torch.where(found, tz, goal_xz[:, 1])

    # steering (shortest_path_follower.py)
    desired = torch.remainder(torch.atan2(-(tx - px), -(tz - pz)), _TWO_PI)
    delta = torch.remainder(desired - heading + math.pi, _TWO_PI) - math.pi
    thr = turn_angle / 2.0 + 1e-6
    steer = torch.where(delta.abs() <= thr, 1, torch.where(delta > 0, 2, 3)).to(torch.int32)
    return torch.where(stop, torch.zeros_like(steer), steer)


def geodesic_at(goal_field: torch.Tensor, pos: torch.Tensor, origin=None) -> torch.Tensor:
    """goal_field [B, N, N]; pos [B, 3] -> meters [B] (the field is built on
    snapped goals)."""
    ci, cj = _cell_index(pos[:, 0], pos[:, 2], goal_field.shape[1], origin)
    return _lookup(goal_field, ci, cj)


def progress_batch(scenes: SceneBatch, pos: torch.Tensor) -> torch.Tensor:
    """VLNOracleProgressSensor of every env: (d0 - d_t) / d0, 0 where the
    goal is unreachable. Returns [B, 1] f32."""
    d_t = geodesic_at(scenes.goal_field, pos, scenes.origin_xz)
    prog = (scenes.d0 - d_t) / scenes.d0
    return torch.where(torch.isfinite(d_t), prog, torch.zeros_like(prog))[:, None]


_NEAREST_FREE_CACHE: Dict[str, np.ndarray] = {}


def _offsets_by_distance(n: int) -> np.ndarray:
    """Every offset (di, dj) of an [n, n] grid, [(2n - 1)^2, 2] int64, in
    order of squared length, then di, then dj."""
    d = np.arange(-(n - 1), n)
    di, dj = (a.reshape(-1) for a in np.meshgrid(d, d, indexing="ij"))
    order = np.lexsort((dj, di, di * di + dj * dj))
    return np.stack([di[order], dj[order]], axis=1)


def nearest_free_cells(occ: np.ndarray) -> np.ndarray:
    """[N, N, 2] int32: for every cell, the nearest free cell, with the host's
    tie-break (the first minimum in the row-major free list,
    GridWorldScene.nearest_navigable_cell). The offsets are tried in order
    of squared length, and at equal length in row-major order of the cell
    they reach, which is (di, dj) order: the first free cell an offset
    reaches is the host's. Each offset is tried on the cells still without
    one, until none is left."""
    n = occ.shape[0]
    if occ.all():
        raise ValueError("nearest_free_cells: the grid has no free cell")
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    out = np.stack([ii, jj], axis=-1).astype(np.int32)  # a free cell is its own nearest
    todo_i, todo_j = np.nonzero(occ)
    for di, dj in _offsets_by_distance(n):
        if not len(todo_i):
            break
        ti, tj = todo_i + di, todo_j + dj
        ok = (ti >= 0) & (ti < n) & (tj >= 0) & (tj < n)
        ok[ok] = ~occ[ti[ok], tj[ok]]
        out[todo_i[ok], todo_j[ok]] = np.stack([ti[ok], tj[ok]], axis=1)
        todo_i, todo_j = todo_i[~ok], todo_j[~ok]
    return out


def nearest_free_cell_map(scene_id: str) -> np.ndarray:
    """nearest_free_cells of a scene, computed once per scene id."""
    if scene_id not in _NEAREST_FREE_CACHE:
        _NEAREST_FREE_CACHE[scene_id] = nearest_free_cells(get_scene(scene_id).occupancy)
    return _NEAREST_FREE_CACHE[scene_id]


def snap_point(occupancy, nearest_map, pos, origin=None) -> torch.Tensor:
    """GridWorldSim.snap_point of every env: pos where it is free, else the
    nearest free cell's center at y = 0. nearest_map [B, N, N, 2] int32."""
    ox, oz = _origin(origin, pos)
    ci, cj = _cell_index(pos[:, 0], pos[:, 2], occupancy.shape[1], origin)
    nearest = _lookup(nearest_map, ci, cj).to(torch.float32)  # [B, 2]
    snapped = torch.stack(
        [ox + (nearest[:, 0] + 0.5) * _RES, torch.zeros_like(ox), oz + (nearest[:, 1] + 0.5) * _RES], dim=-1
    )
    return torch.where(is_navigable(occupancy, pos, origin)[:, None], pos, snapped)


def step_filter_dynamic(occupancy, start, end, max_samples: int, allow_sliding: bool, origin=None) -> torch.Tensor:
    """step_filter for a move length that varies per env.

    The host walks n = max(2, int(length / (0.25 * _RES))) samples at
    fractions i / n. Here the sample count is static (max_samples >= any n)
    and the fractions are the host's, min(i / n, 1): samples past n repeat
    the endpoint, which leaves the leading-free-prefix walk unchanged."""
    delta = end - start
    length = torch.linalg.vector_norm(delta[:, 0::2], dim=-1)
    n = torch.clamp((length / (0.25 * _RES)).to(torch.int32), min=2)
    i = torch.arange(1, max_samples + 1, dtype=torch.float32, device=start.device)
    ts = torch.clamp(i[None, :] / n[:, None].to(torch.float32), max=1.0)  # [B, K]
    pos, reached = _advance(occupancy, start, delta, ts, origin)
    if allow_sliding:
        pos = _slide(occupancy, pos, end, ts, origin)
    pos = torch.where(reached[:, None], end, pos)
    return torch.where((length < 1e-9)[:, None], end, pos)  # the host returns `end` outright


def waypoint_step(occupancy, nearest_map, pos, heading, r, theta, rotate_agent: bool, max_samples: int,
                  allow_sliding: bool, origin=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """GO_TOWARD_POINT of every env (tasks/actions.py): polar target ->
    collision-filtered straight move -> free check -> snap -> check again;
    optionally turn the agent toward the target."""
    ang = heading + theta
    target = pos + r[:, None] * torch.stack([-torch.sin(ang), torch.zeros_like(ang), -torch.cos(ang)], dim=-1)
    moved = step_filter_dynamic(occupancy, pos, target, max_samples, allow_sliding, origin)
    nav = is_navigable(occupancy, moved, origin)
    snapped = snap_point(occupancy, nearest_map, moved, origin)
    snapped_ok = is_navigable(occupancy, snapped, origin)
    new_pos = torch.where((nav & snapped_ok)[:, None], snapped, pos)
    if rotate_agent:
        # compute_heading_to's (atan2(dx, dz) + pi) % 2pi (tasks/geometry.py)
        new_heading = torch.remainder(torch.atan2(target[:, 0] - pos[:, 0], target[:, 2] - pos[:, 2]) + math.pi, _TWO_PI)
        return new_pos, new_heading
    return new_pos, heading


def waypoint_reward(goal_field, prev_distance, prev_pos_xz, pos_after, r_pred, stop, *, slack_reward: float,
                    use_distance_scaled_slack_reward: bool, scale_slack_on_prediction: bool, success_reward: float,
                    distance_scalar: float, success_distance: float, origin=None):
    """WaypointRewardMeasure of every env (tasks/measures.py). Returns
    (reward, new distance_to_goal, success), each [B]."""
    d = geodesic_at(goal_field, pos_after, origin)
    moved = torch.linalg.vector_norm(prev_pos_xz - pos_after[:, 0::2], dim=-1)
    if use_distance_scaled_slack_reward:
        slack_distance = torch.where(stop, moved, r_pred) if scale_slack_on_prediction else moved
        slack = torch.clamp(slack_reward * slack_distance / 0.25, max=slack_reward)
    else:
        slack = torch.full_like(d, slack_reward)
    delta = prev_distance - d
    delta = torch.where(torch.isfinite(delta), delta, torch.full_like(delta, -1.0))
    success = (stop & (d < success_distance)).to(torch.float32)
    reward = slack + distance_scalar * delta + success_reward * success
    return reward, d, success


# ---------------------------------------------------------------------------
# rendering (batched over envs; one raycast per group of same-spec cameras)
# ---------------------------------------------------------------------------


def _raycast(occupancy, pos, ray_angles, max_t: float, origin=None):
    """Fixed-sample march over the occupancy grid: every sample distance at
    once, then the first blocked one (the host marches the same 0.6 x _RES
    steps one at a time). ray_angles [B, R] -> (t, hit, hit_ci, hit_cj), each
    [B, R]."""
    step = 0.6 * _RES
    K = int(max_t / step)
    dists = torch.arange(1, K + 1, dtype=torch.float32, device=pos.device) * step  # [K]
    valid = dists < max_t
    dx = -torch.sin(ray_angles)[:, :, None]  # [B, R, 1]
    dz = -torch.cos(ray_angles)[:, :, None]
    px = pos[:, 0, None, None] + dx * dists
    pz = pos[:, 2, None, None] + dz * dists
    ci, cj = _cell_index(px, pz, occupancy.shape[1], origin)
    blocked = _lookup(occupancy, ci, cj) & valid
    hit = blocked.any(dim=2)
    first = torch.argmax(blocked.to(torch.uint8), dim=2, keepdim=True)  # the first blocked sample
    t = torch.where(hit, dists[first[..., 0]], torch.full_like(first[..., 0], max_t, dtype=torch.float32))
    return t, hit, ci.gather(2, first)[..., 0], cj.gather(2, first)[..., 0]


def _rdiv(c: float, x: torch.Tensor) -> torch.Tensor:
    """c / x as a true division (a Python number over a tensor is a
    reciprocal and a product in torch)."""
    return torch.div(_full(c, x.device), x)


def render_camera_group(occupancy, wall_colors, floor_color, ceil_color, pos, heading,
                        orientations: Tuple[float, ...], spec: CameraSpec, tilt=None, origin=None) -> torch.Tensor:
    """K cameras of one spec (a pano rig) in one raycast, for every env: the
    host's _render_cameras / _shade in f32. tilt None is a level camera
    (R2R's action space); else [B] radians. Returns [B, K, H, W, C]: u8 RGB
    or f32 depth."""
    h, w = spec.height, spec.width
    dev = pos.device
    B = pos.shape[0]
    world_size = occupancy.shape[1] * _RES
    K = len(orientations)
    half_fov = math.radians(spec.hfov_deg) / 2.0
    xs = torch.tan(_linspace(-half_fov, half_fov, w, dev))  # [W]
    col_angles = -torch.atan(xs)
    orient = torch.stack([_full(o, dev) for o in orientations])
    headings = torch.remainder(heading[:, None] + orient, _TWO_PI)
    ray_angles = (headings[:, :, None] + col_angles).reshape(B, K * w)

    max_t = float(spec.max_depth) if spec.kind == "depth" else 1.5 * world_size
    t, hit, hit_ci, hit_cj = _raycast(occupancy, pos, ray_angles, max_t, origin)
    t = t.reshape(B, K, w)
    hit = hit.reshape(B, K, w)

    perp = t * torch.cos(torch.atan(xs))  # [B, K, W]
    focal = (w / 2.0) / math.tan(half_fov)
    if tilt is None:
        horizon = horizon_kw = h / 2.0
    else:  # LOOK_UP / DOWN shift the horizon row
        hz = h / 2.0 + torch.tan(tilt.to(torch.float32)) * focal  # [B]
        horizon, horizon_kw = hz.reshape(B, 1, 1, 1), hz.reshape(B, 1, 1)
    safe_perp = torch.clamp(perp, min=1e-6)
    top = horizon_kw - _rdiv(focal * (_WALL_HEIGHT - _EYE), safe_perp)  # [B, K, W]
    bot = horizon_kw + _rdiv(focal * _EYE, safe_perp)
    rows = torch.arange(h, dtype=torch.float32, device=dev)[None, None, :, None]  # [1, 1, H, 1]
    wall_mask = (rows >= top[:, :, None, :]) & (rows <= bot[:, :, None, :]) & hit[:, :, None, :]  # [B, K, H, W]

    if spec.kind == "depth":
        below = rows > horizon
        denom = (rows - horizon).abs() + 1e-6
        plane_h = torch.where(below, _EYE, _WALL_HEIGHT - _EYE)
        plane_depth = focal * plane_h / denom
        depth = torch.where(wall_mask, perp[:, :, None, :], torch.clamp(plane_depth, max=spec.max_depth))
        depth = torch.clamp(depth, spec.min_depth, spec.max_depth)
        if spec.normalize_depth:
            depth = (depth - spec.min_depth) / (spec.max_depth - spec.min_depth)
        return depth.to(torch.float32)[..., None]  # [B, K, H, W, 1]

    colors = _lookup(wall_colors, hit_ci, hit_cj).to(torch.float32).reshape(B, K, w, 3)
    shade = torch.clamp(1.0 - perp / world_size, 0.25, 1.0)
    wall_rgb = (colors * shade[..., None]).to(torch.uint8)  # [B, K, W, 3]
    below = (rows > horizon)[..., None]  # [1 or B, 1, H, 1, 1]
    sky = torch.where(below, floor_color[:, None, None, None, :], ceil_color[:, None, None, None, :])  # [B, 1, H, 1, 3]
    return torch.where(wall_mask[..., None], wall_rgb[:, :, None, :, :], sky)


def render_camera(occupancy, wall_colors, floor_color, ceil_color, pos, heading, spec: CameraSpec, tilt=None,
                  origin=None) -> torch.Tensor:
    """One camera's frames for every env: [B, H, W, C]."""
    return render_camera_group(occupancy, wall_colors, floor_color, ceil_color, pos, heading,
                               (spec.orientation_y,), spec, tilt=tilt, origin=origin)[:, 0]


def render_arrays(occupancy, wall_colors, floor_color, ceil_color, pos, heading, specs: Sequence[CameraSpec],
                  tilt=None, origin=None) -> Dict[str, torch.Tensor]:
    """Every camera for every env: {uuid: [B, H, W, C]}. Cameras of one spec
    share one raycast (the host's camera grouping)."""
    groups: Dict[Tuple, List[CameraSpec]] = {}
    for spec in specs:
        groups.setdefault(spec._replace(uuid="", orientation_y=0.0), []).append(spec)
    obs = {}
    for members in groups.values():
        frames = render_camera_group(occupancy, wall_colors, floor_color, ceil_color, pos, heading,
                                     tuple(m.orientation_y for m in members), members[0], tilt=tilt, origin=origin)
        for k, m in enumerate(members):
            obs[m.uuid] = frames[:, k]
    return obs


def render_batch(scenes: SceneBatch, pos, heading, specs: Sequence[CameraSpec], tilt=None) -> Dict[str, torch.Tensor]:
    return render_arrays(scenes.occupancy, scenes.wall_colors, scenes.floor_color, scenes.ceil_color, pos, heading,
                         specs, tilt=tilt, origin=scenes.origin_xz)
