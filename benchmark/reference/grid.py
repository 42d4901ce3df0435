"""The plain reference of the grid world: procedural scenes, the raycast
renderer, the collision-filtered discrete dynamics and the RxR obs
transforms (shortest-edge resize, centre crops), batched over episodes.

A frozen copy of the plain rules the simulator documents (a 16 m square of
0.25 m cells, walls 2 m high, the eye at 1 m, rays sampled every 0.6 cell),
written in plain PyTorch and numpy. It imports nothing of the program:
scenes are generated again from their ids, so nothing the program derived
reaches it. Every tensor here is f32 (u8 for RGB), as the rules state.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

RES = 0.25  # metres per occupancy cell
WORLD = 16.0
N_CELLS = int(WORLD / RES)
WALL_HEIGHT = 2.0
EYE = 1.0
TWO_PI = 2.0 * math.pi


# ----------------------------------------------------------------- scenes
def _scene_seed(scene_id: str) -> int:
    return int(hashlib.md5(scene_id.encode()).hexdigest()[:8], 16)


def scene(scene_id: str) -> Dict[str, np.ndarray]:
    """Occupancy (True = blocked), per-cell wall colours and the floor and
    ceiling colours of a procedural scene, from its id: random boxes, then
    3-cell corridors carved along every odd metre, a wall all round."""
    rng = np.random.RandomState(_scene_seed(scene_id))
    occ = np.zeros((N_CELLS, N_CELLS), dtype=bool)
    occ[0, :] = occ[-1, :] = occ[:, 0] = occ[:, -1] = True
    for _ in range(rng.randint(6, 14)):
        cx, cz = rng.randint(2, N_CELLS - 4, size=2)
        w, h = rng.randint(1, 5, size=2)
        occ[cx : cx + w, cz : cz + h] = True
    for k in range(1, int(WORLD), 2):
        c = int(k / RES)
        occ[c - 1 : c + 2, 1:-1] = False
        occ[1:-1, c - 1 : c + 2] = False
    crng = np.random.RandomState(_scene_seed(scene_id) ^ 0x5EED)
    return {
        "occupancy": occ,
        "wall_colors": crng.randint(40, 220, size=(N_CELLS, N_CELLS, 3)).astype(np.uint8),
        "floor_color": crng.randint(30, 90, size=(3,)).astype(np.uint8),
        "ceil_color": crng.randint(120, 200, size=(3,)).astype(np.uint8),
    }


def scene_batch(scene_ids: Sequence[str], device) -> Dict[str, torch.Tensor]:
    """The scenes of a batch of episodes, stacked on a leading axis."""
    scenes = [scene(s) for s in scene_ids]
    return {k: torch.from_numpy(np.stack([s[k] for s in scenes])).to(device) for k in scenes[0]}


# ------------------------------------------------------------- primitives
def _lookup(grid: torch.Tensor, ci: torch.Tensor, cj: torch.Tensor) -> torch.Tensor:
    B, n, m = grid.shape[:3]
    idx = (ci.long() * m + cj.long()).reshape(B, -1)
    if grid.dim() == 3:
        return grid.reshape(B, n * m).gather(1, idx).reshape(ci.shape)
    c = grid.shape[3]
    return grid.reshape(B, n * m, c).gather(1, idx[:, :, None].expand(-1, -1, c)).reshape(tuple(ci.shape) + (c,))


def _linspace(start: float, stop: float, num: int, device) -> torch.Tensor:
    div = num - 1
    s = torch.arange(div, dtype=torch.float32, device=device) / div
    a = torch.full((), start, dtype=torch.float32, device=device)
    b = torch.full((), stop, dtype=torch.float32, device=device)
    return torch.cat([a * (1 - s) + b * s, b.reshape(1)])


def _cell(x: torch.Tensor, z: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """World x, z -> cell: truncation toward zero, clipped to the grid."""
    return (x / RES).to(torch.int32).clamp(0, n - 1), (z / RES).to(torch.int32).clamp(0, n - 1)


def _free(occ: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    ci, cj = _cell(pos[..., 0], pos[..., 2], occ.shape[1])
    return ~_lookup(occ, ci, cj)


def _walk(occ, start, delta, ts):
    """start -> start + delta at fractions ts, up to before the first
    blocked sample: (pos, whether every sample was free)."""
    cands = start[:, None, :] + delta[:, None, :] * ts[None, :, None]
    free = _free(occ, cands)
    k = torch.cumprod(free.to(torch.int32), dim=1).sum(dim=1)
    picked = cands.gather(1, (k - 1).clamp(min=0)[:, None, None].expand(-1, 1, 3))[:, 0]
    return torch.where((k > 0)[:, None], picked, start), k == cands.shape[1]


def step(occ: torch.Tensor, pos: torch.Tensor, heading: torch.Tensor, tilt: torch.Tensor, action: torch.Tensor,
         forward_step: float, turn: float, tilt_step: float, sliding: bool):
    """One discrete action of every episode: 0 STOP, 1 forward (a walk of
    max(2, step / (0.25 cell)) samples that stops before a wall, then an
    axis slide where allowed), 2 and 3 turns, 4 and 5 camera pitch clamped
    to +-60 degrees. Returns (pos, heading, tilt)."""
    fwd = torch.stack([-torch.sin(heading), torch.zeros_like(heading), -torch.cos(heading)], dim=-1)
    end = pos + fwd * forward_step
    n_steps = max(2, int(forward_step / (0.25 * RES)))
    ts = _linspace(0.0, 1.0, n_steps + 1, pos.device)[1:]
    moved, reached = _walk(occ, pos, end - pos, ts)
    if sliding:
        rem = end - moved
        for axis in (0, 2):
            shift = torch.zeros_like(moved)
            shift[:, axis] = rem[:, axis]
            ok = _free(occ, moved + shift)
            slid, _ = _walk(occ, moved, shift, ts)
            moved = torch.where(ok[:, None], slid, moved)
    moved = torch.where(reached[:, None], end, moved)
    new_pos = torch.where((action == 1)[:, None], moved, pos)
    new_heading = torch.where(action == 2, torch.remainder(heading + turn, TWO_PI),
                              torch.where(action == 3, torch.remainder(heading - turn, TWO_PI), heading))
    third = math.pi / 3
    new_tilt = torch.where(action == 4, torch.clamp(tilt + tilt_step, max=third),
                           torch.where(action == 5, torch.clamp(tilt - tilt_step, min=-third), tilt))
    return new_pos, new_heading, new_tilt


# --------------------------------------------------------------- renderer
def render(sc: Dict[str, torch.Tensor], pos: torch.Tensor, heading: torch.Tensor, tilt, cam: Dict) -> torch.Tensor:
    """One pinhole camera of every episode: a ray per column marched over
    the grid, walls shaded by distance, floor and ceiling flat; depth is
    the perpendicular distance, clipped and normalised. cam: height, width,
    hfov (degrees), kind ("rgb" or "depth"), min_depth, max_depth,
    normalize. tilt None is a level camera. Returns [B, H, W, 3] u8 or
    [B, H, W, 1] f32."""
    occ = sc["occupancy"]
    h, w = int(cam["height"]), int(cam["width"])
    dev, B = pos.device, pos.shape[0]
    world = occ.shape[1] * RES
    half = math.radians(float(cam["hfov"])) / 2.0
    xs = torch.tan(_linspace(-half, half, w, dev))
    angles = torch.remainder(heading[:, None], TWO_PI) - torch.atan(xs)[None, :]
    max_t = float(cam["max_depth"]) if cam["kind"] == "depth" else 1.5 * world
    stride = 0.6 * RES
    K = int(max_t / stride)
    dists = torch.arange(1, K + 1, dtype=torch.float32, device=dev) * stride
    dx, dz = -torch.sin(angles)[:, :, None], -torch.cos(angles)[:, :, None]
    ci, cj = _cell(pos[:, 0, None, None] + dx * dists, pos[:, 2, None, None] + dz * dists, occ.shape[1])
    blocked = _lookup(occ, ci, cj) & (dists < max_t)
    hit = blocked.any(dim=2)
    first = torch.argmax(blocked.to(torch.uint8), dim=2, keepdim=True)
    t = torch.where(hit, dists[first[..., 0]], torch.full_like(first[..., 0], max_t, dtype=torch.float32))
    hit_ci, hit_cj = ci.gather(2, first)[..., 0], cj.gather(2, first)[..., 0]

    perp = t * torch.cos(torch.atan(xs))
    focal = (w / 2.0) / math.tan(half)
    if tilt is None:
        horizon = horizon_c = h / 2.0
    else:
        hz = h / 2.0 + torch.tan(tilt.to(torch.float32)) * focal
        horizon, horizon_c = hz.reshape(B, 1, 1), hz.reshape(B, 1)
    safe = torch.clamp(perp, min=1e-6)
    top = horizon_c - torch.div(torch.full((), focal * (WALL_HEIGHT - EYE), device=dev), safe)
    bot = horizon_c + torch.div(torch.full((), focal * EYE, device=dev), safe)
    rows = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    wall = (rows >= top[:, None, :]) & (rows <= bot[:, None, :]) & hit[:, None, :]
    if cam["kind"] == "depth":
        lo, hi = float(cam["min_depth"]), float(cam["max_depth"])
        below = rows > horizon
        plane = focal * torch.where(below, EYE, WALL_HEIGHT - EYE) / ((rows - horizon).abs() + 1e-6)
        depth = torch.where(wall, perp[:, None, :], torch.clamp(plane, max=hi))
        depth = torch.clamp(depth, lo, hi)
        if cam["normalize"]:
            depth = (depth - lo) / (hi - lo)
        return depth.to(torch.float32)[..., None]
    colors = _lookup(sc["wall_colors"], hit_ci, hit_cj).to(torch.float32)
    shade = torch.clamp(1.0 - perp / world, 0.25, 1.0)
    wall_rgb = (colors * shade[..., None]).to(torch.uint8)
    below = (rows > horizon)[..., None]
    sky = torch.where(below, sc["floor_color"][:, None, None, :], sc["ceil_color"][:, None, None, :])
    return torch.where(wall[..., None], wall_rgb[:, None, :, :], sky)


# ------------------------------------------------------------- transforms
def resize_shortest_edge(x: torch.Tensor, size: int) -> torch.Tensor:
    """[B, H, W, C] -> the shortest edge at `size`, by half-pixel bilinear
    interpolation without antialiasing; u8 rounds half to even and clips."""
    h, w = x.shape[1], x.shape[2]
    scale = size / min(h, w)
    out_hw = (int(h * scale), int(w * scale))
    if out_hw == (h, w):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2).float(), size=out_hw, mode="bilinear", align_corners=False,
                      antialias=False).permute(0, 2, 3, 1)
    if x.dtype == torch.uint8:
        return torch.round(y).clamp(0, 255).to(torch.uint8)
    return y


def center_crop(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    H, W = x.shape[1], x.shape[2]
    top, left = max(0, (H - hw[0]) // 2), max(0, (W - hw[1]) // 2)
    return x[:, top : top + hw[0], left : left + hw[1], :]


def observe(sc, pos, heading, tilt, cams: List[Dict], resize: int, crops: Dict[str, Tuple[int, int]]):
    """The policy's visual inputs of every episode: each camera rendered,
    resized (0 for none) and cropped."""
    out = {}
    for cam in cams:
        x = render(sc, pos, heading, tilt, cam)
        if resize:
            x = resize_shortest_edge(x, resize)
        crop = crops.get(cam["uuid"])
        if crop is not None and tuple(x.shape[1:3]) != tuple(crop):
            out[cam["uuid"]] = center_crop(x, crop)
        else:
            out[cam["uuid"]] = x
    return out


def heading_from_quaternion(q) -> float:
    """Habitat's heading of a start rotation [x, y, z, w]: FRONT (0, 0, -1)
    rotated by the inverse rotation, atan2 over the XZ plane, in [0, 2 pi)."""
    q = np.asarray(q, np.float64)
    n = float(np.dot(q, q))
    inv = np.array([-q[0], -q[1], -q[2], q[3]]) / n
    v = np.array([0.0, 0.0, -1.0])
    uv = np.cross(inv[:3], v)
    d = v + 2.0 * (inv[3] * uv + np.cross(inv[:3], uv))
    return math.atan2(d[0], -d[2]) % (2 * math.pi)
