"""Procedural continuous grid-world simulator.

A deterministic, host-side stand-in for Habitat-Sim with the full Simulator
protocol: navigability, geodesic distances (Dijkstra over an occupancy
grid), collision-filtered movement with optional wall sliding, and cheap
vectorized 2.5D raycast rendering of RGB/depth frames. Scenes are generated
from a hash of the scene_id, so episodes are reproducible across processes
without any assets on disk.

Geometry conventions match Habitat (y-up, forward -z); see
vlnce_torch/tasks/geometry.py.
"""

from __future__ import annotations

import hashlib
import heapq
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from vlnce_torch.registry import registry
from vlnce_torch.utils.profiling import annotate
from vlnce_torch.envs.sim import AgentState, Observations, Simulator, SimulatorActions
from vlnce_torch.tasks.geometry import (
    heading_from_quaternion,
    quat_from_heading,
)

_WORLD_SIZE = 16.0  # meters, square
_RES = 0.25  # occupancy cell size, meters
_N = int(_WORLD_SIZE / _RES)  # 64 cells per side
_EYE_HEIGHT_FRAC = 0.5  # camera height as fraction of wall height for render


def _scene_seed(scene_id: str) -> int:
    return int(hashlib.md5(scene_id.encode()).hexdigest()[:8], 16)


def _generate_occupancy(scene_id: str) -> np.ndarray:
    """True = blocked. Keeps the 2m lattice (x,z in {1,3,..,15} neighborhoods
    and straight corridors between lattice points) free so synthetic episodes
    are always connected."""
    rng = np.random.RandomState(_scene_seed(scene_id))
    occ = np.zeros((_N, _N), dtype=bool)
    occ[0, :] = occ[-1, :] = occ[:, 0] = occ[:, -1] = True  # boundary walls
    n_obstacles = rng.randint(6, 14)
    for _ in range(n_obstacles):
        cx, cz = rng.randint(2, _N - 4, size=2)
        w, h = rng.randint(1, 5, size=2)
        occ[cx : cx + w, cz : cz + h] = True
    # carve corridors along every 2m lattice line (width ~0.75m)
    for k in range(1, int(_WORLD_SIZE), 2):
        c = int(k / _RES)
        occ[c - 1 : c + 2, 1:-1] = False
        occ[1:-1, c - 1 : c + 2] = False
    return occ


class BaseScene:
    """Scene protocol shared by procedural GridWorld scenes and imported
    real-scene geometry (envs/scene_import.py): an occupancy grid at _RES
    meters per cell anchored at `origin` (world x, z of cell [0, 0]'s
    corner), colors for the raycast renderer, and a goal-keyed Dijkstra
    distance-field cache. All positions are WORLD coordinates — imported
    MP3D scenes keep their native frame (origin != 0), procedural scenes
    sit at origin (0, 0)."""

    scene_id: str
    occupancy: np.ndarray  # [N, N] bool, True = blocked
    wall_colors: np.ndarray  # [N, N, 3] uint8
    floor_color: np.ndarray  # [3] uint8
    ceil_color: np.ndarray  # [3] uint8
    origin: Tuple[float, float] = (0.0, 0.0)

    @property
    def n(self) -> int:
        return int(self.occupancy.shape[0])

    @property
    def world_size(self) -> float:
        return self.n * _RES

    # -- grid <-> world -----------------------------------------------------
    def world_to_cell(self, x: float, z: float) -> Tuple[int, int]:
        n = self.n
        ox, oz = self.origin
        return (
            int(np.clip((x - ox) / _RES, 0, n - 1)),
            int(np.clip((z - oz) / _RES, 0, n - 1)),
        )

    def cell_to_world(self, i: int, j: int) -> Tuple[float, float]:
        ox, oz = self.origin
        return (ox + (i + 0.5) * _RES, oz + (j + 0.5) * _RES)

    def navigable_cell(self, i: int, j: int) -> bool:
        n = self.n
        return 0 <= i < n and 0 <= j < n and not self.occupancy[i, j]

    # -- geodesic distance field (Dijkstra, 8-connected) --------------------
    def distance_field(self, goal_cell: Tuple[int, int]) -> np.ndarray:
        if goal_cell in self._distance_fields:
            return self._distance_fields[goal_cell]
        with annotate("scan.goal_field"):  # a miss: one Dijkstra field on the host
            dist = self._dijkstra(goal_cell)
        self._distance_fields[goal_cell] = dist
        return dist

    def _dijkstra(self, goal_cell: Tuple[int, int]) -> np.ndarray:
        _N = self.n
        dist = np.full((_N, _N), np.inf)
        gi, gj = self.snap_goal_cell(*goal_cell)
        dist[gi, gj] = 0.0
        pq: List[Tuple[float, int, int]] = [(0.0, gi, gj)]
        diag = math.sqrt(2.0) * _RES
        while pq:
            d, i, j = heapq.heappop(pq)
            if d > dist[i, j]:
                continue
            for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1), (1, 1), (1, -1), (-1, 1), (-1, -1)):
                ni, nj = i + di, j + dj
                if not self.navigable_cell(ni, nj):
                    continue
                if di and dj and (self.occupancy[i, nj] or self.occupancy[ni, j]):
                    continue  # no diagonal corner cutting
                nd = d + (diag if di and dj else _RES)
                if nd < dist[ni, nj]:
                    dist[ni, nj] = nd
                    heapq.heappush(pq, (nd, ni, nj))
        return dist

    def snap_goal_cell(self, i: int, j: int) -> Tuple[int, int]:
        """Where a goal's distance field starts: the goal's cell where it is
        navigable, else the nearest navigable cell."""
        if self.navigable_cell(i, j):
            return i, j
        return self.nearest_navigable_cell(i, j)

    def nearest_navigable_cell(self, i: int, j: int) -> Tuple[int, int]:
        free = np.argwhere(~self.occupancy)
        d2 = (free[:, 0] - i) ** 2 + (free[:, 1] - j) ** 2
        k = int(np.argmin(d2))
        return int(free[k, 0]), int(free[k, 1])


class GridWorldScene(BaseScene):
    """Procedural scene: occupancy + colors generated from a hash of the
    scene_id (origin fixed at (0, 0), 64x64 cells)."""

    def __init__(self, scene_id: str):
        self.scene_id = scene_id
        self.occupancy = _generate_occupancy(scene_id)
        self.origin = (0.0, 0.0)
        rng = np.random.RandomState(_scene_seed(scene_id) ^ 0x5EED)
        # per-cell wall colors for RGB rendering
        self.wall_colors = rng.randint(40, 220, size=(_N, _N, 3)).astype(np.uint8)
        self.floor_color = rng.randint(30, 90, size=(3,)).astype(np.uint8)
        self.ceil_color = rng.randint(120, 200, size=(3,)).astype(np.uint8)
        self._distance_fields: Dict[Tuple[int, int], np.ndarray] = {}


_SCENE_CACHE: Dict[str, BaseScene] = {}
# imported real-scene geometry (envs/scene_import.py registers here); never
# evicted — imports are explicit and bounded, unlike the procedural cache
_REGISTERED_SCENES: Dict[str, BaseScene] = {}
# providers consulted before procedural generation: scene_id -> Optional[Scene]
_SCENE_PROVIDERS: List = []


def register_scene(scene: BaseScene) -> None:
    """Serve `scene` for its scene_id from get_scene (all host + device
    paths resolve scenes through get_scene, so one registration puts
    imported geometry on every pipeline)."""
    _REGISTERED_SCENES[scene.scene_id] = scene


def register_scene_provider(fn) -> None:
    """Add a lazy scene source (scene_id -> Optional[BaseScene]); used by
    scene_import.set_geometry_dir to serve exported real-scene geometry."""
    if fn not in _SCENE_PROVIDERS:
        _SCENE_PROVIDERS.append(fn)


def get_scene(scene_id: str) -> BaseScene:
    if scene_id in _REGISTERED_SCENES:
        return _REGISTERED_SCENES[scene_id]
    for provider in _SCENE_PROVIDERS:
        scene = provider(scene_id)
        if scene is not None:
            _REGISTERED_SCENES[scene_id] = scene
            return scene
    if scene_id not in _SCENE_CACHE:
        if len(_SCENE_CACHE) > 32:
            _SCENE_CACHE.clear()
        _SCENE_CACHE[scene_id] = GridWorldScene(scene_id)
    return _SCENE_CACHE[scene_id]


@registry.register_simulator(name="GridWorldSim-v0")
class GridWorldSim(Simulator):
    def __init__(self, config):
        self.config = config
        if getattr(config, "GEOMETRY_DIR", "") or getattr(config, "CONNECTIVITY_GRAPHS", ""):
            # install real-scene geometry sources in THIS process (forked
            # VectorEnv workers construct their own sim, so each worker
            # self-installs; envs/scene_import.py)
            from vlnce_torch.envs.scene_import import apply_scene_geometry

            apply_scene_geometry(config)
        self._scene: Optional[GridWorldScene] = None
        self._position = np.array([1.5, 0.0, 1.5])
        self._heading = 0.0
        self._tilt = 0.0
        self._rng = np.random.RandomState(getattr(config, "SEED", 100))
        self.previous_step_collided = False
        self._forward_step = float(config.FORWARD_STEP_SIZE)
        self._turn_angle = math.radians(float(config.TURN_ANGLE))
        self._tilt_angle = math.radians(float(getattr(config, "TILT_ANGLE", config.TURN_ANGLE)))
        self._allow_sliding = bool(config.HABITAT_SIM_V0.ALLOW_SLIDING)
        # camera configs: uuid -> (H, W, hfov_deg, orientation_y, kind)
        self._cameras: List[Tuple[str, int, int, float, float, str]] = []
        for name in config.AGENT_0.SENSORS:
            cam = getattr(config, name, None)
            if cam is None:
                continue
            kind = "depth" if "DEPTH" in name else "rgb"
            orientation_y = float(cam.ORIENTATION[1]) if "ORIENTATION" in cam else 0.0
            self._cameras.append((cam.UUID, int(cam.HEIGHT), int(cam.WIDTH), float(cam.HFOV), orientation_y, kind))
        depth_cfg = getattr(config, "DEPTH_SENSOR", None)
        self._min_depth = float(depth_cfg.MIN_DEPTH) if depth_cfg else 0.0
        self._max_depth = float(depth_cfg.MAX_DEPTH) if depth_cfg else 10.0
        self._normalize_depth = bool(depth_cfg.NORMALIZE_DEPTH) if depth_cfg else True

    # ------------------------------------------------------------------ core
    def reconfigure(self, scene_id: str) -> None:
        self._scene = get_scene(scene_id)

    def reset(self) -> Observations:
        if self._scene is None:
            self.reconfigure("default")
        self.previous_step_collided = False
        self._tilt = 0.0  # camera pitch is per-episode state (LOOK_UP/DOWN)
        return self.get_observations_at()

    def seed(self, seed: int) -> None:
        self._rng = np.random.RandomState(seed)

    def step(self, action: int) -> Observations:
        self.previous_step_collided = False
        if action == SimulatorActions.MOVE_FORWARD:
            fwd = np.array([-math.sin(self._heading), 0.0, -math.cos(self._heading)])
            target = self._position + fwd * self._forward_step
            new_pos = self.step_filter(self._position, target)
            if np.linalg.norm(new_pos - target) > 1e-6:
                self.previous_step_collided = True
            self._position = new_pos
        elif action == SimulatorActions.TURN_LEFT:
            self._heading = (self._heading + self._turn_angle) % (2 * math.pi)
        elif action == SimulatorActions.TURN_RIGHT:
            self._heading = (self._heading - self._turn_angle) % (2 * math.pi)
        elif action == SimulatorActions.LOOK_UP:
            self._tilt = min(self._tilt + self._tilt_angle, math.pi / 3)
        elif action == SimulatorActions.LOOK_DOWN:
            self._tilt = max(self._tilt - self._tilt_angle, -math.pi / 3)
        # STOP: no state change
        return self.get_observations_at()

    # ----------------------------------------------------------------- state
    def get_agent_state(self) -> AgentState:
        return AgentState(self._position.copy(), quat_from_heading(self._heading))

    def set_agent_state(self, position: Sequence[float], rotation: Sequence[float]) -> None:
        self._position = np.asarray(position, dtype=np.float64).copy()
        self._heading = heading_from_quaternion(np.asarray(rotation, dtype=np.float64))

    # ------------------------------------------------------------ navigation
    def is_navigable(self, position: Sequence[float]) -> bool:
        p = np.asarray(position, dtype=np.float64)
        if not np.all(np.isfinite(p)):
            return False
        i, j = self._scene.world_to_cell(p[0], p[-1])
        return self._scene.navigable_cell(i, j)

    def snap_point(self, position: Sequence[float]) -> np.ndarray:
        p = np.asarray(position, dtype=np.float64)
        if self.is_navigable(p):
            return p.copy() if len(p) == 3 else np.array([p[0], 0.0, p[1]])
        i, j = self._scene.world_to_cell(p[0], p[-1])
        ni, nj = self._scene.nearest_navigable_cell(i, j)
        x, z = self._scene.cell_to_world(ni, nj)
        return np.array([x, 0.0, z])

    def sample_navigable_point(self) -> List[float]:
        free = np.argwhere(~self._scene.occupancy)
        i, j = free[self._rng.randint(len(free))]
        x, z = self._scene.cell_to_world(int(i), int(j))
        return [x, 0.0, z]

    def step_filter(self, start: Sequence[float], end: Sequence[float]) -> np.ndarray:
        """Move from start toward end, stopping at obstacles; optionally
        slide along the free axis (Habitat allow_sliding behavior)."""
        start = np.asarray(start, dtype=np.float64)
        end = np.asarray(end, dtype=np.float64)
        delta = end - start
        length = float(np.linalg.norm(delta[[0, 2]]))
        if length < 1e-9:
            return end.copy()
        n_steps = max(2, int(length / (0.25 * _RES)))
        pos = start.copy()
        ts = np.linspace(0.0, 1.0, n_steps + 1)[1:]
        blocked_t = None
        for t in ts:
            cand = start + delta * t
            if self.is_navigable(cand):
                pos = cand
            else:
                blocked_t = t
                break
        if blocked_t is not None and self._allow_sliding:
            remaining = end - pos
            for axis in (0, 2):
                slide = pos.copy()
                slide[axis] += remaining[axis]
                if self.is_navigable(slide):
                    # advance along this axis in small steps
                    sub = np.linspace(0.0, 1.0, n_steps + 1)[1:]
                    best = pos.copy()
                    for t in sub:
                        cand = pos.copy()
                        cand[axis] += remaining[axis] * t
                        if self.is_navigable(cand):
                            best = cand
                        else:
                            break
                    pos = best
        return pos

    def geodesic_distance(
        self,
        position_a: Sequence[float],
        position_b: Union[Sequence[float], Sequence[Sequence[float]]],
    ) -> float:
        a = np.asarray(position_a, dtype=np.float64)
        b = np.asarray(position_b, dtype=np.float64)
        goals = b[None, :] if b.ndim == 1 else b
        ai, aj = self._scene.world_to_cell(a[0], a[-1])
        if not self._scene.navigable_cell(ai, aj):
            ai, aj = self._scene.nearest_navigable_cell(ai, aj)
        best = np.inf
        for g in goals:
            gi, gj = self._scene.world_to_cell(g[0], g[-1])
            field = self._scene.distance_field((gi, gj))
            best = min(best, float(field[ai, aj]))
        return best

    def get_straight_shortest_path_points(
        self, position_a: Sequence[float], position_b: Sequence[float]
    ) -> List[List[float]]:
        """Greedy descent on the goal distance field; returns world waypoints
        from a to b."""
        a = np.asarray(position_a, dtype=np.float64)
        b = np.asarray(position_b, dtype=np.float64)
        gi, gj = self._scene.world_to_cell(b[0], b[-1])
        field = self._scene.distance_field((gi, gj))
        i, j = self._scene.world_to_cell(a[0], a[-1])
        if not self._scene.navigable_cell(i, j):
            i, j = self._scene.nearest_navigable_cell(i, j)
        if not np.isfinite(field[i, j]):
            return [list(map(float, a)), list(map(float, b))]
        path = [[float(a[0]), 0.0, float(a[-1])]]
        seen = set()
        while field[i, j] > _RES and (i, j) not in seen:
            seen.add((i, j))
            best, best_d = None, field[i, j]
            for di in (-1, 0, 1):
                for dj in (-1, 0, 1):
                    ni, nj = i + di, j + dj
                    if self._scene.navigable_cell(ni, nj) and field[ni, nj] < best_d:
                        best, best_d = (ni, nj), field[ni, nj]
            if best is None:
                break
            i, j = best
            x, z = self._scene.cell_to_world(i, j)
            path.append([x, 0.0, z])
        path.append([float(b[0]), 0.0, float(b[-1])])
        return path

    # ------------------------------------------------------------- rendering
    def get_observations_at(
        self,
        position: Optional[Sequence[float]] = None,
        rotation: Optional[Sequence[float]] = None,
        keep_agent_at_new_pose: bool = False,
    ) -> Observations:
        old_pos, old_heading = self._position, self._heading
        if position is not None:
            pos = np.asarray(position, dtype=np.float64)
            if len(pos) == 2:
                pos = np.array([pos[0], 0.0, pos[1]])
            self._position = pos
        if rotation is not None:
            self._heading = heading_from_quaternion(np.asarray(rotation, dtype=np.float64))
        obs: Observations = {}
        # batch the raycast across ALL cameras of the same spec (a 12-pano
        # rig casts one 12*W-wide DDA instead of 12 separate loops)
        groups: Dict[Tuple[int, int, float, str], List[Tuple[str, float]]] = {}
        for uuid, h, w, hfov, orient_y, kind in self._cameras:
            groups.setdefault((h, w, hfov, kind), []).append((uuid, orient_y))
        for (h, w, hfov, kind), members in groups.items():
            frames = self._render_cameras(h, w, hfov, [oy for _, oy in members], kind)
            for (uuid, _), frame in zip(members, frames):
                obs[uuid] = frame
        if not keep_agent_at_new_pose and (position is not None or rotation is not None):
            self._position, self._heading = old_pos, old_heading
        return obs

    def _raycast(self, ray_angles: np.ndarray, max_t: float):
        """One DDA over the occupancy grid for a flat batch of ray angles."""
        n = len(ray_angles)
        dx = -np.sin(ray_angles)
        dz = -np.cos(ray_angles)
        ox, oz = self._position[0], self._position[2]
        occ = self._scene.occupancy
        grid_n = self._scene.n
        org_x, org_z = self._scene.origin
        t = np.zeros(n)
        hit = np.zeros(n, dtype=bool)
        hit_cell = np.zeros((n, 2), dtype=np.int32)
        step = 0.6 * _RES
        cur = np.full(n, step)
        for _ in range(int(max_t / step)):
            live = ~hit & (cur < max_t)
            if not live.any():
                break
            px = ox + dx * cur
            pz = oz + dz * cur
            ci = np.clip(((px - org_x) / _RES).astype(np.int32), 0, grid_n - 1)
            cj = np.clip(((pz - org_z) / _RES).astype(np.int32), 0, grid_n - 1)
            blocked = occ[ci, cj] & live
            newly = blocked & ~hit
            hit |= newly
            t[newly] = cur[newly]
            hit_cell[newly, 0] = ci[newly]
            hit_cell[newly, 1] = cj[newly]
            cur = np.where(live & ~hit, cur + step, cur)
        t[~hit] = max_t
        return t, hit, hit_cell

    def _render_cameras(self, h: int, w: int, hfov_deg: float, orientations: List[float], kind: str) -> List[np.ndarray]:
        """Vectorized 2.5D raycast for a batch of same-spec cameras."""
        half_fov = math.radians(hfov_deg) / 2.0
        xs = np.tan(np.linspace(-half_fov, half_fov, w))
        col_angles = -np.arctan(xs)  # leftmost column = leftmost ray
        K = len(orientations)
        headings = np.array([(self._heading + oy) % (2 * math.pi) for oy in orientations])
        ray_angles = (headings[:, None] + col_angles[None, :]).reshape(-1)  # [K*w]

        max_t = float(self._max_depth) if kind == "depth" else 1.5 * self._scene.world_size
        t_all, hit_all, cell_all = self._raycast(ray_angles, max_t)
        frames = []
        for k in range(K):
            sl = slice(k * w, (k + 1) * w)
            frames.append(
                self._shade(h, w, half_fov, xs, t_all[sl], hit_all[sl], cell_all[sl], kind, max_t)
            )
        return frames

    def _shade(self, h, w, half_fov, xs, t, hit, hit_cell, kind, max_t) -> np.ndarray:
        # perpendicular distance to avoid fisheye
        perp = t * np.cos(np.arctan(xs))

        wall_height = 2.0
        eye = _EYE_HEIGHT_FRAC * wall_height
        # projected wall top/bottom rows per column (tilt shifts the horizon)
        focal = (w / 2.0) / math.tan(half_fov)
        horizon = h / 2.0 + math.tan(self._tilt) * focal
        with np.errstate(divide="ignore"):
            top = horizon - focal * (wall_height - eye) / np.maximum(perp, 1e-6)
            bot = horizon + focal * eye / np.maximum(perp, 1e-6)
        rows = np.arange(h)[:, None]
        wall_mask = (rows >= top[None, :]) & (rows <= bot[None, :]) & hit[None, :]
        if kind == "depth":
            # depth for floor/ceiling rows from ray-plane intersection
            below = rows > horizon
            denom = np.abs(rows - horizon) + 1e-6
            plane_h = np.where(below, eye, wall_height - eye)
            plane_depth = focal * plane_h / denom
            depth = np.where(wall_mask, perp[None, :], np.minimum(plane_depth, self._max_depth))
            depth = np.clip(depth, self._min_depth, self._max_depth)
            if self._normalize_depth:
                depth = (depth - self._min_depth) / (self._max_depth - self._min_depth)
            return depth.astype(np.float32)[..., None]
        colors = self._scene.wall_colors[hit_cell[:, 0], hit_cell[:, 1]]  # [w, 3]
        shade = np.clip(1.0 - perp / self._scene.world_size, 0.25, 1.0)
        wall_rgb = (colors.astype(np.float32) * shade[:, None]).astype(np.uint8)
        img = np.where(
            (rows > horizon)[..., None],
            self._scene.floor_color[None, None, :],
            self._scene.ceil_color[None, None, :],
        ).astype(np.uint8)
        img = np.where(wall_mask[..., None], wall_rgb[None, :, :], img)
        return img
