"""Real-scene geometry import: navmesh / connectivity-graph -> scene grids.

Port of vlnce_tpu/envs/scene_import.py: the same grids, bit for bit, the
same npz schema (`_GEOMETRY_VERSION`), so an export written by either
package is read by the other. `scene_from_graph` takes any graph object
with networkx's `.nodes[...]` and `.edges` interface; only unpickling the
reference's connectivity file needs networkx.

The reference steps real MP3D geometry through habitat_sim's navmesh
(reference habitat_extensions/actions.py:37-55 `step_filter`,
shortest_path_follower.py:115-172 greedy geodesic descent) and ships the
panorama connectivity graphs as data/connectivity_graphs.pkl — a pickled
{scene_name: networkx.Graph} with per-node `position` attributes (reference
habitat_extensions/measures.py:336-337, maps.py:277-343). The device-resident
pipelines here (envs/device_sim.py, trainers/device_dagger.py,
trainers/device_recollect.py, rl/device_rollout.py, trainers/scan_eval.py)
step an occupancy-grid twin of that surface on the card; this module builds those grids from real
scene data so the resident pipelines run real MP3D episodes:

  * `scene_from_graph` rasterizes a connectivity graph's walkable corridors
    (nodes + edges, dilated by the agent radius) into an occupancy grid in
    the scene's NATIVE world frame (nonzero `origin`);
  * `scene_from_navigability` samples any point-navigability oracle on the
    grid — `scene_from_habitat` adapts a habitat_sim pathfinder to it, the
    true navmesh -> SceneBatch exporter for asset day;
  * `save_scene_geometry` / `load_scene_geometry` persist grids as npz so
    export runs once per scene, and `set_geometry_dir` serves a directory of
    exports lazily through `gridworld.get_scene` — ONE registration point
    puts imported geometry on every host and device pipeline (the host
    GridWorldSim, build_scene_batch, the episode queues, the expert fields).

Geodesic distance fields and nearest-free maps are derived on demand by the
shared BaseScene machinery (envs/gridworld.py), identically for procedural
and imported scenes, so all parity proofs carry over.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

from vlnce_torch.envs.gridworld import (
    _RES,
    BaseScene,
    _scene_seed,
    register_scene,
    register_scene_provider,
)

# MP3D agent radius is 0.18 m; R2R-CE uses 0.25 m steps along ~1 m-wide
# corridors. Half-width 0.5 m keeps two cells of clearance at _RES=0.25 so
# collision-filtered moves between adjacent panorama nodes succeed.
DEFAULT_CORRIDOR_RADIUS = 0.5
# blocked margin (meters) kept around the walkable extent on every side
DEFAULT_MARGIN = 0.5
_GEOMETRY_VERSION = 1


def _scene_stem(scene_id: str) -> str:
    """'mp3d/17DRP5sb8fy/17DRP5sb8fy.glb' -> '17DRP5sb8fy' — the key the
    reference's connectivity pickle and episode jsons agree on."""
    return os.path.splitext(os.path.basename(scene_id))[0]


def _procedural_colors(scene_id: str, n: int):
    """Deterministic colors in the GridWorldScene recipe (gridworld.py:146-150)
    so imported geometry renders through the unchanged raycast shader. Real
    visual fidelity comes from the feature bank (data/feature_bank.py), not
    from these colors."""
    rng = np.random.RandomState(_scene_seed(scene_id) ^ 0x5EED)
    wall = rng.randint(40, 220, size=(n, n, 3)).astype(np.uint8)
    floor = rng.randint(30, 90, size=(3,)).astype(np.uint8)
    ceil = rng.randint(120, 200, size=(3,)).astype(np.uint8)
    return wall, floor, ceil


class ImportedScene(BaseScene):
    """Real-scene geometry in the shared scene protocol: occupancy at _RES
    anchored at the scene's native-frame `origin`, plus the Dijkstra field
    cache BaseScene provides."""

    def __init__(
        self,
        scene_id: str,
        occupancy: np.ndarray,
        origin: Tuple[float, float],
        wall_colors: Optional[np.ndarray] = None,
        floor_color: Optional[np.ndarray] = None,
        ceil_color: Optional[np.ndarray] = None,
    ):
        occupancy = np.asarray(occupancy, dtype=bool)
        if occupancy.ndim != 2 or occupancy.shape[0] != occupancy.shape[1]:
            raise ValueError(f"occupancy must be square [N, N], got {occupancy.shape}")
        self.scene_id = scene_id
        self.occupancy = occupancy
        self.origin = (float(origin[0]), float(origin[1]))
        n = occupancy.shape[0]
        if wall_colors is None or floor_color is None or ceil_color is None:
            wall, floor, ceil = _procedural_colors(scene_id, n)
            wall_colors = wall if wall_colors is None else wall_colors
            floor_color = floor if floor_color is None else floor_color
            ceil_color = ceil if ceil_color is None else ceil_color
        self.wall_colors = np.asarray(wall_colors, np.uint8)
        self.floor_color = np.asarray(floor_color, np.uint8)
        self.ceil_color = np.asarray(ceil_color, np.uint8)
        self._distance_fields = {}

    def with_scene_id(self, scene_id: str) -> "ImportedScene":
        """Alias under another id (episode scene_ids carry dataset-relative
        paths; geometry is keyed by scene stem). Grids are shared; the
        distance-field cache is shared too (same geometry -> same fields)."""
        alias = ImportedScene.__new__(ImportedScene)
        alias.__dict__.update(self.__dict__)
        alias.scene_id = scene_id
        return alias


# ---------------------------------------------------------------------------
# scene construction
# ---------------------------------------------------------------------------


def _grid_bounds(
    xs: np.ndarray, zs: np.ndarray, pad: float
) -> Tuple[Tuple[float, float], int]:
    """Origin (snapped to the _RES lattice) + grid side length covering
    [min - pad, max + pad] on both axes, rounded up to a multiple of 8 cells
    (as the JAX package rounds for its tile shapes; extra cells read as
    blocked)."""
    ox = np.floor((float(xs.min()) - pad) / _RES) * _RES
    oz = np.floor((float(zs.min()) - pad) / _RES) * _RES
    span = max(float(xs.max()) + pad - ox, float(zs.max()) + pad - oz)
    n = int(np.ceil(span / _RES))
    n = ((n + 7) // 8) * 8
    return (float(ox), float(oz)), n


def scene_from_graph(
    scene_id: str,
    graph,
    corridor_radius: float = DEFAULT_CORRIDOR_RADIUS,
    margin: float = DEFAULT_MARGIN,
) -> ImportedScene:
    """Rasterize a connectivity graph into walkable-corridor occupancy.

    Free space is every cell whose center lies within `corridor_radius` of a
    graph edge segment (or an isolated node) — the walkable tube an agent
    traverses between panorama nodes. Positions keep the scene's native
    world frame: `origin` is the grid anchor, NOT a recentering.
    """
    from vlnce_torch.utils.nav_graph import _node_position

    nodes = list(graph.nodes)
    if not nodes:
        raise ValueError(f"connectivity graph for {scene_id!r} has no nodes")
    npos = {nd: _node_position(graph, nd) for nd in nodes}
    xs = np.array([p[0] for p in npos.values()])
    zs = np.array([p[-1] for p in npos.values()])
    origin, n = _grid_bounds(xs, zs, margin + corridor_radius)

    segments = [
        (npos[a], npos[b]) for a, b in graph.edges
    ] or [(npos[nd], npos[nd]) for nd in nodes]
    # isolated nodes are still standable poses
    deg = dict(graph.degree) if hasattr(graph, "degree") else {}
    segments += [(npos[nd], npos[nd]) for nd in nodes if deg.get(nd, 0) == 0]

    free = np.zeros((n, n), dtype=bool)
    # disk stencil: cell-center offsets within corridor_radius
    r_cells = int(np.ceil(corridor_radius / _RES))
    di, dj = np.meshgrid(np.arange(-r_cells, r_cells + 1), np.arange(-r_cells, r_cells + 1), indexing="ij")
    disk = (di * _RES) ** 2 + (dj * _RES) ** 2 <= corridor_radius**2
    di, dj = di[disk], dj[disk]
    ox, oz = origin
    for a, b in segments:
        ax, az, bx, bz = a[0], a[-1], b[0], b[-1]
        length = float(np.hypot(bx - ax, bz - az))
        k = max(1, int(np.ceil(length / (0.5 * _RES))) + 1)
        ts = np.linspace(0.0, 1.0, k)
        px = ax + (bx - ax) * ts
        pz = az + (bz - az) * ts
        ci = ((px - ox) / _RES).astype(np.int32)
        cj = ((pz - oz) / _RES).astype(np.int32)
        ii = (ci[:, None] + di[None, :]).ravel()
        jj = (cj[:, None] + dj[None, :]).ravel()
        ok = (ii >= 0) & (ii < n) & (jj >= 0) & (jj < n)
        free[ii[ok], jj[ok]] = True
    occ = ~free
    occ[0, :] = occ[-1, :] = occ[:, 0] = occ[:, -1] = True  # boundary walls
    return ImportedScene(scene_id, occ, origin)


def scene_from_navigability(
    scene_id: str,
    is_navigable: Callable[[np.ndarray], np.ndarray],
    lower: Sequence[float],
    upper: Sequence[float],
    y: float = 0.0,
    margin: float = DEFAULT_MARGIN,
) -> ImportedScene:
    """Sample a point-navigability oracle over the grid — the generic
    navmesh exporter. `is_navigable` maps [K, 3] world points -> bool [K]
    (vectorized; habitat's pathfinder is wrapped point-wise by
    `scene_from_habitat`). `lower`/`upper` are world [x, y, z] bounds
    (habitat `pathfinder.get_bounds()`)."""
    lo = np.asarray(lower, np.float64)
    hi = np.asarray(upper, np.float64)
    origin, n = _grid_bounds(
        np.array([lo[0], hi[0]]), np.array([lo[-1], hi[-1]]), margin
    )
    ox, oz = origin
    # cell centers, matching cell_to_world (gridworld.py:93-95)
    cx = ox + (np.arange(n) + 0.5) * _RES
    cz = oz + (np.arange(n) + 0.5) * _RES
    ii, jj = np.meshgrid(cx, cz, indexing="ij")
    pts = np.stack([ii.ravel(), np.full(n * n, y), jj.ravel()], axis=1)
    nav = np.asarray(is_navigable(pts), dtype=bool).reshape(n, n)
    occ = ~nav
    occ[0, :] = occ[-1, :] = occ[:, 0] = occ[:, -1] = True
    return ImportedScene(scene_id, occ, origin)


def scene_from_habitat(scene_id: str, sim, margin: float = DEFAULT_MARGIN) -> ImportedScene:
    """Navmesh -> grid through a live habitat_sim instance: samples
    `sim.pathfinder.is_navigable` at every cell center at the navmesh floor
    height. Untestable without habitat_sim installed; the navigability
    sampling itself is covered through `scene_from_navigability`."""
    pf = sim.pathfinder
    lower, upper = pf.get_bounds()
    y = float(lower[1])

    def nav(pts: np.ndarray) -> np.ndarray:
        return np.array([pf.is_navigable([p[0], y, p[2]]) for p in pts], dtype=bool)

    return scene_from_navigability(scene_id, nav, lower, upper, y=y, margin=margin)


# ---------------------------------------------------------------------------
# persistence + registration
# ---------------------------------------------------------------------------


def save_scene_geometry(path: str, scene: BaseScene) -> None:
    """Persist a scene's grids (occupancy/origin/colors) as npz; `_RES` and a
    schema version are embedded so stale exports fail loudly."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(
        path,
        version=np.int32(_GEOMETRY_VERSION),
        res=np.float32(_RES),
        occupancy=np.asarray(scene.occupancy, bool),
        origin=np.asarray(scene.origin, np.float32),
        wall_colors=np.asarray(scene.wall_colors, np.uint8),
        floor_color=np.asarray(scene.floor_color, np.uint8),
        ceil_color=np.asarray(scene.ceil_color, np.uint8),
    )


def load_scene_geometry(path: str, scene_id: Optional[str] = None) -> ImportedScene:
    with np.load(path) as z:
        if int(z["version"]) != _GEOMETRY_VERSION:
            raise ValueError(f"{path}: geometry schema v{int(z['version'])} != v{_GEOMETRY_VERSION}")
        if abs(float(z["res"]) - _RES) > 1e-9:
            raise ValueError(f"{path}: exported at res={float(z['res'])}, runtime _RES={_RES}")
        return ImportedScene(
            scene_id or _scene_stem(path),
            z["occupancy"],
            tuple(np.asarray(z["origin"], np.float64)),
            wall_colors=z["wall_colors"],
            floor_color=z["floor_color"],
            ceil_color=z["ceil_color"],
        )


def import_connectivity_graphs(
    path: str,
    scene_ids: Optional[Iterable[str]] = None,
    corridor_radius: float = DEFAULT_CORRIDOR_RADIUS,
    register: bool = True,
) -> Dict[str, ImportedScene]:
    """Load the reference's connectivity pickle and rasterize every (or the
    selected) scene; with `register`, imported geometry is served for ANY
    episode scene_id whose stem matches (see `_install_stem_provider`)."""
    from vlnce_torch.utils.nav_graph import load_connectivity_graphs

    graphs = load_connectivity_graphs(path)
    if graphs is None:
        raise FileNotFoundError(path)
    want = {_scene_stem(s) for s in scene_ids} if scene_ids is not None else None
    scenes = {
        key: scene_from_graph(key, g, corridor_radius=corridor_radius)
        for key, g in graphs.items()
        if want is None or _scene_stem(key) in want
    }
    if register:
        register_scenes(scenes.values())
    return scenes


_STEM_SCENES: Dict[str, ImportedScene] = {}
_STEM_PROVIDER_INSTALLED = False


def _stem_provider(scene_id: str) -> Optional[BaseScene]:
    scene = _STEM_SCENES.get(_scene_stem(scene_id))
    return scene.with_scene_id(scene_id) if scene is not None else None


def _install_stem_provider() -> None:
    global _STEM_PROVIDER_INSTALLED
    if not _STEM_PROVIDER_INSTALLED:
        register_scene_provider(_stem_provider)
        _STEM_PROVIDER_INSTALLED = True


def register_scenes(scenes: Iterable[ImportedScene]) -> None:
    """Serve imported scenes for exact ids AND any id with a matching stem
    (episode scene_ids are dataset-relative .glb paths)."""
    for scene in scenes:
        register_scene(scene)
        _STEM_SCENES[_scene_stem(scene.scene_id)] = scene
    _install_stem_provider()


_GEOMETRY_DIRS: Dict[str, bool] = {}


def set_geometry_dir(geometry_dir: str) -> None:
    """Serve `{geometry_dir}/{scene_stem}.npz` exports lazily for any
    requested scene_id. Config surface: TASK_CONFIG.SIMULATOR.GEOMETRY_DIR
    (applied by apply_scene_geometry). Idempotent per directory."""
    geometry_dir = os.path.abspath(geometry_dir)
    if geometry_dir in _GEOMETRY_DIRS:
        return
    _GEOMETRY_DIRS[geometry_dir] = True

    def provider(scene_id: str) -> Optional[BaseScene]:
        path = os.path.join(geometry_dir, f"{_scene_stem(scene_id)}.npz")
        if not os.path.exists(path):
            return None
        return load_scene_geometry(path, scene_id=scene_id)

    register_scene_provider(provider)


_APPLIED_PICKLES: Dict[str, bool] = {}


def apply_scene_geometry(sim_cfg) -> None:
    """Install the geometry sources a SIMULATOR config names — GEOMETRY_DIR
    (npz exports) and/or CONNECTIVITY_GRAPHS (the reference pickle,
    rasterized on first use). Called by every scene-consuming entry point
    (host GridWorldSim.__init__ — so forked VectorEnv workers self-install —
    and the device-resident trainer setups), idempotent per source."""
    geo_dir = str(getattr(sim_cfg, "GEOMETRY_DIR", "") or "")
    if geo_dir:
        set_geometry_dir(geo_dir)
    pkl = str(getattr(sim_cfg, "CONNECTIVITY_GRAPHS", "") or "")
    if pkl and pkl not in _APPLIED_PICKLES:
        _APPLIED_PICKLES[pkl] = True
        import_connectivity_graphs(pkl)
