"""Top-down map drawing (host-side viz, off the hot path).

Port of vlnce_tpu/utils/maps.py (reference habitat_extensions/maps.py:14-343):
the map is an INDEX image of indicator ids (uint8), painted in place (agent
trail with a step gradient, MP3D node path, waypoint predictions as
triangles), and colorized at viz time through the 13-indicator palette and
a JET tail. Every drawing call goes through `utils/raster.py`, which paints
the pixels OpenCV paints.

As in the JAX package, `to_grid` and `reveal_fog_of_war` take raw world
x, z and do not subtract a scene's origin: right on procedural scenes
(origin (0, 0)); on imported scenes the agent is clipped to the map's edge.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from vlnce_torch.tasks.geometry import heading_from_quaternion
from vlnce_torch.utils import raster

MAP_THICKNESS_SCALAR: int = 128

# indicator ids (reference maps.py:16-28)
MAP_INVALID_POINT = 0
MAP_VALID_POINT = 1
MAP_BORDER_INDICATOR = 2
MAP_SOURCE_POINT_INDICATOR = 4
MAP_TARGET_POINT_INDICATOR = 6
MAP_MP3D_WAYPOINT = 7
MAP_VIEW_POINT_INDICATOR = 8
MAP_TARGET_BOUNDING_BOX = 9
MAP_REFERENCE_POINT = 10
MAP_MP3D_REFERENCE_PATH = 11
MAP_WAYPOINT_PREDICTION = 12
MAP_ORACLE_WAYPOINT = 13
MAP_SHORTEST_PATH_WAYPOINT = 14
# ids >= 15 are the agent-trail step gradient (JET colormap)


def _build_palette() -> np.ndarray:
    colors = np.full((256, 3), 150, dtype=np.uint8)
    colors[15:] = raster.jet()[:241]
    colors[MAP_INVALID_POINT] = [255, 255, 255]  # White
    colors[MAP_VALID_POINT] = [150, 150, 150]  # Light Grey
    colors[MAP_BORDER_INDICATOR] = [50, 50, 50]  # Grey
    colors[MAP_SOURCE_POINT_INDICATOR] = [0, 0, 200]  # Blue
    colors[MAP_TARGET_POINT_INDICATOR] = [200, 0, 0]  # Red
    colors[MAP_MP3D_WAYPOINT] = [0, 200, 0]  # Green
    colors[MAP_VIEW_POINT_INDICATOR] = [245, 150, 150]  # Light Red
    colors[MAP_TARGET_BOUNDING_BOX] = [0, 175, 0]  # Dark Green
    colors[MAP_REFERENCE_POINT] = [0, 0, 0]  # Black
    colors[MAP_MP3D_REFERENCE_PATH] = [0, 0, 0]  # Black
    colors[MAP_WAYPOINT_PREDICTION] = [255, 255, 0]  # Yellow
    colors[MAP_ORACLE_WAYPOINT] = [255, 165, 0]  # Orange
    colors[MAP_SHORTEST_PATH_WAYPOINT] = [0, 150, 0]  # Dark Green
    return colors


TOP_DOWN_MAP_COLORS = _build_palette()


def agent_heading(state) -> float:
    return heading_from_quaternion(state.rotation)


# ---------------------------------------------------------------------------
# coordinates
# ---------------------------------------------------------------------------


def to_grid(world_x: float, world_z: float, shape: Tuple[int, int], world_size: float) -> Tuple[int, int]:
    """World XZ -> (row, col) on the index map (row tracks z, col tracks x —
    the reference's habitat_maps.to_grid(pos[2], pos[0]) convention)."""
    row = int(np.clip(world_z / world_size * shape[0], 0, shape[0] - 1))
    col = int(np.clip(world_x / world_size * shape[1], 0, shape[1] - 1))
    return row, col


def make_top_down_index_map(sim, resolution: int, draw_border: bool = True) -> np.ndarray:
    """Scene occupancy -> indicator index map (VALID / INVALID / border)."""
    scene = getattr(sim, "_scene", None)
    if scene is None:
        return np.full((resolution, resolution), MAP_VALID_POINT, dtype=np.uint8)
    occ = scene.occupancy
    img = np.where(occ, MAP_INVALID_POINT, MAP_VALID_POINT).astype(np.uint8)
    img = raster.resize(img, (resolution, resolution), raster.INTER_NEAREST)
    if draw_border:
        # outline obstacle/free boundaries (habitat draw_border analog)
        occ_big = img == MAP_INVALID_POINT
        edge = occ_big ^ np.roll(occ_big, 1, 0) | (occ_big ^ np.roll(occ_big, 1, 1))
        img[edge & ~occ_big] = MAP_BORDER_INDICATOR
        img[0, :] = img[-1, :] = MAP_BORDER_INDICATOR
        img[:, 0] = img[:, -1] = MAP_BORDER_INDICATOR
    return img


# ---------------------------------------------------------------------------
# colorization (reference maps.py:61-80)
# ---------------------------------------------------------------------------


def colorize_topdown_map(
    index_map: np.ndarray,
    fog_of_war_mask: Optional[np.ndarray] = None,
    fog_of_war_desat_amount: float = 0.5,
) -> np.ndarray:
    if fog_of_war_mask is None:
        return TOP_DOWN_MAP_COLORS[index_map]
    if fog_of_war_mask.shape != index_map.shape:
        fog_of_war_mask = raster.resize(
            fog_of_war_mask.astype(np.uint8), index_map.shape[::-1], raster.INTER_NEAREST
        )
    # one palette per fog value, each colour scaled in f64 and truncated as
    # the JAX function scales each pixel; only valid points are desaturated,
    # as only valid points get revealed
    fog_of_war_desat_values = np.array([fog_of_war_desat_amount, 1.0])
    palettes = (TOP_DOWN_MAP_COLORS[None] * fog_of_war_desat_values[:, None, None]).astype(np.uint8)
    palettes[:, MAP_INVALID_POINT] = TOP_DOWN_MAP_COLORS[MAP_INVALID_POINT]
    return palettes[fog_of_war_mask, index_map]


# ---------------------------------------------------------------------------
# index-map drawing primitives (reference maps.py:105-171)
# ---------------------------------------------------------------------------


def drawline(
    img: np.ndarray, pt1: Tuple[int, int], pt2: Tuple[int, int], value: int,
    thickness: int = 2, style: str = "filled", gap: int = 15,
) -> None:
    """pt1/pt2 in (col, row) order; paints the indicator id. style
    'dotted' draws gap-spaced points along the segment."""
    if style == "filled":
        raster.line(img, pt1, pt2, int(value), thickness)
        return
    dist = ((pt1[0] - pt2[0]) ** 2 + (pt1[1] - pt2[1]) ** 2) ** 0.5
    pts = []
    for i in np.arange(0, dist, gap):
        r = i / max(dist, 1e-6)
        x = int((pt1[0] * (1 - r) + pt2[0] * r) + 0.5)
        y = int((pt1[1] * (1 - r) + pt2[1] * r) + 0.5)
        pts.append((x, y))
    for p in pts:
        raster.circle(img, p, thickness, int(value), -1)


def drawpoint(
    img: np.ndarray, position: Tuple[int, int], value: int, meters_per_px: float,
    pad: float = 0.3,
) -> None:
    """position in (row, col); paints a square of ~pad meters."""
    point_padding = max(1, int(pad / meters_per_px))
    r, c = position
    img[
        max(0, r - point_padding): r + point_padding + 1,
        max(0, c - point_padding): c + point_padding + 1,
    ] = value


def draw_triangle(
    img: np.ndarray, centroid: Tuple[int, int], value: int, meters_per_px: float,
    pad: float = 0.35,
) -> None:
    point_padding = max(2, int(pad / meters_per_px))
    r, c = centroid
    vertices = np.array(
        [
            [c, r - point_padding],
            [c - point_padding, r + point_padding],
            [c + point_padding, r + point_padding],
        ],
        np.int32,
    )
    raster.fill_poly(img, [vertices], int(value))


# ---------------------------------------------------------------------------
# composite overlays (reference maps.py:174-343)
# ---------------------------------------------------------------------------


def draw_reference_path(
    img: np.ndarray, episode, world_size: float, meters_per_px: float,
) -> None:
    """Dotted reference path + points (reference maps.py:174-225)."""
    shortest_path_points = [
        to_grid(p[0], p[2], img.shape[0:2], world_size) for p in episode.reference_path
    ]
    pt_from = None
    for r, c in shortest_path_points:
        if pt_from is not None:
            drawline(
                img, (pt_from[1], pt_from[0]), (c, r), MAP_REFERENCE_POINT,
                thickness=int(0.4 * img.shape[0] / MAP_THICKNESS_SCALAR),
                style="dotted", gap=10,
            )
        pt_from = (r, c)
    for r, c in shortest_path_points:
        drawpoint(img, (r, c), MAP_REFERENCE_POINT, meters_per_px, pad=0.2)


def draw_straight_shortest_path_points(
    img: np.ndarray, points: List[Sequence[float]], world_size: float,
) -> None:
    """Overlay the sim's shortest path (reference maps.py:228-244)."""
    pts = [to_grid(p[0], p[2], img.shape[0:2], world_size) for p in points]
    pts = [(c, r) for r, c in pts]
    raster.polylines(
        img, [np.array(pts, np.int32)], False, MAP_SHORTEST_PATH_WAYPOINT,
        thickness=int(0.4 * img.shape[0] / MAP_THICKNESS_SCALAR) + 1,
    )


def draw_source_and_target(img: np.ndarray, episode, world_size: float, meters_per_px: float) -> None:
    s = to_grid(episode.start_position[0], episode.start_position[2], img.shape[0:2], world_size)
    drawpoint(img, s, MAP_SOURCE_POINT_INDICATOR, meters_per_px)
    if episode.goals:
        g = episode.goals[0].position
        t = to_grid(g[0], g[2], img.shape[0:2], world_size)
        drawpoint(img, t, MAP_TARGET_POINT_INDICATOR, meters_per_px)


def draw_waypoint_prediction(
    img: np.ndarray, waypoint: Sequence[float], meters_per_px: float, world_size: float,
) -> None:
    """Predicted waypoint as a yellow triangle (reference maps.py:256-262);
    waypoint is a world [x, (y,)? z] position (uses [0] and [-1])."""
    r, c = to_grid(waypoint[0], waypoint[-1], img.shape[0:2], world_size)
    if 0 < r < img.shape[0] and 0 < c < img.shape[1]:
        draw_triangle(img, (r, c), MAP_WAYPOINT_PREDICTION, meters_per_px)


def draw_oracle_waypoint(
    img: np.ndarray, waypoint: Sequence[float], meters_per_px: float, world_size: float,
) -> None:
    r, c = to_grid(waypoint[0], waypoint[-1], img.shape[0:2], world_size)
    draw_triangle(img, (r, c), MAP_ORACLE_WAYPOINT, meters_per_px, pad=0.2)


def draw_mp3d_nodes(img: np.ndarray, graph, episode, world_size: float, meters_per_px: float) -> None:
    """Paint nav-graph nodes near the starting floor (reference
    maps.py:321-343)."""
    from vlnce_torch.utils.nav_graph import _node_position, get_nearest_node

    n = get_nearest_node(graph, (episode.start_position[0], episode.start_position[2]))
    if n is None:
        return
    starting_height = _node_position(graph, n)[1] if len(_node_position(graph, n)) > 2 else 0.0
    for node in graph:
        pos = _node_position(graph, node)
        height = pos[1] if len(pos) > 2 else 0.0
        if abs(height - starting_height) < 1.0:
            r, c = to_grid(pos[0], pos[-1], img.shape[0:2], world_size)
            if img[r, c]:  # only paint over valid points
                drawpoint(img, (r, c), MAP_MP3D_WAYPOINT, meters_per_px, pad=0.2)


# ---------------------------------------------------------------------------
# fog of war
# ---------------------------------------------------------------------------


def reveal_fog_of_war(
    occupancy: np.ndarray,
    fog_mask: np.ndarray,
    position,
    heading: float,
    fov_deg: float = 90.0,
    visibility_dist: float = 5.0,
    world_size: float = 16.0,
    num_rays: int = 90,
) -> np.ndarray:
    """Reveal the agent's view cone in the fog mask with occlusion raycasts
    over the scene occupancy grid (habitat fog_of_war equivalent)."""
    n = occupancy.shape[0]
    cell = world_size / n
    fog = fog_mask
    half = math.radians(fov_deg) / 2.0
    ci = position[0] / cell
    cj = position[-1] / cell
    max_steps = int(visibility_dist / (0.5 * cell))
    for ang in np.linspace(heading - half, heading + half, num_rays):
        dx = -math.sin(ang) / 2.0  # half-cell steps along the view ray
        dz = -math.cos(ang) / 2.0
        x, z = ci, cj
        for _ in range(max_steps):
            i, j = int(x), int(z)
            if not (0 <= i < n and 0 <= j < n):
                break
            fog[i, j] = 1
            if occupancy[i, j]:
                break
            x += dx
            z += dz
    return fog


# ---------------------------------------------------------------------------
# metric -> RGB frame
# ---------------------------------------------------------------------------


def draw_agent(img_rgb: np.ndarray, map_coord: Tuple[int, int], heading: float,
               meters_per_px: float) -> np.ndarray:
    """Arrow agent sprite on the colorized map."""
    r, c = map_coord
    radius = max(3, int(0.25 / meters_per_px))
    tip = (int(c - 2 * radius * math.sin(heading)), int(r - 2 * radius * math.cos(heading)))
    raster.circle(img_rgb, (c, r), radius, (0, 200, 0), -1)
    raster.line(img_rgb, (c, r), tip, (0, 200, 0), max(1, radius // 2))
    return img_rgb


def colorize_topdown_metric(metric: Dict) -> np.ndarray:
    """Render the TopDownMapVLNCE metric dict (index map + fog + agent pose)
    into an RGB frame."""
    img = colorize_topdown_map(metric["map"], metric.get("fog_of_war_mask"))
    draw_agent(img, metric["agent_map_coord"], metric["agent_angle"], metric["meters_per_px"])
    return img
