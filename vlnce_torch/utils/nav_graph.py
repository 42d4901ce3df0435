"""MP3D navigation-graph utilities.

Port of vlnce_tpu/utils/nav_graph.py; `draw_nav_graph` draws through
`utils/raster.py` on the top-down index maps of the video path.

The reference ships data/connectivity_graphs.pkl — a pickled
{scene_id: networkx.Graph} of MP3D panorama nodes — consumed by the
TopDownMapVLNCE overlay and nearest-node tracking (reference
habitat_extensions/maps.py:277-343, measures.py:336-337). This module loads
that exact format, tracks the nearest node along an agent path, and can
synthesize a lattice graph (`LatticeGraph`, built without networkx) for
procedural GridWorld scenes so the same code paths run without MP3D assets. Unpickling the reference's file needs
networkx, as in the JAX package; the rest takes any graph object with
networkx's `.nodes[...]` and `.edges` interface.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Optional, Sequence

import numpy as np


def load_connectivity_graphs(path: str) -> Optional[Dict[str, "object"]]:
    """{scene_id: networkx.Graph}; nodes carry pos attributes."""
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return pickle.load(f)


class _EdgeView(list):
    """networkx's edge view: iterated, every edge once; called with a node,
    that node's edges as (node, neighbour) pairs."""

    def __call__(self, node):
        return [(node, b if a == node else a) for a, b in self if node in (a, b)]


class LatticeGraph:
    """A lattice navigation graph with networkx's `.nodes[node]` and `.edges`
    interface, built without networkx: nodes `spacing` apart over a
    width x depth box from (x0, z0), keyed by their (x, z) and carrying
    their world `position`, edges between 4-neighbours. It pickles without
    networkx, so a connectivity pickle of it loads on machines that lack it."""

    def __init__(self, x0: float, z0: float, width: float, depth: float, spacing: float = 2.0):
        xs = [float(x) for x in x0 + spacing * np.arange(int(round(width / spacing)) + 1)]
        zs = [float(z) for z in z0 + spacing * np.arange(int(round(depth / spacing)) + 1)]
        self.nodes = {(x, z): {"position": [x, 0.0, z]} for x in xs for z in zs}
        self.edges = _EdgeView(
            ((xs[i], zs[j]), nb) for i in range(len(xs)) for j in range(len(zs))
            for nb in ([(xs[i + 1], zs[j])] if i + 1 < len(xs) else []) + ([(xs[i], zs[j + 1])] if j + 1 < len(zs) else [])
        )

    def __iter__(self):
        """Iterating a networkx graph yields its nodes."""
        return iter(self.nodes)


def synthetic_lattice_graph(world_size: float = 16.0, spacing: float = 2.0) -> LatticeGraph:
    """Lattice nav graph over the GridWorld corridor grid (nodes at the
    carved 2m lattice crossings)."""
    side = spacing * (len(np.arange(1.0, world_size, spacing)) - 1)
    return LatticeGraph(1.0, 1.0, side, side, spacing)


def _node_position(graph, node) -> np.ndarray:
    """A node's world [x, y, z] from its `position` (or `pos`) attribute,
    else the node itself; a 2-d position is (x, z) at y = 0. `graph` is
    anything with networkx's `.nodes[node]` mapping."""
    data = graph.nodes[node]
    pos = data.get("position", data.get("pos", node))
    pos = np.asarray(pos, dtype=np.float64)
    if pos.shape[-1] == 2:
        pos = np.array([pos[0], 0.0, pos[1]])
    return pos


def get_nearest_node(graph, position: Sequence[float]):
    """Closest graph node to a world position (XZ distance); reference
    maps.py:277-295."""
    p = np.asarray(position, dtype=np.float64)
    best, best_d = None, np.inf
    for node in graph.nodes:
        q = _node_position(graph, node)
        d = float(np.hypot(q[0] - p[0], q[-1] - p[-1]))
        if d < best_d:
            best, best_d = node, d
    return best


def update_nearest_node(graph, current_node, position: Sequence[float]):
    """Nearest among the current node and its graph neighbors — a single
    reachability-constrained hop per step, so the drawn node path follows
    nav-graph edges (reference maps.py:298-318)."""
    p = np.asarray(position, dtype=np.float64)

    def dist(node):
        q = _node_position(graph, node)
        return float(np.hypot(q[0] - p[0], q[-1] - p[-1]))

    candidates = [current_node] + [e[1] for e in graph.edges(current_node)]
    return min(candidates, key=dist)


def draw_nav_graph(img: np.ndarray, graph, world_size: float = 16.0) -> np.ndarray:
    """Overlay graph edges + nodes on a top-down INDEX map (indicator ids;
    reference maps.py:321-343 draws only nodes — edges are an extra here)."""
    from vlnce_torch.utils import raster
    from vlnce_torch.utils.maps import MAP_MP3D_WAYPOINT, drawpoint, to_grid

    shape = img.shape[0:2]
    meters_per_px = world_size / shape[0]
    for a, b in graph.edges:
        ra, ca = to_grid(*_node_position(graph, a)[[0, -1]], shape, world_size)
        rb, cb = to_grid(*_node_position(graph, b)[[0, -1]], shape, world_size)
        raster.line(img, (ca, ra), (cb, rb), MAP_MP3D_WAYPOINT, 1)
    for node in graph.nodes:
        pos = _node_position(graph, node)
        drawpoint(img, to_grid(pos[0], pos[-1], shape, world_size), MAP_MP3D_WAYPOINT, meters_per_px, pad=0.15)
    return img
