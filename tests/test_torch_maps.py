"""The port's top-down maps held against the JAX package's: every function
of `utils/maps.py`, `nav_graph.draw_nav_graph`, and the TopDownMapVLNCE
measure stepped through the same episodes with the same actions, where the
index map, the fog mask, the agent's map coordinates and angle must be
equal at every step (MAP_RESOLUTION 256 and 1024)."""

from __future__ import annotations

import pickle
import types

import numpy as np
import pytest

pytest.importorskip("cv2")

import vlnce_tpu.envs as jax_envs  # noqa: E402
import vlnce_torch.envs as port_envs  # noqa: E402
from vlnce_tpu.config import get_config as jax_get_config  # noqa: E402
from vlnce_tpu.utils import maps as jmaps  # noqa: E402
from vlnce_tpu.utils import nav_graph as jnav  # noqa: E402
from vlnce_torch.config import get_config  # noqa: E402
from vlnce_torch.envs.gridworld import get_scene  # noqa: E402
from vlnce_torch.utils import maps as tmaps  # noqa: E402
from vlnce_torch.utils import nav_graph as tnav  # noqa: E402

WORLD = 16.0


def _sim_with_scene(scene_id="synth_scene_3"):
    return types.SimpleNamespace(_scene=get_scene(scene_id))


def _pair(fn, *args, **kwargs):
    """Call the same function of both packages on copies of the same array
    arguments; returns both results and both (painted) copies."""
    a_args = [np.array(x) if isinstance(x, np.ndarray) else x for x in args]
    b_args = [np.array(x) if isinstance(x, np.ndarray) else x for x in args]
    return getattr(jmaps, fn)(*a_args, **kwargs), getattr(tmaps, fn)(*b_args, **kwargs), a_args, b_args


def test_palette_and_indicator_ids_match_jax():
    np.testing.assert_array_equal(tmaps.TOP_DOWN_MAP_COLORS, jmaps.TOP_DOWN_MAP_COLORS)
    for name in dir(jmaps):
        if name.startswith("MAP_"):
            assert getattr(tmaps, name) == getattr(jmaps, name), name


@pytest.mark.parametrize("resolution", [64, 256, 1024])
def test_index_map_and_colorize_match_jax(resolution):
    sim = _sim_with_scene()
    for border in (True, False):
        a = jmaps.make_top_down_index_map(sim, resolution, draw_border=border)
        b = tmaps.make_top_down_index_map(sim, resolution, draw_border=border)
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(resolution)
    fog = (rng.random(sim._scene.occupancy.shape) < 0.5).astype(np.uint8)
    for f, amount in ((None, 0.5), (fog, 0.5), (fog, 0.75)):
        np.testing.assert_array_equal(jmaps.colorize_topdown_map(a, f, amount), tmaps.colorize_topdown_map(b, f, amount))
    assert tmaps.make_top_down_index_map(types.SimpleNamespace(), 32).shape == (32, 32)


@pytest.mark.parametrize("resolution", [256, 1024])
def test_drawing_functions_match_jax(resolution):
    rng = np.random.default_rng(resolution)
    base = tmaps.make_top_down_index_map(_sim_with_scene(), resolution)
    mpp = WORLD / resolution
    ep = types.SimpleNamespace(
        start_position=[3.1, 0.0, 4.7], goals=[types.SimpleNamespace(position=[12.2, 0.0, 9.9])],
        reference_path=[[3.1, 0.0, 4.7], [6.0, 0.0, 5.5], [9.0, 0.0, 8.0], [12.2, 0.0, 9.9]],
    )
    graph = tnav.synthetic_lattice_graph(WORLD)
    for _ in range(10):
        p1 = (int(rng.integers(0, resolution)), int(rng.integers(0, resolution)))
        p2 = (int(rng.integers(0, resolution)), int(rng.integers(0, resolution)))
        for kw in ({"thickness": int(rng.integers(1, 13))}, {"thickness": 3, "style": "dotted", "gap": 10}):
            _, _, (a, *_), (b, *_) = _pair("drawline", base, p1, p2, 20, **kw)
            np.testing.assert_array_equal(a, b)
        for fn, args in (("drawpoint", (p1, 7, mpp)), ("draw_triangle", (p1, 12, mpp)),
                         ("draw_triangle", ((p1[0], 0), 13, mpp, 0.2))):
            _, _, (a, *_), (b, *_) = _pair(fn, base, *args)
            np.testing.assert_array_equal(a, b)
        wp = rng.uniform(-1, WORLD + 1, 3)
        for fn in ("draw_waypoint_prediction", "draw_oracle_waypoint"):
            _, _, (a, *_), (b, *_) = _pair(fn, base, wp, mpp, WORLD)
            np.testing.assert_array_equal(a, b)
        head = float(rng.uniform(-np.pi, np.pi))
        rgb = jmaps.colorize_topdown_map(base)
        a, b = jmaps.draw_agent(rgb.copy(), p1, head, mpp), tmaps.draw_agent(rgb.copy(), p1, head, mpp)
        np.testing.assert_array_equal(a, b)
    for fn, args in (("draw_reference_path", (ep, WORLD, mpp)), ("draw_source_and_target", (ep, WORLD, mpp)),
                     ("draw_straight_shortest_path_points", (ep.reference_path, WORLD)),
                     ("draw_mp3d_nodes", (graph, ep, WORLD, mpp))):
        _, _, (a, *_), (b, *_) = _pair(fn, base, *args)
        np.testing.assert_array_equal(a, b, err_msg=fn)
    a, b = jnav.draw_nav_graph(base.copy(), graph, WORLD), tnav.draw_nav_graph(base.copy(), graph, WORLD)
    np.testing.assert_array_equal(a, b)
    assert (a != base).any()


def test_fog_of_war_and_to_grid_match_jax():
    occ = get_scene("synth_scene_5").occupancy
    rng = np.random.default_rng(0)
    for _ in range(20):
        pos = rng.uniform(0, WORLD, 3)
        head = float(rng.uniform(-np.pi, np.pi))
        a, b = np.zeros_like(occ, np.uint8), np.zeros_like(occ, np.uint8)
        jmaps.reveal_fog_of_war(occ, a, pos, head, 90.0, 5.0, WORLD)
        tmaps.reveal_fog_of_war(occ, b, pos, head, 90.0, 5.0, WORLD)
        np.testing.assert_array_equal(a, b)
        for shape in ((256, 256), (1024, 1024)):
            assert jmaps.to_grid(pos[0], pos[2], shape, WORLD) == tmaps.to_grid(pos[0], pos[2], shape, WORLD)
    # both take raw world x, z: an imported scene's negative origin clips
    assert tmaps.to_grid(-20.0, 25.0, (1024, 1024), 42.0) == jmaps.to_grid(-20.0, 25.0, (1024, 1024), 42.0) == (609, 0)


def _task_config(get, pkg, resolution, graphs_file, fog=True):
    cfg = get(opts=[
        "BASE_TASK_CONFIG_PATH", f"{pkg}/tasks/config/vlnce_task.yaml",
        "TASK_CONFIG.DATASET.TYPE", "Synthetic-VLN-v0",
        "TASK_CONFIG.DATASET.NUM_EPISODES", 3,
        "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", 30,
        "TASK_CONFIG.SIMULATOR.RGB_SENSOR.HEIGHT", 16, "TASK_CONFIG.SIMULATOR.RGB_SENSOR.WIDTH", 16,
        "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.HEIGHT", 16, "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.WIDTH", 16,
        "TASK_CONFIG.TASK.TOP_DOWN_MAP_VLNCE.MAP_RESOLUTION", resolution,
        "TASK_CONFIG.TASK.TOP_DOWN_MAP_VLNCE.GRAPHS_FILE", graphs_file,
        "TASK_CONFIG.TASK.TOP_DOWN_MAP_VLNCE.FOG_OF_WAR.DRAW", fog,
    ])
    task = cfg.TASK_CONFIG.clone()
    task.defrost()
    task.TASK.MEASUREMENTS.append("TOP_DOWN_MAP_VLNCE")
    task.freeze()
    return task


@pytest.mark.parametrize("resolution", [256, 1024])
@pytest.mark.parametrize("with_graph", [False, True], ids=["no_graph", "graph"])
def test_top_down_map_measure_matches_jax_at_every_step(tmp_path, resolution, with_graph):
    """Three episodes, each stepped by both packages' Env with the same
    actions (mostly the oracle's, some random turns and moves)."""
    graphs = str(tmp_path / "graphs.pkl")
    if with_graph:
        with open(graphs, "wb") as f:
            pickle.dump({f"synth_scene_{i}": tnav.synthetic_lattice_graph(WORLD) for i in range(8)}, f)
    envs = [jax_envs.Env(_task_config(jax_get_config, "vlnce_tpu", resolution, graphs)),
            port_envs.Env(_task_config(get_config, "vlnce_torch", resolution, graphs))]
    rng = np.random.default_rng(resolution + with_graph)
    nodes_drawn = False
    for _ in range(3):
        obs = [e.reset() for e in envs]
        steps = 0
        while True:
            a, b = (e.get_metrics()["top_down_map_vlnce"] for e in envs)
            np.testing.assert_array_equal(a["map"], b["map"], err_msg=f"step {steps}")
            np.testing.assert_array_equal(a["fog_of_war_mask"], b["fog_of_war_mask"])
            assert a["agent_map_coord"] == b["agent_map_coord"] and a["agent_angle"] == b["agent_angle"]
            for k in ("meters_per_px", "world_size", "step_count", "bounds"):
                assert a[k] == b[k], k
            nodes_drawn |= bool((b["map"] == tmaps.MAP_MP3D_WAYPOINT).any())
            if envs[0].episode_over:
                break
            act = int(obs[0]["shortest_path_sensor"][0]) if rng.random() < 0.75 else int(rng.integers(1, 4))
            obs = [e.step(act) for e in envs]
            steps += 1
        assert steps > 2
        assert (b["map"] >= 15).any()  # the agent's trail
    assert nodes_drawn == with_graph
    for e in envs:
        e.close()
