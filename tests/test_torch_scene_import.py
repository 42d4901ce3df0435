"""The port's scene import (envs/scene_import.py, utils/nav_graph.py, the
export and feature-bank CLIs of vlnce_torch/scripts/) against the JAX
package's, at small sizes on the CPU.

Held against JAX, on lattice graphs in a native frame away from the origin
(tests/test_scene_import.py's offset lattice, and a larger one):

- the rasterized occupancy, colors and origin: bit-equal, from a networkx
  graph and from a plain object with its interface;
- the npz exports, written by one package and read by the other;
- `apply_scene_geometry` through a simulator config, from a directory of
  exports and from a connectivity pickle;
- the host simulator's dynamics (atol 1e-9, both float64), and the card's
  scene batch (exact), dynamics (atol 1e-5), renders (depth atol 1e-4, RGB
  |diff| > 1 on under 0.5% of the pixels) and geodesics (atol 1e-6), the
  tolerances of tests/test_torch_device_sim.py, on a batch of two imported
  scenes of different grid sizes;
- greedy scan-eval actions on imported scenes (two chunks of two grid
  sizes): equal to `run_scan_rollouts`', measures within atol 1e-6;
- the export CLI: npz arrays bit-equal to the JAX script's; the bank CLI
  over exported geometry and graph nodes: node positions exact, features
  within 1e-4 (tests/test_torch_feature_bank.py's tolerance) before the
  files round them to f16, so within 1e-4 and one f16 spacing in the files.
"""

import math
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import networkx as nx
import numpy as np
import pytest
import torch

import vlnce_tpu.models  # noqa: F401
import vlnce_tpu.tasks  # noqa: F401
import vlnce_tpu.trainers  # noqa: F401
from vlnce_tpu.config import get_config as jax_get_config
from vlnce_tpu.envs import device_sim as jds
from vlnce_tpu.envs import ensure_registered as jax_ensure_registered
from vlnce_tpu.envs import scene_import as jsi
from vlnce_tpu.envs.gridworld import GridWorldSim as JaxGridWorldSim
from vlnce_tpu.tasks.episodes import InstructionData as JaxInstructionData
from vlnce_tpu.tasks.episodes import NavigationGoal as JaxNavigationGoal
from vlnce_tpu.tasks.episodes import VLNEpisode as JaxVLNEpisode
from vlnce_tpu.trainers import scan_eval as jax_scan
from vlnce_tpu.utils.nav_graph import synthetic_lattice_graph
import vlnce_torch.tasks  # noqa: F401
import vlnce_torch.trainers  # noqa: F401
from vlnce_torch.config import get_config
from vlnce_torch.envs import device_sim as ds
from vlnce_torch.envs import ensure_registered
from vlnce_torch.envs import scene_import as si
from vlnce_torch.envs.gridworld import GridWorldSim, get_scene
from vlnce_torch.models.convert import state_dict_from_jax_params
from vlnce_torch.tasks.episodes import InstructionData, NavigationGoal, VLNEpisode
from vlnce_torch.tasks.geometry import quat_from_heading
from vlnce_torch.trainers import scan_eval
from vlnce_torch.utils import nav_graph

from tests.torch_port_cases import (
    JAX_R2R_CMA, R2R_CMA, R2R_SMALL_OPTS, SceneRegistrySnapshot, build_r2r_pair,
)

jax_ensure_registered()
ensure_registered()

IMG = 16
FWD, TURN = 0.25, math.radians(15.0)
# two imported scenes in native frames away from the origin, of different grid sizes
SCENES = {"imported/offset_a.glb": (-20.0, 12.0, 16.0), "imported/offset_b.glb": (5.0, -30.0, 24.0)}


@pytest.fixture(autouse=True)
def clean_scene_registry():
    with SceneRegistrySnapshot():
        yield


def _offset_graph(dx, dz, world, spacing=2.0):
    """tests/test_scene_import.py's offset lattice: networkx, nodes moved
    by (dx, dz)."""
    g = synthetic_lattice_graph(world_size=world, spacing=spacing)
    out = nx.Graph()
    for node, data in g.nodes(data=True):
        p = data["position"]
        out.add_node(node, position=[p[0] + dx, p[1], p[2] + dz])
    out.add_edges_from(g.edges)
    return out


class _Plain:
    """The same graph as a plain object with networkx's interface."""

    def __init__(self, graph):
        self.nodes = {n: dict(graph.nodes[n]) for n in graph.nodes}
        self.edges = list(graph.edges)


def _register_both(scene_ids=SCENES):
    """Each scene rasterized by each package and registered in it."""
    out = {}
    for scene_id in scene_ids:
        dx, dz, world = SCENES[scene_id]
        g = _offset_graph(dx, dz, world)
        stem = si._scene_stem(scene_id)
        jsi.register_scenes([jsi.scene_from_graph(stem, g)])
        si.register_scenes([si.scene_from_graph(stem, g)])
        out[scene_id] = g
    return out


def _sim_configs():
    opts = ["TASK_CONFIG.DATASET.TYPE", "Synthetic-VLN-v0",
            "TASK_CONFIG.SIMULATOR.RGB_SENSOR.HEIGHT", IMG, "TASK_CONFIG.SIMULATOR.RGB_SENSOR.WIDTH", IMG,
            "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.HEIGHT", IMG, "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.WIDTH", IMG]
    jcfg = jax_get_config(opts=["BASE_TASK_CONFIG_PATH", "vlnce_tpu/tasks/config/vlnce_task.yaml"] + opts)
    cfg = get_config(opts=opts)
    return jcfg.TASK_CONFIG.SIMULATOR, cfg.TASK_CONFIG.SIMULATOR


def _assert_same_scene(got, want):
    assert isinstance(got, si.ImportedScene) and got.scene_id == want.scene_id
    for field in ("occupancy", "wall_colors", "floor_color", "ceil_color"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert got.origin == want.origin and got.origin != (0.0, 0.0)


def test_rasterized_offset_lattice_equals_jax():
    for scene_id, (dx, dz, world) in SCENES.items():
        g = _offset_graph(dx, dz, world)
        want = jsi.scene_from_graph("offset", g)
        _assert_same_scene(si.scene_from_graph("offset", g), want)
        _assert_same_scene(si.scene_from_graph("offset", _Plain(g)), want)
    assert si.scene_from_graph("a", _offset_graph(-20.0, 12.0, 16.0)).n != si.scene_from_graph("b", _offset_graph(5.0, -30.0, 24.0)).n
    # the helpers of utils/nav_graph
    g = _offset_graph(-20.0, 12.0, 16.0)
    from vlnce_tpu.utils import nav_graph as jax_nav_graph

    for pos in ([-19.2, 0.0, 13.1], [-9.0, 0.0, 20.6]):
        assert nav_graph.get_nearest_node(g, pos) == jax_nav_graph.get_nearest_node(g, pos)
        node = nav_graph.get_nearest_node(g, pos)
        assert nav_graph.update_nearest_node(g, node, [pos[0] + 1.6, 0.0, pos[2]]) == \
            jax_nav_graph.update_nearest_node(g, node, [pos[0] + 1.6, 0.0, pos[2]])
    lattice, jax_lattice = nav_graph.synthetic_lattice_graph(8.0, 2.0), jax_nav_graph.synthetic_lattice_graph(8.0, 2.0)
    assert sorted(lattice.nodes) == sorted(jax_lattice.nodes)
    assert sorted(map(sorted, lattice.edges)) == sorted(map(sorted, jax_lattice.edges))
    assert all(sorted(lattice.edges(n)) == sorted(jax_lattice.edges(n)) for n in jax_lattice.nodes)
    assert nav_graph.update_nearest_node(lattice, (3.0, 3.0), [4.6, 0.0, 3.2]) == \
        jax_nav_graph.update_nearest_node(jax_lattice, (3.0, 3.0), [4.6, 0.0, 3.2]) == (5.0, 3.0)


def test_geometry_npz_crosses_packages_both_ways(tmp_path):
    g = _offset_graph(-20.0, 12.0, 16.0)
    jax_scene, scene = jsi.scene_from_graph("zsNo4HB9uLZ", g), si.scene_from_graph("zsNo4HB9uLZ", g)
    jsi.save_scene_geometry(str(tmp_path / "jax" / "zsNo4HB9uLZ.npz"), jax_scene)
    si.save_scene_geometry(str(tmp_path / "port" / "zsNo4HB9uLZ.npz"), scene)
    _assert_same_scene(si.load_scene_geometry(str(tmp_path / "jax" / "zsNo4HB9uLZ.npz")), jax_scene)
    back = jsi.load_scene_geometry(str(tmp_path / "port" / "zsNo4HB9uLZ.npz"))
    _assert_same_scene(si.ImportedScene(back.scene_id, back.occupancy, back.origin, back.wall_colors, back.floor_color,
                                        back.ceil_color), jax_scene)
    with np.load(tmp_path / "jax" / "zsNo4HB9uLZ.npz") as a, np.load(tmp_path / "port" / "zsNo4HB9uLZ.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_apply_scene_geometry_through_a_sim_config(tmp_path):
    """GEOMETRY_DIR and CONNECTIVITY_GRAPHS, each installed by the host
    simulator's constructor, as in a forked worker. A scene with no export
    falls back to the procedural one, as in the JAX package."""
    g = _offset_graph(2.0, -7.0, 16.0)
    si.save_scene_geometry(str(tmp_path / "geo" / "cfg_scene.npz"), si.scene_from_graph("cfg_scene", g))
    with open(tmp_path / "graphs.pkl", "wb") as f:
        pickle.dump({"pkl_scene": g}, f)
    _, sim_cfg = _sim_configs()
    sim_cfg = sim_cfg.clone()
    sim_cfg.defrost()
    sim_cfg.GEOMETRY_DIR = str(tmp_path / "geo")
    sim_cfg.CONNECTIVITY_GRAPHS = str(tmp_path / "graphs.pkl")
    sim = GridWorldSim(sim_cfg)
    want = jsi.scene_from_graph("cfg_scene", g)
    for scene_id in ("imported/cfg_scene.glb", "mp3d/pkl_scene/pkl_scene.glb"):
        sim.reconfigure(scene_id)
        assert sim._scene.scene_id == scene_id
        np.testing.assert_array_equal(sim._scene.occupancy, want.occupancy)
        assert isinstance(sim._scene, si.ImportedScene) and sim._scene.origin == want.origin != (0.0, 0.0)
    sim.reconfigure("synthetic/synth_scene_0.glb")
    assert not isinstance(sim._scene, si.ImportedScene) and sim._scene.origin == (0.0, 0.0)


def _host_poses(scene):
    """Lattice-node poses of an imported scene (its graph's nodes lie 1 m
    inside the grid's origin, 2 m apart)."""
    ox, oz = scene.origin
    nodes = [(ox + 1.0 + 2.0 * i, oz + 1.0 + 2.0 * j) for i in range(4) for j in range(4)]
    return [(x, z) for x, z in nodes if scene.navigable_cell(*scene.world_to_cell(x, z))]


def test_host_and_card_world_on_imported_scenes_match_jax():
    _register_both()
    jsim_cfg, sim_cfg = _sim_configs()
    rng = np.random.RandomState(0)
    scene_ids = list(SCENES)

    # the host simulators, float64 in both packages
    for scene_id in scene_ids:
        jsim, sim = JaxGridWorldSim(jsim_cfg), GridWorldSim(sim_cfg)
        jsim.reconfigure(scene_id)
        sim.reconfigure(scene_id)
        assert isinstance(sim._scene, si.ImportedScene)
        x, z = _host_poses(sim._scene)[0]
        for s in (jsim, sim):
            s.set_agent_state(np.array([x, 0.0, z]), quat_from_heading(0.4))
        for a in rng.randint(1, 4, size=30):
            jsim.step(int(a))
            sim.step(int(a))
        np.testing.assert_allclose(sim.get_agent_state().position, jsim.get_agent_state().position, rtol=0, atol=1e-9)
        goal = [x + 4.0, 0.0, z + 2.0]
        p = sim.get_agent_state().position
        assert sim.geodesic_distance(p, goal) == jsim.geodesic_distance(p, goal)

    # the card's world: a batch of both scenes, padded to the larger grid
    class Goal:
        def __init__(self, p):
            self.position = p

    class Ep:
        def __init__(self, scene_id, start, goal):
            self.scene_id, self.start_position, self.goals, self.info = scene_id, start, [Goal(goal)], {}

    starts, eps = [], []
    for scene_id in scene_ids:
        scene = get_scene(scene_id)
        (x, z), (gx, gz) = _host_poses(scene)[1], _host_poses(scene)[-1]
        starts.append([x, 0.0, z])
        eps.append(Ep(scene_id, [x, 0.0, z], [gx, 0.0, gz]))
    want = jds.build_scene_batch(eps)
    got = ds.build_scene_batch(eps)
    assert got.occupancy.shape[1] == max(get_scene(s).n for s in scene_ids) > min(get_scene(s).n for s in scene_ids)
    for field in jds.SceneBatch._fields:
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)), err_msg=field)

    pos0 = np.asarray(starts, np.float32)
    head0 = np.array([0.7, 2.0], np.float32)
    occ, origin = np.asarray(want.occupancy), np.asarray(want.origin_xz)
    jstep = jax.jit(jax.vmap(lambda o, p, h, a, og: jds.step_discrete(o, p, h, a, FWD, TURN, True, og)))
    jpos, jhead = jnp.asarray(pos0), jnp.asarray(head0)
    pos, head = torch.from_numpy(pos0), torch.from_numpy(head0)
    for a in rng.randint(1, 4, size=(40, 2)).astype(np.int32):
        jpos, jhead = jstep(jnp.asarray(occ), jpos, jhead, jnp.asarray(a), jnp.asarray(origin))
        pos, head = ds.step_discrete(got.occupancy, pos, head, torch.from_numpy(a), FWD, TURN, True, got.origin_xz)
    np.testing.assert_allclose(pos.numpy(), np.asarray(jpos), rtol=0, atol=1e-5)
    assert np.abs(pos.numpy() - pos0).max() > 0.2  # the agents moved

    specs = ds.camera_specs_from_config(sim_cfg)
    jspecs = jds.camera_specs_from_config(jsim_cfg)
    frames = ds.render_batch(got, pos, head, specs)
    for spec in jspecs:
        wantf = np.asarray(jax.vmap(lambda o, w, f, c, p, h, og: jds.render_camera(o, w, f, c, p, h, spec, origin=og))(
            jnp.asarray(occ), jnp.asarray(want.wall_colors), jnp.asarray(want.floor_color), jnp.asarray(want.ceil_color),
            jnp.asarray(pos.numpy()), jnp.asarray(head.numpy()), jnp.asarray(origin)))
        gotf = frames[spec.uuid].numpy()
        assert gotf.shape == wantf.shape
        if spec.kind == "depth":
            np.testing.assert_allclose(gotf, wantf, rtol=0, atol=1e-4)
        else:
            assert float((np.abs(gotf.astype(int) - wantf.astype(int)) > 1).mean()) < 0.005

    d = ds.geodesic_at(got.goal_field, pos, got.origin_xz).numpy()
    jd = np.asarray(jax.vmap(jds.geodesic_at)(jnp.asarray(want.goal_field), jnp.asarray(pos.numpy()), jnp.asarray(origin)))
    np.testing.assert_allclose(d, jd, rtol=0, atol=1e-6)
    assert np.isfinite(d).all()
    np.testing.assert_allclose(ds.progress_batch(got, pos).numpy(),
                               np.asarray(jds.progress_batch(want, jnp.asarray(pos.numpy()))), rtol=0, atol=1e-6)


def _lattice_episodes(scene_id, graph, n_eps, rng, cls=(VLNEpisode, InstructionData, NavigationGoal)):
    """tests/test_scene_import.py's episodes: start and goal on graph nodes."""
    episode, instruction, goal_cls = cls
    nodes = [nav_graph._node_position(graph, n) for n in graph.nodes]
    eps = []
    for i in range(n_eps):
        a, b = rng.choice(len(nodes), 2, replace=False)
        start, goal = nodes[a], nodes[b]
        eps.append(episode(
            episode_id=f"{si._scene_stem(scene_id)}_{i}", trajectory_id=str(i), scene_id=scene_id,
            start_position=[float(x) for x in start],
            start_rotation=[float(x) for x in quat_from_heading(rng.uniform(0, 2 * np.pi))],
            instruction=instruction(instruction_text="walk forward", instruction_tokens=[2, 6, 9, 3]),
            goals=[goal_cls(position=[float(x) for x in goal], radius=3.0)],
            reference_path=[[float(x) for x in start], [float(x) for x in goal]],
            info={"geodesic_distance": float(np.hypot(*(start - goal)[[0, 2]]))},
        ))
    return eps


def test_scan_eval_on_imported_scenes_matches_jax():
    """Greedy scan eval of R2R CMA over three episodes on each imported
    scene (SCAN_BATCH 3: one chunk per grid size, each its own segment)."""
    graphs = _register_both()
    loop = ["TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", 8, "EVAL.SCAN_BATCH", 3, "EVAL.SCAN_SEGMENT", 4,
            "EVAL.SAMPLE", False]
    (jax_policy, params), policy, (jcfg, cfg) = build_r2r_pair(seed=1, extra=loop)
    head = params["action_distribution"]
    head["kernel"] = (head["kernel"] * 30.0).astype(np.float32)
    head["bias"] = np.asarray([6.0, 3.0, 1.5, 1.5], np.float32)
    jax_policy.params = params
    policy.load_state_dict(state_dict_from_jax_params(params), strict=True)
    eps, jeps = [], []
    for scene_id, graph in graphs.items():
        eps += _lattice_episodes(scene_id, graph, 3, np.random.RandomState(len(eps)))
        jeps += _lattice_episodes(scene_id, graph, 3, np.random.RandomState(len(jeps)),
                                  (JaxVLNEpisode, JaxInstructionData, JaxNavigationGoal))

    want = jax_scan.run_scan_rollouts(jax_policy, [], jcfg, jeps, jax.random.PRNGKey(0))
    stats = {}
    got = scan_eval.run_scan_rollouts(policy, [], cfg, eps, stats=stats)
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert any((a == 1).any() for a in got) and len({len(a) for a in got}) > 1
    for scene_id in SCENES:
        scene = get_scene(scene_id)
        assert isinstance(scene, si.ImportedScene) and scene.origin != (0.0, 0.0)
    assert stats["env_steps"] == sum(len(a) for a in got) and stats["readbacks"] == stats["segments"] >= 2

    jm = jax_scan.metrics_from_actions(jcfg, jeps, want)
    m = scan_eval.metrics_from_actions(cfg, eps, got)
    assert list(m) == list(jm)
    for ep_id, ep_stats in m.items():
        assert ep_stats["distance_to_goal"] < 64.0
        for k, v in ep_stats.items():
            np.testing.assert_allclose(v, jm[ep_id][k], rtol=0, atol=1e-6, err_msg=f"{ep_id} {k}")


def _run_jax_script(monkeypatch, module, argv):
    monkeypatch.setattr(sys, "argv", [module.__file__] + [str(a) for a in argv])
    module.main()


def test_export_cli_matches_jax_script(tmp_path, monkeypatch):
    import scripts.export_scene_geometry as jax_export
    from vlnce_torch.scripts.export_scene_geometry import main

    graphs = {stem: _offset_graph(dx, dz, world) for stem, (dx, dz, world) in
              zip(("17DRP5sb8fy", "zsNo4HB9uLZ"), SCENES.values())}
    with open(tmp_path / "graphs.pkl", "wb") as f:
        pickle.dump(graphs, f)
    args = ["--connectivity", tmp_path / "graphs.pkl", "--corridor-radius", 0.6]
    _run_jax_script(monkeypatch, jax_export, ["--out-dir", tmp_path / "jax"] + args)
    main([str(a) for a in ["--out-dir", tmp_path / "port"] + args])
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) == ["17DRP5sb8fy.npz", "zsNo4HB9uLZ.npz"]
    for name in os.listdir(tmp_path / "jax"):
        with np.load(tmp_path / "jax" / name) as a, np.load(tmp_path / "port" / name) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name} {k}")
    # `--habitat` runs since the adapter came (tests/test_torch_habitat_adapter.py);
    # like the JAX script it needs --exp-config to name the dataset's scenes
    for run in (lambda argv: _run_jax_script(monkeypatch, jax_export, argv), main):
        with pytest.raises(SystemExit, match="--habitat requires --exp-config"):
            run(["--out-dir", str(tmp_path / "h"), "--habitat"])


def test_generate_feature_bank_cli_matches_jax_script(tmp_path, monkeypatch):
    """Both CLIs over the synthetic split's scenes, exported as imported
    geometry and banked at their graph nodes, with one JAX checkpoint as the
    policy of both (the port reads the JAX file)."""
    import scripts.generate_feature_bank as jax_bank
    from vlnce_tpu.tasks.datasets import make_dataset as jax_make_dataset
    from vlnce_tpu.utils.checkpoints import save_checkpoint as jax_save_checkpoint
    from vlnce_torch.scripts.generate_feature_bank import graph_nodes, main

    common = ["TASK_CONFIG.DATASET.NUM_EPISODES", 2, "TASK_CONFIG.DATASET.NUM_SCENES", 2]
    (_, params), _, (jcfg, _) = build_r2r_pair(seed=2, extra=common)
    ckpt = str(tmp_path / "ckpt.0.ckpt")
    jax_save_checkpoint(ckpt, params, config=jcfg)
    stems = sorted({si._scene_stem(e.scene_id)
                    for e in jax_make_dataset(jcfg.TASK_CONFIG.DATASET.TYPE, jcfg.TASK_CONFIG.DATASET).episodes})
    graphs = {stem: _offset_graph(-3.0 + 4 * k, 7.0, 8.0) for k, stem in enumerate(stems)}
    with open(tmp_path / "graphs.pkl", "wb") as f:
        pickle.dump(graphs, f)
    for stem, g in graphs.items():
        si.save_scene_geometry(str(tmp_path / "geo" / f"{stem}.npz"), si.scene_from_graph(stem, g))
    opts = R2R_SMALL_OPTS + common + [
        "TASK_CONFIG.DATASET.TYPE", "Synthetic-VLN-v0", "TASK_CONFIG.SIMULATOR.GEOMETRY_DIR", str(tmp_path / "geo"),
        "IL.load_from_ckpt", True, "IL.ckpt_to_load", ckpt, "TENSORBOARD_DIR", "", "LOG_FILE", ""]
    args = ["--headings", 4, "--chunk", 16, "--connectivity", tmp_path / "graphs.pkl"]
    _run_jax_script(monkeypatch, jax_bank, ["--exp-config", JAX_R2R_CMA, "--bank-dir", tmp_path / "jax"] + args + opts + [
        "TPU.PRECISION.compute_dtype", "float32"])
    main([str(a) for a in ["--exp-config", R2R_CMA, "--bank-dir", tmp_path / "port"] + args + opts + [
        "CUDA.DEVICE", "cpu", "CUDA.PRECISION.compute_dtype", "float32"]])
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) == [f"{s}.npz" for s in stems]
    for stem in stems:
        with np.load(tmp_path / "jax" / f"{stem}.npz") as a, np.load(tmp_path / "port" / f"{stem}.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            np.testing.assert_array_equal(b["node_pos"], a["node_pos"])
            np.testing.assert_array_equal(b["node_pos"], graph_nodes(graphs[stem]))
            for k in ("rgb_features", "depth_features"):
                assert b[k].dtype == a[k].dtype == np.float16 and b[k].shape == a[k].shape
                # 1e-4 before the files round to f16: one f16 spacing more here
                got, want = b[k].astype(np.float32), a[k].astype(np.float32)
                tol = 1e-4 + np.spacing(np.abs(a[k])).astype(np.float32)
                assert (np.abs(got - want) <= tol).all(), (k, float(np.abs(got - want).max()))
            for k in ("num_headings", "rgb_shape", "depth_shape"):
                np.testing.assert_array_equal(b[k], a[k])
        assert isinstance(get_scene(f"synthetic/{stem}.glb"), si.ImportedScene)


@pytest.mark.parametrize("loop,source", [
    ("host_eval", "CONNECTIVITY_GRAPHS"), ("scan_inference", "GEOMETRY_DIR"),
    ("device_dagger", "CONNECTIVITY_GRAPHS"), ("dagger_resident", "GEOMETRY_DIR"),
])
def test_loops_run_on_imported_scenes(tmp_path, monkeypatch, loop, source):
    """The loops that the other files' imported-scene cases leave out, each
    through `run_exp` of R2R CMA on every scene of its split imported, from
    an export directory or from a connectivity pickle: the host eval loop
    (in-process envs), scan inference, DAgger collection on the card, and
    DAgger with the trajectory bank on the card. (The scan eval, recollection
    wire and resident, and the DD-PPO rollout run on imported scenes in
    tests/test_torch_eval.py, tests/test_torch_recollection.py and
    tests/test_torch_package.py.)"""
    from vlnce_torch.run import run_exp
    from vlnce_torch.tasks.datasets import make_dataset

    from tests.torch_port_cases import assert_imported, export_synthetic_geometry

    monkeypatch.setenv("VLNCE_TORCH_THREADED_ENVS", "1")
    opts = R2R_SMALL_OPTS + [
        "CUDA.DEVICE", "cpu", "CUDA.PRECISION.compute_dtype", "float32", "TASK_CONFIG.DATASET.NUM_EPISODES", 4,
        "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", 6, "NUM_ENVIRONMENTS", 2, "LOG_FILE", "", "VERBOSE", False,
        "EVAL.SPLIT", "val_unseen", "EVAL.EPISODE_COUNT", 2, "EVAL.USE_CKPT_CONFIG", False,
        "INFERENCE.SPLIT", "val_unseen", "INFERENCE.USE_CKPT_CONFIG", False, "INFERENCE.ON_DEVICE_SCAN", True,
        "INFERENCE.PREDICTIONS_FILE", str(tmp_path / "predictions.json"), "EVAL.SCAN_BATCH", 2, "EVAL.SCAN_SEGMENT", 4,
        "RESULTS_DIR", str(tmp_path / "evals"), "EVAL_CKPT_PATH_DIR", str(tmp_path / "none.pth"),
        "INFERENCE.CKPT_PATH", str(tmp_path / "none.pth"), "CHECKPOINT_FOLDER", str(tmp_path / "ckpts"),
        "CUDA.ON_DEVICE_DAGGER", True, "CUDA.DAGGER_SEGMENT", 4, "CUDA.DAGGER_RESIDENT", loop == "dagger_resident",
        "IL.epochs", 1, "IL.batch_size", 2, "IL.DAGGER.iterations", 1, "IL.DAGGER.update_size", 2,
        "IL.load_from_ckpt", False, "IL.DAGGER.lmdb_features_dir", str(tmp_path / "traj"),
    ]
    split = "train" if "dagger" in loop else "val_unseen"
    dataset = get_config(R2R_CMA, opts + ["TASK_CONFIG.DATASET.SPLIT", split]).TASK_CONFIG.DATASET
    scene_ids = {e.scene_id for e in make_dataset(dataset.TYPE, dataset).episodes}
    if source == "GEOMETRY_DIR":
        export_synthetic_geometry(str(tmp_path / "geometry"), scene_ids)
        opts += ["TASK_CONFIG.SIMULATOR.GEOMETRY_DIR", str(tmp_path / "geometry")]
    else:
        with open(tmp_path / "graphs.pkl", "wb") as f:
            pickle.dump({si._scene_stem(s): nav_graph.LatticeGraph(-2.0, -2.0, 20.0, 20.0, 1.0) for s in scene_ids}, f)
        opts += ["TASK_CONFIG.SIMULATOR.CONNECTIVITY_GRAPHS", str(tmp_path / "graphs.pkl")]
    run_type = {"host_eval": "eval", "scan_inference": "inference"}.get(loop, "train")
    trainer = run_exp(R2R_CMA, run_type, opts)
    assert_imported(scene_ids)
    if loop == "host_eval":
        assert (tmp_path / "evals" / "stats_ckpt_0_val_unseen.json").exists() and trainer.last_loop_timing["env_steps"] > 0
    elif loop == "scan_inference":
        assert (tmp_path / "predictions.json").exists() and trainer.last_loop_timing["env_steps"] > 0
    else:
        assert trainer.collection_stats[0]["episodes"] == 2 and (tmp_path / "ckpts" / "ckpt.0.ckpt").exists()
