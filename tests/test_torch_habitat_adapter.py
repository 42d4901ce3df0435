"""The twelve cases of `tests/test_habitat_adapter.py`, run against both
packages' HabitatSimAdapter on one shared stand-in habitat_sim module (the
one that file builds: the tests run without habitat_sim), and
`export_scene_geometry --habitat` of both packages on it, whose npz files
must be equal."""

from __future__ import annotations

import importlib
import math
import os
import sys
import types

import numpy as np
import pytest

from tests.test_habitat_adapter import _build_fake_module, _FakeSim

PKGS = ["vlnce_tpu", "vlnce_torch"]


def _mod(pkg, name):
    if pkg == "vlnce_torch":
        import vlnce_torch.config  # noqa: F401  (before the task config: the two import each other)
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(params=PKGS)
def adapter(request, monkeypatch):
    """(package, its HabitatSimAdapter) with the stand-in habitat_sim."""
    pkg = request.param
    monkeypatch.setitem(sys.modules, "habitat_sim", _build_fake_module())
    ha = _mod(pkg, "envs.habitat_adapter")
    importlib.reload(ha)
    assert ha.HABITAT_SIM_AVAILABLE
    yield pkg, ha.HabitatSimAdapter
    monkeypatch.delitem(sys.modules, "habitat_sim", raising=False)
    importlib.reload(ha)


def _sim_config(pkg, task_yaml="vlnce_task.yaml", **overrides):
    opts = [
        "BASE_TASK_CONFIG_PATH", f"{pkg}/tasks/config/{task_yaml}",
        "TASK_CONFIG.SIMULATOR.RGB_SENSOR.HEIGHT", 8, "TASK_CONFIG.SIMULATOR.RGB_SENSOR.WIDTH", 8,
        "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.HEIGHT", 8, "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.WIDTH", 8,
    ]
    for k, v in overrides.items():
        opts += [f"TASK_CONFIG.SIMULATOR.{k}", v]
    return _mod(pkg, "config").get_config(opts=opts).TASK_CONFIG.SIMULATOR


def _started(adapter, scene="mp3d/scene1.glb", **kw):
    pkg, cls = adapter
    sim = cls(_sim_config(pkg, **kw))
    sim.reconfigure(scene)
    sim.reset()
    return sim


def test_adapter_full_protocol(adapter):
    sim = _started(adapter)
    obs = sim.reset()
    assert obs["rgb"].shape == (8, 8, 3) and obs["rgb"].dtype == np.uint8
    assert obs["depth"].shape == (8, 8, 1) and obs["depth"].dtype == np.float32
    np.testing.assert_allclose(obs["depth"], 0.75)
    sim.set_agent_state([0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0])
    sim.step(1)
    np.testing.assert_allclose(sim.get_agent_state().position, [0.0, 0.0, -0.25], atol=1e-6)
    sim.step(2)
    q = sim.get_agent_state().rotation
    assert abs(q[3]) < 1.0 and q[1] != 0.0
    pos_before = sim.get_agent_state().position
    sim.step(0)
    np.testing.assert_allclose(sim.get_agent_state().position, pos_before)
    assert sim.is_navigable([1.0, 0.0, 1.0]) and not sim.is_navigable([11.0, 0.0, 1.0])
    np.testing.assert_allclose(sim.snap_point([12.0, 0.0, 3.0]), [10.0, 0.0, 3.0])
    assert abs(sim.geodesic_distance([0.0, 0.0, 0.0], [3.0, 0.0, 4.0]) - 5.0) < 1e-6
    assert abs(sim.geodesic_distance([0.0, 0.0, 0.0], [[3.0, 0.0, 4.0], [0.0, 0.0, 1.0]]) - 1.0) < 1e-6
    pts = sim.get_straight_shortest_path_points([0.0, 0.0, 0.0], [2.0, 0.0, 0.0])
    assert len(pts) == 3 and pts[-1] == [2.0, 0.0, 0.0]
    np.testing.assert_allclose(sim.step_filter([0.0, 0.0, 0.0], [15.0, 0.0, 0.0]), [10.0, 0.0, 0.0])
    before = sim.get_agent_state()
    assert sim.get_observations_at([5.0, 0.0, 5.0], [0.0, 0.0, 0.0, 1.0])["rgb"].shape == (8, 8, 3)
    np.testing.assert_allclose(sim.get_agent_state().position, before.position)
    sim.get_observations_at([5.0, 0.0, 5.0], [0.0, 0.0, 0.0, 1.0], keep_agent_at_new_pose=True)
    np.testing.assert_allclose(sim.get_agent_state().position, [5.0, 0.0, 5.0])
    n_created = len(_FakeSim.created)
    sim.reconfigure("mp3d/scene1.glb")
    assert len(_FakeSim.created) == n_created
    sim.reconfigure("mp3d/scene2.glb")
    assert len(_FakeSim.created) == n_created + 1 and _FakeSim.created[-2]._closed
    sim.seed(3)
    sim.close()
    assert _FakeSim.created[-1]._closed


def test_adapter_registers_in_registry(adapter):
    pkg, cls = adapter
    assert _mod(pkg, "registry").registry.get_simulator("HabitatSim-v0") is cls


def test_heading_accumulates_and_wraps(adapter):
    heading = _mod(adapter[0], "tasks.geometry").heading_from_quaternion
    sim = _started(adapter, TURN_ANGLE=30)
    sim.set_agent_state([0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0])
    turn = math.radians(30.0)
    for i in range(1, 13):
        sim.step(2)
        q = sim.get_agent_state().rotation
        got = heading(q)
        assert abs(((got - (i * turn) % (2 * math.pi) + math.pi) % (2 * math.pi)) - math.pi) < 1e-5, (i, got)
        if math.pi < i * turn < 2 * math.pi:
            assert q[3] < 0.0
        assert abs(heading(-np.asarray(q)) - got) < 1e-6
    assert min(got, 2 * math.pi - got) < 1e-5
    sim.close()


def test_turn_right_is_negative_y_rotation(adapter):
    heading = _mod(adapter[0], "tasks.geometry").heading_from_quaternion
    sim = _started(adapter, TURN_ANGLE=15)
    sim.set_agent_state([0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0])
    sim.step(3)
    assert abs(heading(sim.get_agent_state().rotation) - (2 * math.pi - math.radians(15.0))) < 1e-5
    sim.close()


def test_snap_point_nans_off_mesh(adapter):
    sim = _started(adapter)
    np.testing.assert_allclose(sim.snap_point([11.5, 0.0, 3.0]), [10.0, 0.0, 3.0])
    assert np.all(np.isnan(sim.snap_point([50.0, 0.0, 3.0])))
    sim.close()


def test_geodesic_distance_inf_to_disconnected_island(adapter):
    sim = _started(adapter)
    assert math.isinf(sim.geodesic_distance([0.0, 0.0, 0.0], [200.0, 0.0, 0.0]))
    assert abs(sim.geodesic_distance([0.0, 0.0, 0.0], [[200.0, 0.0, 0.0], [0.0, 0.0, 2.0]]) - 2.0) < 1e-6
    assert sim.get_straight_shortest_path_points([0.0, 0.0, 0.0], [200.0, 0.0, 0.0]) == []
    sim.close()


def _go_toward_point(pkg, sim):
    return _mod(pkg, "tasks.actions").GoTowardPoint(config=types.SimpleNamespace(rotate_agent=False), sim=sim, task=None)


def test_step_filter_slides_with_sliding_enabled(adapter):
    sim = _started(adapter)
    np.testing.assert_allclose(sim.step_filter([9.0, 0.0, 0.0], [15.0, 0.0, -4.0]), [10.0, 0.0, -4.0])
    sim.close()


def test_step_filter_reverts_without_sliding(adapter):
    sim = _started(adapter, task_yaml="vlnce_waypoint_task.yaml")
    np.testing.assert_allclose(sim.step_filter([9.0, 0.0, 0.0], [15.0, 0.0, -4.0]), [9.0, 0.0, 0.0])
    np.testing.assert_allclose(sim.step_filter([0.0, 0.0, 0.0], [1.0, 0.0, -1.0]), [1.0, 0.0, -1.0])
    sim.close()


def test_go_toward_point_filters_before_snapping(adapter):
    sim = _started(adapter)
    sim.set_agent_state([0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0])
    sim._sim.calls.clear()
    _go_toward_point(adapter[0], sim).step(r=2.0, theta=0.0)
    assert [c for c in sim._sim.calls if c in ("step_filter", "snap_point")] == ["step_filter", "snap_point"]
    np.testing.assert_allclose(sim.get_agent_state().position, [0.0, 0.0, -2.0], atol=1e-5)
    sim.close()


def test_go_toward_point_keeps_pose_when_snap_nans(adapter):
    sim = _started(adapter)
    sim.set_agent_state([9.0, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0])
    orig_filter = sim._sim.step_filter
    sim._sim.step_filter = lambda s, e: np.array([50.0, 0.0, 0.0], np.float32)
    try:
        _go_toward_point(adapter[0], sim).step(r=4.0, theta=math.pi / 2)
        np.testing.assert_allclose(sim.get_agent_state().position, [9.0, 0.0, 0.0])
    finally:
        sim._sim.step_filter = orig_filter
    orig_snap = sim._sim.pathfinder.snap_point
    sim._sim.pathfinder.snap_point = lambda p: np.full(3, np.nan, np.float32)
    try:
        _go_toward_point(adapter[0], sim).step(r=2.0, theta=0.0)
        np.testing.assert_allclose(sim.get_agent_state().position, [9.0, 0.0, 0.0])
    finally:
        sim._sim.pathfinder.snap_point = orig_snap
    sim.close()


def test_scene_from_habitat_faked_navmesh(adapter):
    pkg = adapter[0]
    si = _mod(pkg, "envs.scene_import")
    sim = _started(adapter, scene="mp3d/FAKE/FAKE.glb")
    scene = si.scene_from_habitat("FAKE", sim._sim)
    pf = sim._sim.pathfinder
    for x, z, navigable in [(0.0, 0.0, True), (9.8, -7.0, True), (-9.8, 7.0, True),
                            (10.6, 0.0, False), (-10.6, 0.0, False)]:
        i, j = scene.world_to_cell(x, z)
        assert scene.navigable_cell(i, j) == navigable, (x, z)
        cx, cz = scene.cell_to_world(i, j)
        assert scene.navigable_cell(i, j) == bool(pf.is_navigable([cx, 0.0, cz]))
    lower, _ = pf.get_bounds()
    res = _mod(pkg, "envs.gridworld")._RES
    assert scene.origin[0] <= float(lower[0]) and scene.origin[1] <= float(lower[2])
    assert abs(scene.origin[0] / res - round(scene.origin[0] / res)) < 1e-9
    sim.close()


def _export(pkg, out_dir, monkeypatch):
    argv = ["--habitat", "--exp-config", f"{pkg}/config/experiments/synthetic/smoke_seq2seq.yaml",
            "--out-dir", out_dir, "TASK_CONFIG.DATASET.NUM_EPISODES", "2", "TASK_CONFIG.DATASET.NUM_SCENES", "1"]
    if pkg == "vlnce_tpu":
        from scripts.export_scene_geometry import main

        monkeypatch.setattr(sys, "argv", ["export_scene_geometry.py", *argv])
        main()
    else:
        from vlnce_torch.scripts.export_scene_geometry import main

        main(argv)


def test_export_scene_geometry_habitat_faked_backend(adapter, tmp_path, monkeypatch):
    """Both packages' `export_scene_geometry --habitat` on the stand-in
    backend write the same npz files, which the runtime loads."""
    pkg = adapter[0]
    _export(pkg, str(tmp_path / pkg), monkeypatch)
    other = PKGS[1 - PKGS.index(pkg)]
    monkeypatch.setitem(sys.modules, "habitat_sim", _build_fake_module())
    importlib.reload(_mod(other, "envs.habitat_adapter"))
    _export(other, str(tmp_path / other), monkeypatch)
    names = sorted(os.listdir(tmp_path / pkg))
    assert names and names == sorted(os.listdir(tmp_path / other))
    for name in names:
        with np.load(tmp_path / pkg / name) as a, np.load(tmp_path / other / name) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    scene = _mod(pkg, "envs.scene_import").load_scene_geometry(str(tmp_path / pkg / names[0]))
    assert scene.navigable_cell(*scene.world_to_cell(0.0, 0.0))
    assert not scene.navigable_cell(*scene.world_to_cell(10.6, 0.0))
    importlib.reload(_mod(other, "envs.habitat_adapter"))


def test_package_imports_without_habitat_sim():
    import vlnce_torch.envs.habitat_adapter as ha

    importlib.reload(ha)
    assert not ha.HABITAT_SIM_AVAILABLE
    from vlnce_torch.scripts.export_scene_geometry import main

    with pytest.raises(SystemExit, match="habitat_sim"):
        main(["--habitat", "--exp-config", "x.yaml", "--out-dir", "/nonexistent/unused"])
