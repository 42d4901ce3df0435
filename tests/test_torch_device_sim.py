"""The port's device-resident grid world (vlnce_torch/envs/device_sim.py)
against the JAX package's (vlnce_tpu/envs/device_sim.py), function by
function, on the same seeded numpy inputs.

The JAX functions take one env and are vmapped here; the port's take the
env axis first. Tolerances: positions and headings after 40 mixed actions,
and `step_filter` with sliding, atol 1e-5; depth atol 1e-4 and RGB with
|diff| > 1 on under 0.5% of the pixels (f32 tan / atan and the wall edges'
row tests may round apart); `progress_batch` atol 1e-6; the expert's action
equal at every pose whose steering angle is farther than 1e-5 rad from a
threshold; `waypoint_step`, `waypoint_reward` and `snap_point` atol 1e-5;
the lookup, the scene arrays and the nearest-free maps exact.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlnce_tpu.config import get_config as jax_get_config
from vlnce_tpu.envs import device_sim as jds
from vlnce_torch.config import get_config
from vlnce_torch.envs import device_sim as ds
from vlnce_torch.envs.gridworld import GridWorldSim, get_scene
from vlnce_torch.tasks.geometry import quat_from_heading

import tests.torch_port_cases  # noqa: F401  (one intra-op thread)

SCENES = ("synth_scene_0", "synth_scene_1", "synth_scene_2")
FWD, TURN = 0.25, math.radians(15.0)


def _sim_configs(h=48, w=64):
    opts = [
        "TASK_CONFIG.SIMULATOR.RGB_SENSOR.HEIGHT", h, "TASK_CONFIG.SIMULATOR.RGB_SENSOR.WIDTH", w,
        "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.HEIGHT", h, "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.WIDTH", w,
    ]
    jcfg = jax_get_config("vlnce_tpu/config/experiments/rxr_baselines/rxr_cma_en.yaml", opts)
    cfg = get_config("vlnce_torch/config/experiments/rxr_baselines/rxr_cma_en.yaml", opts)
    return jcfg.TASK_CONFIG.SIMULATOR, cfg.TASK_CONFIG.SIMULATOR


def _grids(scene_ids, key="occupancy"):
    return np.stack([getattr(get_scene(s), key) for s in scene_ids])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _free_poses(rng, scene_id, n):
    occ = get_scene(scene_id).occupancy
    out = []
    while len(out) < n:
        x, z = rng.uniform(0.3, 15.7, 2)
        if not occ[int(x / 0.25), int(z / 0.25)]:
            out.append([x, 0.0, z, rng.uniform(0, 2 * math.pi)])
    return np.asarray(out, np.float32)


def test_camera_specs_match_jax():
    jsim, sim = _sim_configs()
    assert [tuple(s) for s in ds.camera_specs_from_config(sim)] == [tuple(s) for s in jds.camera_specs_from_config(jsim)]
    assert [s.kind for s in ds.camera_specs_from_config(sim)] == ["rgb", "depth"]


def test_lookup_is_an_exact_gather_for_every_grid_dtype():
    """The flattened gather equals grid[b, ci, cj] for bool occupancy, u8
    colors, int32 nearest maps and f32 fields holding inf, and the JAX
    package's one-hot lookup on the same points."""
    rng = np.random.RandomState(7)
    B, n = 3, 64
    ci = rng.randint(0, n, (B, 5, 33)).astype(np.int32)
    cj = rng.randint(0, n, (B, 5, 33)).astype(np.int32)
    f32_inf = rng.rand(B, n, n).astype(np.float32) * 37.0
    f32_inf[rng.rand(B, n, n) > 0.8] = np.inf
    grids = {
        "bool": rng.rand(B, n, n) > 0.6,
        "uint8": rng.randint(0, 256, (B, n, n)).astype(np.uint8),
        "int32": rng.randint(0, n, (B, n, n)).astype(np.int32),
        "f32_inf": f32_inf,
        "uint8_rgb": rng.randint(0, 256, (B, n, n, 3)).astype(np.uint8),
    }
    b = np.arange(B)[:, None, None]
    for name, g in grids.items():
        got = ds._lookup(_t(g), _t(ci), _t(cj)).numpy()
        assert got.dtype == g.dtype, name
        np.testing.assert_array_equal(got, g[b, ci, cj], err_msg=name)
        if g.ndim == 3:
            jax_vals = np.stack([np.asarray(jds._grid_lookup(jnp.asarray(g[k]), jnp.asarray(ci[k]), jnp.asarray(cj[k]))) for k in range(B)])
            np.testing.assert_array_equal(got.astype(np.float32), jax_vals, err_msg=name)


def _episode(scene_id, start, goals, d0=None):
    class Goal:
        def __init__(self, p):
            self.position = p

    class Ep:
        pass

    ep = Ep()
    ep.scene_id, ep.start_position = scene_id, start
    ep.goals = [Goal(g) for g in goals]
    ep.info = {"geodesic_distance": d0} if d0 else {}
    return ep


def test_scene_batch_matches_jax():
    eps = [
        _episode("synth_scene_0", [1.5, 0.0, 1.5], [[7.5, 0.0, 7.5]]),
        _episode("synth_scene_1", [3.0, 0.0, 9.0], [[13.5, 0.0, 13.5], [1.5, 0.0, 13.5]], d0=4.25),
    ]
    want = jds.build_scene_batch(eps)
    got = ds.build_scene_batch(eps)
    for field in jds.SceneBatch._fields:
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)), err_msg=field)
        assert getattr(got, field).numpy().dtype == np.asarray(getattr(want, field)).dtype, field


def test_dynamics_after_40_mixed_actions_match_jax():
    rng = np.random.RandomState(0)
    starts = np.array([[1.5, 0.0, 1.5], [7.5, 0.0, 3.5], [13.2, 0.0, 9.1]], np.float32)
    heading0 = np.array([0.7, 2.0, 5.5], np.float32)
    actions = rng.randint(1, 4, size=(40, 3))
    occ = _grids(SCENES)

    jstep = jax.jit(jax.vmap(lambda o, p, h, a: jds.step_discrete(o, p, h, a, FWD, TURN, True)))
    jpos, jhead = jnp.asarray(starts), jnp.asarray(heading0)
    pos, head = _t(starts), _t(heading0)
    occ_t = _t(occ)
    for a in actions:
        jpos, jhead = jstep(jnp.asarray(occ), jpos, jhead, jnp.asarray(a, jnp.int32))
        pos, head = ds.step_discrete(occ_t, pos, head, _t(a.astype(np.int32)), FWD, TURN, True)
    np.testing.assert_allclose(pos.numpy(), np.asarray(jpos), atol=1e-5)
    dh = (head.numpy() - np.asarray(jhead) + math.pi) % (2 * math.pi) - math.pi
    assert np.abs(dh).max() < 1e-5
    assert np.abs(pos.numpy() - starts).max() > 1.0  # the agents moved



def test_step_filter_with_sliding_matches_jax():
    """160 moves of 0.5 m in seeded directions from free cells next to a
    wall (n_steps 8), with and without sliding."""
    rng = np.random.RandomState(1)
    occ1 = get_scene("synth_scene_0").occupancy
    near_wall = [(i, j) for i, j in np.argwhere(~occ1) if occ1[max(i - 2, 0) : i + 3, max(j - 2, 0) : j + 3].any()]
    cells = np.asarray(near_wall)[rng.randint(len(near_wall), size=160)]
    starts = np.stack([(cells[:, 0] + rng.uniform(0.1, 0.9, 160)) * 0.25, np.zeros(160),
                       (cells[:, 1] + rng.uniform(0.1, 0.9, 160)) * 0.25], axis=1).astype(np.float32)
    ang = rng.uniform(0, 2 * math.pi, 160)
    ends = (starts + 0.5 * np.stack([np.cos(ang), np.zeros(160), np.sin(ang)], axis=1)).astype(np.float32)
    occ = np.repeat(occ1[None], 160, axis=0)
    for sliding in (True, False):
        want = jax.jit(jax.vmap(lambda o, s, e: jds.step_filter(o, s, e, 8, sliding)))(jnp.asarray(occ), jnp.asarray(starts), jnp.asarray(ends))
        got = ds.step_filter(_t(occ), _t(starts), _t(ends), 8, sliding)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    slid = np.abs(got.numpy() - ds.step_filter(_t(occ), _t(starts), _t(ends), 8, True).numpy()).max(axis=1) > 1e-6
    blocked = np.abs(got.numpy() - ends).max(axis=1) > 1e-6
    assert slid.sum() > 10 and blocked.sum() > 20  # moves were blocked, and some of them slid


def test_step_tilt_matches_jax():
    tilt = np.array([0.0, 0.9, -0.9, 0.3, 1.0, -1.0], np.float32)
    action = np.array([4, 4, 5, 1, 4, 5], np.int32)
    want = jds.step_tilt(jnp.asarray(tilt), jnp.asarray(action), math.radians(30.0))
    got = ds.step_tilt(_t(tilt), _t(action), math.radians(30.0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("tilted", [False, True])
def test_render_matches_jax(tilted):
    """Every camera of the RxR config at 48x64, at 12 seeded poses over three
    scenes; with `tilted`, the LOOK_UP / DOWN horizon shift."""
    jsim, sim = _sim_configs()
    specs = ds.camera_specs_from_config(sim)
    jspecs = jds.camera_specs_from_config(jsim)
    rng = np.random.RandomState(3)
    scene_ids = [SCENES[k % 3] for k in range(12)]
    poses = np.concatenate([_free_poses(rng, s, 1) for s in scene_ids])
    tilt = rng.uniform(-1.0, 1.0, 12).astype(np.float32) if tilted else None
    arrays = {k: _grids(scene_ids, k) for k in ("occupancy", "wall_colors")}
    floor = np.stack([get_scene(s).floor_color for s in scene_ids])
    ceil = np.stack([get_scene(s).ceil_color for s in scene_ids])
    render = jax.jit(lambda o, w, f, c, p, h, t: jds.render_arrays(o, w, f, c, p, h, jspecs, tilt=t))
    want = render(
        jnp.asarray(arrays["occupancy"]), jnp.asarray(arrays["wall_colors"]), jnp.asarray(floor), jnp.asarray(ceil),
        jnp.asarray(poses[:, :3]), jnp.asarray(poses[:, 3]), None if tilt is None else jnp.asarray(tilt))
    got = ds.render_arrays(
        _t(arrays["occupancy"]), _t(arrays["wall_colors"]), _t(floor), _t(ceil), _t(poses[:, :3]), _t(poses[:, 3]),
        specs, tilt=None if tilt is None else _t(tilt))
    assert sorted(got) == sorted(want) == ["depth", "rgb"]
    for spec in specs:
        g, w = got[spec.uuid].numpy(), np.asarray(want[spec.uuid])
        assert g.shape == w.shape == (12, 48, 64, 3 if spec.kind == "rgb" else 1) and g.dtype == w.dtype
        if spec.kind == "depth":
            np.testing.assert_allclose(g, w, atol=1e-4)
        else:
            frac = float((np.abs(g.astype(int) - w.astype(int)) > 1).mean())
            assert frac < 0.005, f"{frac:.4f} of the RGB pixels differ by more than 1"
            assert len(np.unique(g)) > 20  # walls, floors and ceilings were drawn


def test_render_matches_the_host_renderer():
    """The frames against GridWorldSim.get_observations_at in f64 at the
    JAX package's own tolerance (tests/test_device_sim.py)."""
    _, sim_cfg = _sim_configs()
    specs = ds.camera_specs_from_config(sim_cfg)
    sim = GridWorldSim(sim_cfg)
    sim.reconfigure("synth_scene_0")
    scene = get_scene("synth_scene_0")
    poses = np.array([[1.5, 0.0, 1.5, 0.0], [7.5, 0.0, 7.5, 1.2], [3.1, 0.0, 11.0, 4.0]], np.float32)
    got = ds.render_arrays(_t(scene.occupancy[None].repeat(3, 0)), _t(scene.wall_colors[None].repeat(3, 0)),
                           _t(scene.floor_color[None].repeat(3, 0)), _t(scene.ceil_color[None].repeat(3, 0)),
                           _t(poses[:, :3]), _t(poses[:, 3]), specs)
    for b, pose in enumerate(poses):
        host = sim.get_observations_at(pose[:3].astype(np.float64), quat_from_heading(float(pose[3])))
        np.testing.assert_allclose(got["depth"][b].numpy(), host["depth"], atol=1e-3)
        diff = np.abs(got["rgb"][b].numpy().astype(int) - host["rgb"].astype(int))
        assert float((diff > 1).mean()) < 0.02


def test_progress_batch_matches_jax():
    rng = np.random.RandomState(5)
    eps = [_episode(s, [1.5, 0.0, 1.5], [[13.5, 0.0, 13.5]]) for s in SCENES]
    eps.append(_episode("synth_scene_0", [1.5, 0.0, 1.5], [[7.5, 0.0, 7.5]], d0=9.0))
    pos = np.concatenate([_free_poses(rng, e.scene_id, 1)[:, :3] for e in eps])
    want = jds.progress_batch(jds.build_scene_batch(eps), jnp.asarray(pos))
    got = ds.progress_batch(ds.build_scene_batch(eps), _t(pos))
    assert got.shape == (4, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_expert_action_matches_jax():
    """The device expert at 600 seeded free poses over three scenes. A pose
    whose steering angle lies within 1e-5 rad of a threshold (the forward
    cone's edge, or the left / right switch at +-pi) may round apart in f32
    and is skipped; the test counts them."""
    rng = np.random.RandomState(11)
    goals = {s: [13.5, 0.0, 13.5] if s != "synth_scene_1" else [1.5, 0.0, 13.5] for s in SCENES}
    scene_ids = [SCENES[k % 3] for k in range(600)]
    poses = np.concatenate([_free_poses(rng, s, 1) for s in scene_ids])
    fields, goal_xz = [], []
    for s in scene_ids:
        scene = get_scene(s)
        g = goals[s]
        fields.append(scene.distance_field(scene.world_to_cell(g[0], g[2])).astype(np.float32))
        goal_xz.append([g[0], g[2]])
    occ, fields, goal_xz = _grids(scene_ids), np.stack(fields), np.asarray(goal_xz, np.float32)

    want = np.asarray(jax.jit(jax.vmap(lambda o, f, g, p, h: jds.expert_action(o, f, g, p, h, 0.5, TURN)))(
        jnp.asarray(occ), jnp.asarray(fields), jnp.asarray(goal_xz), jnp.asarray(poses[:, :3]), jnp.asarray(poses[:, 3])))
    got = ds.expert_action(_t(occ), _t(fields), _t(goal_xz), _t(poses[:, :3]), _t(poses[:, 3]), 0.5, TURN)
    assert got.dtype == torch.int32

    # the steering angle each side computes, to find the poses on a threshold
    def steering(p, h, target):
        desired = math.atan2(-(target[0] - p[0]), -(target[1] - p[2])) % (2 * math.pi)
        return (desired - h + math.pi) % (2 * math.pi) - math.pi

    targets = _expert_targets(occ, fields, goal_xz, poses)
    thr = TURN / 2.0 + 1e-6
    near = np.array([min(abs(abs(d) - thr), abs(abs(d) - math.pi)) < 1e-5
                     for d in (steering(p, h, t) for p, h, t in zip(poses[:, :3], poses[:, 3], targets))])
    ok = got.numpy() == want
    assert ok[~near].all(), f"{int((~ok[~near]).sum())} of {int((~near).sum())} expert actions differ off a threshold"
    assert near.sum() <= 3, f"{int(near.sum())} poses skipped on a threshold"
    assert set(np.unique(want)) == {0, 1, 2, 3}


def _expert_targets(occ, fields, goal_xz, poses):
    """The host follower's target point of each pose (the first descent cell
    farther than 0.125 m, else the goal), in f64."""
    out = []
    for o, f, g, p in zip(occ, fields, goal_xz, poses):
        i, j = min(int(p[0] / 0.25), 63), min(int(p[2] / 0.25), 63)
        target = None
        for _ in range(8):
            if not f[i, j] > 0.25:
                break
            best, best_d = None, f[i, j]
            for di in (-1, 0, 1):
                for dj in (-1, 0, 1):
                    ni, nj = i + di, j + dj
                    if 0 <= ni < 64 and 0 <= nj < 64 and not o[ni, nj] and f[ni, nj] < best_d:
                        best, best_d = (ni, nj), f[ni, nj]
            if best is None:
                break
            i, j = best
            c = ((i + 0.5) * 0.25, (j + 0.5) * 0.25)
            if math.hypot(c[0] - p[0], c[1] - p[2]) > 0.125:
                target = c
                break
        out.append(target if target is not None else (g[0], g[1]))
    return out


def test_nearest_free_cells_and_snap_point_match_jax():
    scene_ids = list(SCENES) * 4
    maps = np.stack([ds.nearest_free_cell_map(s) for s in scene_ids])
    for s in SCENES:
        np.testing.assert_array_equal(ds.nearest_free_cell_map(s), jds.nearest_free_cells(get_scene(s).occupancy))
    rng = np.random.RandomState(9)
    pos = np.stack([[rng.uniform(0, 16), 0.3, rng.uniform(0, 16)] for _ in scene_ids]).astype(np.float32)
    occ = _grids(scene_ids)
    want = jax.jit(jax.vmap(jds.snap_point))(jnp.asarray(occ), jnp.asarray(maps), jnp.asarray(pos))
    got = ds.snap_point(_t(occ), _t(maps), _t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert (got.numpy()[:, 1] == 0.0).any() and (got.numpy()[:, 1] == np.float32(0.3)).any()


@pytest.mark.parametrize("rotate_agent,allow_sliding", [(False, True), (True, False)])
def test_waypoint_step_and_reward_match_jax(rotate_agent, allow_sliding):
    rng = np.random.RandomState(13)
    scene_ids = [SCENES[k % 3] for k in range(24)]
    poses = np.concatenate([_free_poses(rng, s, 1) for s in scene_ids])
    r = rng.uniform(0.0, 2.5, 24).astype(np.float32)
    r[0] = 0.0
    theta = rng.uniform(-math.pi, math.pi, 24).astype(np.float32)
    occ, maps = _grids(scene_ids), np.stack([ds.nearest_free_cell_map(s) for s in scene_ids])
    max_samples = 48
    jpos, jhead = jax.jit(jax.vmap(lambda o, m, p, h, rr, th: jds.waypoint_step(o, m, p, h, rr, th, rotate_agent, max_samples, allow_sliding)))(
        jnp.asarray(occ), jnp.asarray(maps), jnp.asarray(poses[:, :3]), jnp.asarray(poses[:, 3]), jnp.asarray(r), jnp.asarray(theta))
    pos, head = ds.waypoint_step(_t(occ), _t(maps), _t(poses[:, :3]), _t(poses[:, 3]), _t(r), _t(theta), rotate_agent,
                                 max_samples, allow_sliding)
    np.testing.assert_allclose(pos.numpy(), np.asarray(jpos), rtol=0, atol=1e-5)
    np.testing.assert_allclose(head.numpy(), np.asarray(jhead), rtol=0, atol=1e-5)
    assert np.abs(pos.numpy() - poses[:, :3]).max() > 0.5

    eps = [_episode(s, [1.5, 0.0, 1.5], [[13.5, 0.0, 13.5]]) for s in scene_ids]
    field = ds.build_scene_batch(eps).goal_field
    prev_d = rng.uniform(0.0, 20.0, 24).astype(np.float32)
    prev_d[3] = np.inf
    stop = rng.rand(24) > 0.5
    kw = dict(slack_reward=-0.05, use_distance_scaled_slack_reward=True, scale_slack_on_prediction=True,
              success_reward=2.5, distance_scalar=1.0, success_distance=3.0)
    want = jax.jit(jax.vmap(lambda f, d, xz, p, rr, s: jds.waypoint_reward(f, d, xz, p, rr, s, **kw)))(
        jnp.asarray(field.numpy()), jnp.asarray(prev_d), jnp.asarray(poses[:, [0, 2]]), jpos, jnp.asarray(r), jnp.asarray(stop))
    got = ds.waypoint_reward(field, _t(prev_d), _t(poses[:, [0, 2]]), pos, _t(r), _t(stop), **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)


def test_upload_round_trips_every_dtype():
    rng = np.random.RandomState(2)
    arrays = {"b": rng.rand(3, 5) > 0.5, "u8": rng.randint(0, 255, (7,)).astype(np.uint8),
              "i32": rng.randint(-9, 9, (2, 3)).astype(np.int32), "f32": rng.randn(4, 1).astype(np.float32)}
    out = ds.upload(arrays, "cpu")
    for k, v in arrays.items():
        assert out[k].numpy().dtype == v.dtype and np.array_equal(out[k].numpy(), v), k
