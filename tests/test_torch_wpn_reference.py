"""The waypoint model's DD-PPO cell (`wpn.ddppo_train`) on the CPU at small
sizes in f32: the port against the benchmark's plain reference
(benchmark/reference/waypoint.py, ppo.py), which imports nothing of it, and
the cell's own pieces.

- `WaypointPolicy.evaluate_actions` in the sequence mode against the
  reference's forward: values, joint log-probabilities, each component's
  entropy (rtol 1e-4: both f32, different orders of summation).
- `device_sim.waypoint_step` / `waypoint_reward` (the rollout's step on
  the card, run eagerly here) against the plain step and reward at seeded
  poses and actions on the benchmark's procedural scenes.
- The episode bank's goal fields and d0 on the card route
  (`device_rollout.build_episode_queue`: one `goal_distance_fields` call)
  equal to the host Dijkstra's bit for bit, on procedural scenes and on
  imported ones of mixed sizes.
- The trainer's on-card update as the benchmark drives it
  (`start_device_rollout`, `train_update_on_device` through
  `benchmark/program.trainer_with_policy`) gives `train()`'s stats.
- The cell's runner at a small size (one build, one module fixture): its
  first update against the reference (each minibatch step's loss,
  gradient and change from the program's state before it, and the whole
  update's change: the reference follows the program to 1e-4), correct;
  with faults planted in the program (a step moved, the first row's pano
  drawn one further, TF32 switched on, half of each minibatch left out of
  training) not correct on the check that sees each; the generator; the
  control script's readings, in which the fp8 control, the moved pano and
  the half batch read not correct.
"""

import math
import time

import numpy as np
import pytest
import torch

from benchmark import control_ppo, generate_ppo, harness, program, roofline_wpn, weights
from benchmark.reference import cma, grid, waypoint
from benchmark.reference import ppo as ref_ppo
from vlnce_torch.config import get_config
from vlnce_torch.envs import device_sim, ensure_registered
from vlnce_torch.envs import rl_envs  # noqa: F401  (registers the waypoint env)
from vlnce_torch.envs.gridworld import _RES, get_scene
from vlnce_torch.models.waypoint_policy import WaypointPolicy
from vlnce_torch.registry import registry
from vlnce_torch.rl import device_rollout
from vlnce_torch.rl.ppo import STAT_KEYS
from vlnce_torch.trainers import ddppo_waypoint_trainer  # noqa: F401  (registers the trainer)

from tests.torch_port_cases import SceneRegistrySnapshot, assert_imported, export_synthetic_geometry, waypoint_space

ensure_registered()

WORKLOAD = "wpn.ddppo_train"
SEED = 2**31 + 4242
IMG = 16
SMALL_OPTS = {
    "CUDA.PRECISION.compute_dtype": "float32", "RL.PPO.num_steps": 3, "NUM_ENVIRONMENTS": 2,
    "RL.PPO.num_mini_batch": 2, "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS": 2,
    "TASK_CONFIG.SIMULATOR.RGB_SENSOR.HEIGHT": IMG, "TASK_CONFIG.SIMULATOR.RGB_SENSOR.WIDTH": IMG,
    "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.HEIGHT": IMG, "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.WIDTH": IMG,
}
SMALL_TRAFFIC = {"scenes": 2, "paths": 3, "instructions_per_path": 2, "warm_updates": 0, "trace_updates": 1}
WPN_YAML = "vlnce_torch/config/experiments/r2r_waypoint/1-wpn-cc.yaml"


def small_cell(seed=SEED):
    """The cell at 16x16 frames, 2 envs x 3 steps, 2 x 2 minibatches, on
    the CPU in f32; the pano head at 16x its spread, so that the small
    frames' features make a pano distribution as peaked as the card's."""
    c = harness.load_cell(WORKLOAD, seed=seed, seconds=0.0, trace=False)
    c.device = "cpu"
    c.extra_opts, c.traffic_overrides = dict(SMALL_OPTS), dict(SMALL_TRAFFIC)
    c.config = {**c.config, "weights": {"gains": {"net.compress_x_linear.0.weight": 16.0}}}
    return c


def small_config(*extra):
    opts = []
    for k, v in SMALL_OPTS.items():
        opts += [k, v]
    return get_config(WPN_YAML, opts + ["CUDA.DEVICE", "cpu", "TASK_CONFIG.DATASET.TYPE", "Synthetic-VLN-v0",
                                        "TASK_CONFIG.DATASET.NUM_EPISODES", 6, "TENSORBOARD_DIR", "", *extra])


# ---------------------------------------------------------------------------
# the policy, the world and the bank against the reference
# ---------------------------------------------------------------------------


def test_evaluate_actions_matches_the_reference():
    cfg = small_config()
    from vlnce_torch.config.default import add_pano_sensors_to_config
    from vlnce_torch.envs import spaces as port_spaces

    cfg = add_pano_sensors_to_config(cfg)
    arch = waypoint.Arch(hidden=256, depth_hw=IMG)
    policy = WaypointPolicy.from_config(cfg, waypoint_space(port_spaces, IMG))
    W = weights.make(waypoint.param_spec(arch), 11, "cpu")
    program.load_weights(policy, W)
    T, n = 3, 2
    g = torch.Generator().manual_seed(5)
    obs = {
        "rgb": torch.randint(0, 256, (T * n, 12, IMG, IMG, 3), generator=g, dtype=torch.uint8),
        "depth": torch.rand(T * n, 12, IMG, IMG, 1, generator=g),
        "rgb_history": torch.randint(0, 256, (T * n, IMG, IMG, 3), generator=g, dtype=torch.uint8),
        "depth_history": torch.rand(T * n, IMG, IMG, 1, generator=g),
        "instruction": torch.where(torch.arange(200)[None] < torch.randint(3, 20, (T * n, 1), generator=g),
                                   torch.randint(2, 2504, (T * n, 200), generator=g), 0).int(),
        "angle_features": torch.rand(T * n, 12, 4, generator=g),
    }
    masks = torch.tensor([0.0, 0.0, 1.0, 0.0, 1.0, 1.0])[:, None]
    prev = {"pano": torch.randint(0, 13, (T * n, 1), generator=g).float(),
            "offset": (torch.rand(T * n, 1, generator=g) - 0.5) * 0.5, "distance": torch.rand(T * n, 1, generator=g) * 3 + 0.3}
    actions = {"pano": torch.tensor([3.0, 12.0, 0.0, 7.0, 11.0, 5.0])[:, None],
               "offset": (torch.rand(T * n, 1, generator=g) - 0.5) * 0.5, "distance": torch.rand(T * n, 1, generator=g) * 3 + 0.3}
    h0 = torch.randn(n, 2, 256, generator=g) * 0.5
    with torch.no_grad():
        value, logp, ent, _ = policy.evaluate_actions(obs, h0, prev, masks, actions, seq_len=T)
        feats = waypoint.encode_steps(W, arch, obs, masks[:, 0])
        rgb_f, depth_f = (f.reshape((T, n) + tuple(f.shape[1:])) for f in feats)
        emb = cma.instruction(W, obs["instruction"], arch.instr).reshape(T, n, 256, -1)

        def tn(x):
            return x.reshape((T, n) + tuple(x.shape[1:]))

        out = waypoint.sequence(W, arch, rgb_f, depth_f, emb, {k: tn(v)[..., 0] for k, v in prev.items()}, tn(masks)[..., 0],
                                tn(obs["angle_features"]), h0)
        ref_logp, ref_ent = waypoint.evaluate(out, {k: tn(v)[..., 0] for k, v in actions.items()}, arch)
    np.testing.assert_allclose(value.reshape(T, n), out["value"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(logp.reshape(T, n), ref_logp, rtol=1e-4, atol=1e-4)
    for k in ("pano", "offset", "distance"):
        np.testing.assert_allclose(ent[k].reshape(T, n), ref_ent[k], rtol=1e-4, atol=1e-5, err_msg=k)
    assert float(ref_ent["offset"][0, 1]) == 0.0  # a STOP row has no offset entropy


def test_waypoint_step_and_reward_match_the_plain_step():
    rng = np.random.default_rng(3)
    ids = generate_ppo.scene_ids(4)
    rows = [ids[k % 4] for k in range(32)]
    occ = torch.from_numpy(np.stack([get_scene(s).occupancy for s in rows]))
    ref_occ = grid.scene_batch(rows, "cpu")["occupancy"]
    assert torch.equal(occ, ref_occ), "the program's procedural scenes are not the reference's"
    nearest = torch.from_numpy(np.stack([device_sim.nearest_free_cell_map(s) for s in rows]))
    free = [np.argwhere(~get_scene(s).occupancy) for s in rows]
    cells = np.stack([f[rng.integers(len(f))] for f in free])
    pos = torch.tensor(np.stack([(cells[:, 0] + rng.uniform(0.05, 0.95, 32)) * _RES, np.zeros(32),
                                 (cells[:, 1] + rng.uniform(0.05, 0.95, 32)) * _RES], 1), dtype=torch.float32)
    heading = torch.tensor(rng.uniform(0, 2 * math.pi, 32), dtype=torch.float32)
    r = torch.tensor(rng.uniform(0.25, 4.0, 32), dtype=torch.float32)
    theta = torch.tensor(rng.uniform(0, 2 * math.pi, 32), dtype=torch.float32)
    stop = torch.tensor(rng.uniform(size=32) < 0.2)
    moved, turned = device_sim.waypoint_step(occ, nearest, pos, heading, r, theta, True, 66, False)
    got_pos = torch.where(stop[:, None], pos, moved)
    got_heading = torch.where(stop, heading, turned)
    want_pos, want_heading = waypoint.waypoint_step(ref_occ, pos, heading, r, theta, stop)
    np.testing.assert_allclose(got_pos, want_pos, atol=1e-5)
    np.testing.assert_allclose(got_heading, want_heading, atol=1e-5)
    assert float((got_pos - pos).norm(dim=1).max()) > 0.5  # the moves went somewhere
    goals = [(float(x) * _RES + 0.1, float(z) * _RES + 0.1) for x, z in (f[rng.integers(len(f))] for f in free)]
    field = torch.from_numpy(np.stack([
        get_scene(s).distance_field(get_scene(s).world_to_cell(*g)) for s, g in zip(rows, goals)]).astype(np.float32))
    ref_field = torch.from_numpy(np.stack([waypoint.scene_field(get_scene(s).occupancy, g) for s, g in zip(rows, goals)]))
    assert torch.equal(field, ref_field.float())
    prev_d = waypoint.field_at(field, pos)
    kwargs = dict(slack_reward=-0.05, use_distance_scaled_slack_reward=True, scale_slack_on_prediction=True,
                  success_reward=2.5, distance_scalar=1.0, success_distance=3.0)
    reward, d, _ = device_sim.waypoint_reward(field, prev_d, pos[:, 0::2], got_pos, r, stop, **kwargs)
    rm = {k: kwargs[k] for k in ("slack_reward", "distance_scalar", "success_reward", "success_distance")}
    want_reward, want_d = waypoint.waypoint_reward(ref_field.float(), prev_d, pos, want_pos, r, stop, rm)
    np.testing.assert_allclose(reward, want_reward, atol=1e-5)
    np.testing.assert_array_equal(d, want_d)


def _host_fields(episodes, n):
    """The old host route: each episode's field the minimum of its goals'
    Dijkstra fields (f64, cast to f32), padded with +inf, and d0."""
    fields, d0 = [], []
    for ep in episodes:
        scene = get_scene(ep.scene_id)
        f = None
        for goal in ep.goals:
            g = np.asarray(goal.position, np.float64)
            h = scene.distance_field(scene.world_to_cell(float(g[0]), float(g[-1])))
            f = h if f is None else np.minimum(f, h)
        s = np.asarray(ep.start_position, np.float64)
        si, sj = scene.world_to_cell(float(s[0]), float(s[-1]))
        d0.append(np.float32(max(float(f[si, sj]), 1e-6)))
        fields.append(device_sim._pad_grid(f.astype(np.float32), n, np.inf))
    return np.stack(fields), np.asarray(d0, np.float32)


@pytest.mark.parametrize("source", ["procedural", "imported"])
def test_bank_goal_fields_equal_the_host_dijkstra(source, tmp_path):
    from vlnce_torch.envs.scene_import import apply_scene_geometry
    from vlnce_torch.tasks.datasets import make_dataset

    sizes = {"synth_scene_0": 20.0, "synth_scene_1": 24.0, "synth_scene_2": 20.0, "synth_scene_3": 28.0}
    with SceneRegistrySnapshot():
        cfg = small_config("TASK_CONFIG.DATASET.NUM_EPISODES", 10)
        if source == "imported":
            cfg = small_config("TASK_CONFIG.DATASET.NUM_EPISODES", 10, "TASK_CONFIG.SIMULATOR.GEOMETRY_DIR", str(tmp_path))
            ids = sorted({e.scene_id for e in make_dataset(cfg.TASK_CONFIG.DATASET.TYPE, cfg.TASK_CONFIG.DATASET).episodes})
            export_synthetic_geometry(str(tmp_path), ids, sizes)
            apply_scene_geometry(cfg.TASK_CONFIG.SIMULATOR)
            assert_imported(ids)
        eps = list(make_dataset(cfg.TASK_CONFIG.DATASET.TYPE, cfg.TASK_CONFIG.DATASET).episodes)
        eps[1].goals = list(eps[1].goals) + [eps[4].goals[0]]  # an episode of two goals: the minimum of their fields
        calls = device_sim.goal_distance_fields.calls
        queue = device_rollout.build_episode_queue([eps[:5], eps[5:]], "cpu")
        assert device_sim.goal_distance_fields.calls == calls + 1  # one call builds every distinct goal's field
        n = queue.goal_field.shape[-1]
        assert n == max(get_scene(e.scene_id).n for e in eps)
        grids = {get_scene(e.scene_id).n for e in eps}
        want, d0 = _host_fields(eps, n)
    np.testing.assert_array_equal(queue.goal_field.reshape(-1, n, n).numpy(), want)
    np.testing.assert_array_equal(queue.d0.reshape(-1).numpy(), d0)
    assert len(grids) > 1 if source == "imported" else grids == {64}  # imported: mixed sizes, padded to the largest


def test_the_benchmark_drives_train_updates(tmp_path):
    """One update through `trainer_with_policy`, `start_device_rollout` and
    `train_update_on_device` gives the stats `train()` logs for its first
    update, from the same seed."""
    opts = ["CUDA.ON_DEVICE_ROLLOUT", True, "CUDA.PPO_UPDATE_SCAN", True, "RL.NUM_UPDATES", 1,
            "CHECKPOINT_FOLDER", str(tmp_path), "TASK_CONFIG.SEED", 9]
    trained = registry.get_trainer("ddppo-waypoint")(small_config(*opts))
    trained.train()
    driven = program.trainer_with_policy(small_config(*opts), "ddppo-waypoint")
    assert driven.collector is None and driven.agent is not None
    stats, spent = driven.train_update_on_device(0, np.random.RandomState(9))
    assert spent["env_steps"] == 3 * 2 and driven.collector.rollouts == 1 and driven.agent.minibatch_steps == 4
    want = trained.update_history[0]
    assert sorted(stats) == sorted(STAT_KEYS)
    np.testing.assert_allclose([stats[k] for k in STAT_KEYS], [want[k] for k in STAT_KEYS], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("blocked", [0.3, 0.6, 0.9, 0.99])
def test_nearest_free_cells_are_the_hosts(blocked):
    """The first free cell of least squared distance in row-major order
    (GridWorldScene.nearest_navigable_cell), for every cell."""
    occ = np.random.default_rng(int(blocked * 100)).uniform(size=(20, 20)) < blocked
    occ[3, 17] = False
    free = np.argwhere(~occ)
    want = np.stack([free[np.argmin((free[:, 0] - i) ** 2 + (free[:, 1] - j) ** 2)] for i in range(20) for j in range(20)])
    np.testing.assert_array_equal(device_sim.nearest_free_cells(occ).reshape(-1, 2), want)


def test_tv_resnet18_flops_are_torchvisions():
    # torchvision's resnet18 is 1.814 GMACs at 224 with its pool and fc (0.0005)
    assert abs(roofline_wpn.tv_resnet18_flops(224) / 2 - 1.8137e9) / 1.8137e9 < 0.01


# ---------------------------------------------------------------------------
# the cell at a small size
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    c = small_cell()
    return harness.runner(c).Setup(c, time.perf_counter())


def _judge(setup, got):
    compared = harness.checks({**got, "nonfinite_losses": 0.0}, setup.cell.limits)
    return compared, harness.passed(compared)


def test_small_cell_follows_the_reference(setup):
    runner = harness.runner(setup.cell)
    got = runner.check(setup, setup.first)
    compared, correct = _judge(setup, got)
    assert correct, compared
    for name in ("loss_gap", "grad_gap", "step_gap", "update_gap_median", "value_rel", "logp_rel", "pose_gap",
                 "reward_gap"):
        assert got[name] < 1e-4, (name, got[name])
    assert got["render_depth_off_share"] == 0.0 and got["render_rgb_off_share"] == 0.0 and got["pano_draw_gap"] == 0.0
    assert len(setup.first["losses"]) == len(setup.first["states"]) == 4 and setup.trainer.agent.minibatch_steps == 4
    assert not setup.first["states"][0]["adam"] and setup.first["states"][1]["adam"]  # Adam's moments from step 2


def test_generator_makes_the_same_work_for_every_seed():
    params = {"scenes": 3, "paths": 7, "instructions_per_path": 3, "instruction_tokens": [10, 60]}
    a, b, c = (generate_ppo.ppo_split(params, s, 2504) for s in (1, 1, 2))
    assert a == b and a != c and len(a) == len(c) == 21
    for split in (a, c):
        goals = [(e["scene"], tuple(e["goal"])) for e in split[::3]]
        assert len(set(goals)) == len(goals)  # every path's goal is new
        assert all(10 <= len(e["tokens"]) <= 60 and min(e["tokens"]) >= 2 and max(e["tokens"]) < 2504 for e in split)
        assert all(math.hypot(e["goal"][0] - e["start"][0], e["goal"][2] - e["start"][2]) >= 4.0 for e in split)


def _rerun(setup, monkeypatch, patch):
    with monkeypatch.context() as m:
        patch(m)
        setup.reseed(SEED)
        got = harness.runner(setup.cell).check(setup, setup.first)
    setup.reseed(SEED)
    return _judge(setup, got)


def test_a_moved_step_is_not_correct(setup, monkeypatch):
    step = device_sim.waypoint_step

    def moved(*args, **kwargs):
        pos, heading = step(*args, **kwargs)
        return pos + torch.tensor([0.05, 0.0, 0.0]), heading

    compared, correct = _rerun(setup, monkeypatch, lambda m: m.setattr(device_rollout, "waypoint_step", moved))
    assert not correct and compared["pose_gap"]["value"] > compared["pose_gap"]["limit"]


def test_a_pano_drawn_one_further_is_not_correct(setup, monkeypatch):
    from vlnce_torch.models import waypoint_policy

    class Further(waypoint_policy.Categorical):
        def icdf(self, u):
            a = super().icdf(u).clone()
            a[0] = torch.remainder(a[0] + 1, self.logits.shape[-1] - 1)
            return a

    compared, correct = _rerun(setup, monkeypatch, lambda m: m.setattr(waypoint_policy, "Categorical", Further))
    assert not correct and compared["pano_draw_gap"]["value"] > compared["pano_draw_gap"]["limit"]


def test_tf32_switched_on_is_not_correct(setup, monkeypatch):
    def patch(m):
        m.setattr(torch.backends.cuda.matmul, "allow_tf32", True)

    compared, correct = _rerun(setup, monkeypatch, patch)
    assert not correct and compared["tf32_switched_on"]["value"] == 1.0


def test_half_the_batch_is_not_correct(setup, monkeypatch):
    agent = setup.trainer.agent
    compared, correct = _rerun(setup, monkeypatch,
                               lambda m: m.setattr(agent, "_minibatch_step", control_ppo.half_batch(agent._minibatch_step)))
    assert not correct
    for name in ("loss_gap", "grad_gap", "step_gap"):
        assert compared[name]["value"] > compared[name]["limit"], (name, compared[name])


def test_control_readings(setup, monkeypatch):
    monkeypatch.setattr(control_ppo, "FAULT_SEEDS", 0)
    lines = list(control_ppo.ppo(setup.cell, [SEED], setup))
    line = lines[0]
    assert line["program"]["correct"] and not line["fp8"]["correct"] and not line["pano_moved"]["correct"]
    assert len(lines) == 2 and not lines[1]["program_half_batch"]["correct"]
    assert control_ppo.correct_seeds(lines)["program_half_batch"] == 0
    assert line["fp8"]["numbers"]["value_rel"] == pytest.approx(1.0)
    summary = control_ppo.summarize(lines)
    assert summary["program"]["correct_on_every_seed"] and not summary["fp8"]["correct_on_every_seed"]
    assert ref_ppo.minibatch_plan(4, 2, 2, np.random.RandomState(0)).shape == (4, 2)


_IMPORTS = {
    "reference": "import benchmark.reference.waypoint, benchmark.reference.ppo, benchmark.roofline_wpn, "
                 "benchmark.generate_ppo",
    "runner": "from benchmark import harness, control_ppo\n"
              "harness.runner(harness.load_cell('wpn.ddppo_train', 1, 1.0, False))\n"
              "[harness.metric_reader(m['name']) for m in harness.benchmark_spec()['per_layer']]\n"
              "import vlnce_torch.trainers.ddppo_waypoint_trainer, vlnce_torch.rl.device_rollout",
}


@pytest.mark.parametrize("part", sorted(_IMPORTS))
def test_what_the_cell_imports(part):
    """The reference imports nothing of the program, JAX or the JAX package;
    the runner, the control script and the metric readers no JAX."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = _IMPORTS[part] + "\nimport sys\nprint(sorted({m.split('.')[0] for m in sys.modules}))"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    names = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not names & {"jax", "jaxlib", "flax", "vlnce_tpu"}
    assert ("vlnce_torch" in names) == (part == "runner")
