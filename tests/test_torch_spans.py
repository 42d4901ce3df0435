"""The port's spans (`vlnce_torch.utils.profiling.annotate`) in its two
benchmarked loops, on the CPU at small sizes, and the benchmark's readers
of them.

- The scan rollout (`trainers/scan_eval.run_scan_rollouts`, R2R CMA, two
  chunks of 3 episodes, the second padded) under `torch.profiler`: every
  span of the loop with its parent, one `scan.chunk` per chunk, one
  `scan.field_build` per chunk (its goal fields built on the device, one
  call of `goal_distance_fields` a chunk) and no `scan.goal_field`, and
  `scan.setup` agreeing with the `setup_seconds` stat.
- The host simulator's geodesic distance (`GridWorldSim.geodesic_distance`)
  over the same episodes: one `scan.goal_field` per goal cell the scenes
  had not cached, and none on a second pass over the same goals.
- The fused DAgger epoch (`data/device_bank.run_fused_epoch` with the IL
  step) under the profiler: one `train.run` per run of `epoch_runs`, one
  `train.step` per batch, each holding `train.gather` and the IL step's
  `il.forward`, `il.backward` and `il.optimizer`.
- With no profiler recording, no span calls `record_function`.
- The on-card eval and inference under `CUDA.PROFILE_DIR` write a trace
  holding the scan rollout's spans.
- DD-PPO with the rollout on the card (the small waypoint policy, the
  trainer built as the benchmark builds it): the episode bank's build in
  `ppo.bank` holding `ppo.field_build` (one call of `goal_distance_fields`),
  then per update `ppo.rollout` (`ppo.load`, `ppo.replays`,
  `ppo.readback`) and `ppo.update` (`ppo.plan`, `ppo.minibatches`,
  `ppo.update_readback`), WDDPPO's `minibatch_steps` counting the
  minibatch steps, and the cell's span metrics reading them.
- The six span metrics in `benchmark/metrics/` read those traces (the two
  goal-field metrics read 0 from the scan loop's, and the host fields from
  a trace of host Dijkstra fields inside `scan.chunk` spans), and read
  nothing from a trace without the spans; `benchmark/spans.split` sums them
  by name, with each name's self seconds.
"""

import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark import harness, spans as bench_spans
from benchmark.trace import Trace
from vlnce_torch.config import get_config
from vlnce_torch.data.device_bank import DeviceTrajectoryBank, ResidentBatchIterator, run_fused_epoch
from vlnce_torch.envs import ensure_registered
from vlnce_torch.envs.gridworld import get_scene
from vlnce_torch.envs.spaces import action_space_from_config, observation_space_from_config
from vlnce_torch.models.cma_policy import CMAPolicy
from vlnce_torch.ops.goal_field import goal_distance_fields
from vlnce_torch.parallel.il_step import build_il_train_step
from vlnce_torch.parallel.optim import masked_adam
from vlnce_torch.tasks.datasets import make_dataset
from vlnce_torch.trainers import scan_eval
from vlnce_torch.utils import profiling

from tests.torch_port_cases import R2R_CMA, R2R_SMALL_OPTS

ensure_registered()

LOOP = [
    "CUDA.DEVICE", "cpu", "CUDA.PRECISION.compute_dtype", "float32",
    "TASK_CONFIG.DATASET.NUM_EPISODES", 4,
    "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", 6,
    "EVAL.SCAN_BATCH", 3,  # 4 episodes: two chunks, the second padded
    "EVAL.SCAN_SEGMENT", 4,
    "EVAL.SAMPLE", False,
]
SCAN_PARENTS = {
    "scan.chunk": None, "scan.setup": "scan.chunk", "scan.scenes": "scan.setup", "scan.field_build": "scan.scenes",
    "scan.instructions": "scan.setup", "scan.upload": "scan.setup", "scan.load": "scan.chunk",
    "scan.replays": "scan.chunk", "scan.readback": "scan.chunk",
}
TRAIN_PARENTS = {
    "train.plan": None, "train.run": None, "train.run_upload": "train.run", "train.step": "train.run",
    "train.gather": "train.step", "il.forward": "train.step", "il.backward": "train.step",
    "il.optimizer": "train.step", "train.readback": "train.run",
}
LENGTHS = [3, 9, 14, 16, 18, 25, 31, 7, 12, 40, 5, 20]  # padded to 16, 32 or 48
BATCH = 2
SEED = 7


PPO_PARENTS = {
    "ppo.rollout": None, "ppo.load": "ppo.rollout", "ppo.replays": "ppo.rollout", "ppo.readback": "ppo.rollout",
    "ppo.update": None, "ppo.plan": "ppo.update", "ppo.minibatches": "ppo.update", "ppo.update_readback": "ppo.update",
}
WAYPOINT = [
    "CUDA.DEVICE", "cpu", "CUDA.PRECISION.compute_dtype", "float32", "CUDA.ON_DEVICE_ROLLOUT", True,
    "CUDA.PPO_UPDATE_SCAN", True, "TASK_CONFIG.DATASET.NUM_EPISODES", 4, "RL.PPO.num_steps", 2,
    "TASK_CONFIG.SIMULATOR.RGB_SENSOR.HEIGHT", 16, "TASK_CONFIG.SIMULATOR.RGB_SENSOR.WIDTH", 16,
    "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.HEIGHT", 16, "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.WIDTH", 16,
]
UPDATES = 2


def _program(name):
    return name.startswith(("scan.", "train.", "il.", "ppo."))


def _traced(fn):
    """fn() under the profiler, as the benchmark's runners trace a window:
    (fn's result, the Trace of the `window` span)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("window"):
            out = fn()
    events = prof.profiler.kineto_results.events()
    span = next(e for e in events if e.name() == "window")
    return out, Trace(events, span.start_ns(), span.start_ns() + span.duration_ns())


def _spans(trace):
    return [(s, e, n) for s, e, n in trace.cpu if _program(n)]


def _parent(span, spans):
    """The innermost program span around `span` (None at the top)."""
    s, e, _ = span
    around = [o for o in spans if o is not span and o[0] <= s and e <= o[1] and o[1] - o[0] > e - s]
    return min(around, key=lambda o: o[1] - o[0])[2] if around else None


def _count(trace, name):
    return sum(1 for _, _, n in trace.cpu if n == name)


def _seconds(trace, name):
    return sum(e - s for s, e, n in trace.cpu if n == name) / 1e9


# ---------------------------------------------------------------------------
# the two loops
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def r2r():
    cfg = get_config(R2R_CMA, R2R_SMALL_OPTS + LOOP)
    torch.manual_seed(0)
    policy = CMAPolicy.from_config(cfg, observation_space_from_config(cfg.TASK_CONFIG),
                                   action_space_from_config(cfg.TASK_CONFIG))
    return cfg, policy


def _goal_cells(episodes):
    cells = set()
    for ep in episodes:
        scene = get_scene(ep.scene_id)
        for goal in ep.goals:
            cells.add((ep.scene_id, scene.world_to_cell(float(goal.position[0]), float(goal.position[-1]))))
    return cells


def _rollout(cfg, policy, episodes):
    stats = {}
    scan_eval.run_scan_rollouts(policy, [], cfg, episodes, stats=stats)
    return stats


def _episodes(cfg):
    return list(make_dataset(cfg.TASK_CONFIG.DATASET.TYPE, cfg.TASK_CONFIG.DATASET).episodes)


def _drop_fields(cells):
    for scene_id, _ in cells:
        get_scene(scene_id)._distance_fields.clear()


@pytest.fixture(scope="module")
def scan(r2r):
    """Two traced rollouts of the same episodes, the scenes' host fields
    dropped first, and goal_distance_fields' counters (calls, launches,
    fields) over the first."""
    cfg, policy = r2r
    episodes = _episodes(cfg)
    cells = _goal_cells(episodes)
    _drop_fields(cells)
    counters = lambda: (goal_distance_fields.calls, goal_distance_fields.launches, goal_distance_fields.fields)
    before = counters()
    first = _traced(lambda: _rollout(cfg, policy, episodes))
    built = tuple(a - b for a, b in zip(counters(), before))
    again = _traced(lambda: _rollout(cfg, policy, episodes))
    return {"cells": cells, "first": first, "again": again, "built": built}


@pytest.fixture(scope="module")
def host(r2r):
    """The host simulator's geodesic distance from each episode's start to
    its goals, the scan loop's chunks each inside a `scan.chunk` span, the
    scenes' fields dropped first; traced twice: the first pass builds every
    goal's host Dijkstra field, the second none."""
    from vlnce_torch.registry import registry

    cfg, _ = r2r
    episodes = _episodes(cfg)
    cells = _goal_cells(episodes)
    _drop_fields(cells)
    sim = registry.get_simulator(cfg.TASK_CONFIG.SIMULATOR.TYPE)(cfg.TASK_CONFIG.SIMULATOR)
    chunk = int(cfg.EVAL.SCAN_BATCH)

    def distances():
        out = []
        for lo in range(0, len(episodes), chunk):
            with profiling.annotate("scan.chunk"):
                for ep in episodes[lo:lo + chunk]:
                    sim.reconfigure(ep.scene_id)
                    out.append(sim.geodesic_distance(ep.start_position, [g.position for g in ep.goals]))
        return out

    return {"cells": cells, "first": _traced(distances), "again": _traced(distances)}


def _bank(policy):
    rng = np.random.RandomState(SEED)
    feat = {"rgb_features": (policy.net.rgb_encoder.resnet_layer_size, 4, 4),
            "depth_features": tuple(policy.net.depth_encoder.visual_encoder.output_shape_chw()), "progress": (1,)}
    n = sum(LENGTHS)
    rows = {k: torch.from_numpy(rng.randn(n, int(np.prod(s))).astype(np.float16)) for k, s in feat.items()
            if k != "progress"}
    rows["progress"] = torch.from_numpy(rng.rand(n, 1).astype(np.float32))
    prev = torch.from_numpy(rng.randint(0, 4, n).astype(np.int32))
    oracle = torch.from_numpy(rng.randint(0, 4, n).astype(np.int32))
    instr = torch.from_numpy(rng.randint(1, 64, (len(LENGTHS), 8)).astype(np.int32))
    return DeviceTrajectoryBank.from_rows([rows], [prev], [oracle], [instr], LENGTHS, feat)


@pytest.fixture(scope="module")
def fused(r2r):
    """One traced fused epoch over a small bank, and the runs its iterator plans."""
    cfg, policy = r2r
    bank = _bank(policy)
    step = build_il_train_step(policy, masked_adam(1e-4, policy, cfg.MODEL))
    runs = list(ResidentBatchIterator(bank, BATCH, seed=SEED, time_major=True).epoch_runs())
    losses, trace = _traced(lambda: run_fused_epoch(ResidentBatchIterator(bank, BATCH, seed=SEED, time_major=True),
                                                    step))
    return {"runs": runs, "losses": losses, "trace": trace}


@pytest.fixture(scope="module")
def ppo():
    """The small waypoint trainer as the benchmark builds it: its collector
    started under the profiler (the bank), then UPDATES traced updates."""
    from benchmark import program

    cfg = get_config("vlnce_torch/config/experiments/synthetic/smoke_waypoint.yaml", WAYPOINT)
    trainer = program.trainer_with_policy(cfg, "ddppo-waypoint")
    calls = goal_distance_fields.calls
    _, bank = _traced(trainer.start_device_rollout)
    built = goal_distance_fields.calls - calls
    rng = np.random.RandomState(0)
    before = trainer.agent.minibatch_steps
    stats, trace = _traced(lambda: [trainer.train_update_on_device(u, rng) for u in range(UPDATES)])
    return {"bank": bank, "built": built, "trace": trace, "stats": stats, "trainer": trainer,
            "steps": trainer.agent.minibatch_steps - before}


def test_ddppo_spans_nest_once_an_update(ppo):
    bank = ppo["bank"]
    assert _count(bank, "ppo.bank") == _count(bank, "ppo.field_build") == 1 and ppo["built"] == 1
    (s, e, _), = [x for x in bank.cpu if x[2] == "ppo.bank"]
    assert all(s <= a and b <= e for a, b, n in bank.cpu if n == "ppo.field_build")
    trace, trainer = ppo["trace"], ppo["trainer"]
    spans = _spans(trace)
    assert {n for _, _, n in spans} == set(PPO_PARENTS)
    for span in spans:
        assert _parent(span, spans) == PPO_PARENTS[span[2]], span
    for name in PPO_PARENTS:
        assert _count(trace, name) == UPDATES, name
    ppo_cfg = trainer.config.RL.PPO
    assert ppo["steps"] == UPDATES * ppo_cfg.ppo_epoch * ppo_cfg.num_mini_batch
    assert trainer.collector.replays == UPDATES * ppo_cfg.num_steps and all(
        np.isfinite(v) for st, _ in ppo["stats"] for v in st.values())


def test_ddppo_span_metrics_read_the_spans(ppo):
    trace = ppo["trace"]
    ctx = {"trace": trace, "window_s": trace.window_s, "replays": ppo["trainer"].collector.replays,
           "minibatch_steps": ppo["steps"]}
    share = harness.metric_reader("ppo.update_share").read(ctx)
    assert share == pytest.approx(100.0 * _seconds(trace, "ppo.update") / trace.window_s, rel=1e-9) and 0 < share < 100
    per_step = harness.metric_reader("ppo.replay_ms").read(ctx)
    want = 1e3 * (_seconds(trace, "ppo.replays") + _seconds(trace, "ppo.readback")) / ctx["replays"]
    assert per_step == pytest.approx(want, rel=1e-9) and per_step > 0
    assert harness.metric_reader("ppo.launches_per_minibatch").read(ctx) == 0.0  # the CPU launches no kernel
    _, bare = _traced(lambda: torch.ones(4).add_(1))
    for name in ("ppo.update_share", "ppo.replay_ms", "ppo.launches_per_minibatch"):
        assert harness.metric_reader(name).read({**ctx, "trace": bare, "window_s": bare.window_s}) is None, name
    rows = {r["name"]: r for r in bench_spans.split(trace, bench_spans.PROGRAM + ("ppo.",))}
    assert set(rows) == set(PPO_PARENTS)


def test_scan_rollout_spans_nest_once_a_chunk(scan):
    stats, trace = scan["first"]
    spans = _spans(trace)
    assert {n for _, _, n in spans} == set(SCAN_PARENTS)
    for span in spans:
        assert _parent(span, spans) == SCAN_PARENTS[span[2]], span
    assert _count(trace, "scan.chunk") == 2
    assert _count(trace, "scan.setup") == _count(trace, "scan.upload") == _count(trace, "scan.load") == 2
    assert _count(trace, "scan.replays") == _count(trace, "scan.readback") == stats["readbacks"]
    # the span holds exactly the interval the counter times
    assert _seconds(trace, "scan.setup") == pytest.approx(stats["setup_seconds"], rel=0.05)


def test_scan_builds_goal_fields_on_the_device_once_a_chunk(scan):
    """Each chunk's set-up builds its goal fields in one call of
    `goal_distance_fields`, in `scan.field_build`, whether or not the host's
    field caches hold them; the host's Dijkstra (`scan.goal_field`) never
    runs, and the two goal-field metrics read 0."""
    for _, trace in (scan["first"], scan["again"]):
        assert _count(trace, "scan.field_build") == _count(trace, "scan.chunk") == 2
        assert _count(trace, "scan.goal_field") == 0
        for name in ("rollout.goal_fields_per_chunk", "rollout.goal_field_share"):
            assert harness.metric_reader(name).read({"trace": trace, "window_s": trace.window_s}) == 0.0, name
    assert scan["built"] == (2, 0, 0)  # a call a chunk; on the CPU, the plain version and no launch


def test_scan_goal_field_once_per_new_goal(host):
    """On a host path (GridWorldSim.geodesic_distance) one `scan.goal_field`
    fires per goal cell the scenes had not cached, and none on a repeat."""
    assert len(host["cells"]) >= 3
    first_d, first = host["first"]
    assert _count(first, "scan.goal_field") == len(host["cells"])
    again_d, again = host["again"]
    assert _count(again, "scan.goal_field") == 0 and _count(again, "scan.chunk") == 2
    assert again_d == first_d and all(np.isfinite(first_d))


def test_fused_epoch_spans_a_run_and_a_step(fused):
    trace, runs = fused["trace"], fused["runs"]
    spans = _spans(trace)
    assert {n for _, _, n in spans} == set(TRAIN_PARENTS)
    for span in spans:
        assert _parent(span, spans) == TRAIN_PARENTS[span[2]], span
    steps = sum(len(rows) for _, rows in runs)
    assert len(runs) >= 2 and steps == len(LENGTHS) // BATCH == len(fused["losses"])
    assert _count(trace, "train.plan") == 1
    for name in ("train.run", "train.run_upload", "train.readback"):
        assert _count(trace, name) == len(runs), name
    assert _count(trace, "train.step") == steps
    for s, e, n in spans:
        if n == "train.step":
            inside = sorted(m for a, b, m in spans if s <= a and b <= e and m != n)
            assert inside == ["il.backward", "il.forward", "il.optimizer", "train.gather"]


@pytest.mark.parametrize("loop", ["scan", "fused"])
def test_no_record_function_without_a_profiler(r2r, loop, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)  # annotate's (torch's own code has its own)
    cfg, policy = r2r
    assert profiling.annotate("scan.chunk") is profiling.annotate("train.step")
    if loop == "scan":
        episodes = list(make_dataset(cfg.TASK_CONFIG.DATASET.TYPE, cfg.TASK_CONFIG.DATASET).episodes)
        assert _rollout(cfg, policy, episodes)["segments"] >= 2
    else:
        bank = _bank(policy)
        step = build_il_train_step(policy, masked_adam(1e-4, policy, cfg.MODEL))
        losses = run_fused_epoch(ResidentBatchIterator(bank, BATCH, seed=SEED, time_major=True), step)
        assert len(losses) == len(LENGTHS) // BATCH


def test_annotate_off_costs_little():
    """A span with no profiler recording is one check and a shared object:
    far under the record_function it enters while one records."""
    n, best = 2000, float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            with profiling.annotate("train.step"):
                pass
        best = min(best, (time.perf_counter() - t0) / n)
    assert best < 5e-6


# ---------------------------------------------------------------------------
# the benchmark's readers
# ---------------------------------------------------------------------------


def _expected(name, scan, host, fused):
    trace = scan["first"][1]
    if name in ("rollout.goal_field_share", "rollout.goal_fields_per_chunk"):
        trace = host["first"][1]  # the scan loop's read 0 (test_scan_builds_goal_fields_on_the_device_once_a_chunk)
    share = {"rollout.goal_field_share": "scan.goal_field", "rollout.instruction_read_share": "scan.instructions",
             "rollout.upload_share": "scan.upload"}
    if name in share:
        return trace, 100.0 * _seconds(trace, share[name]) / trace.window_s
    if name == "rollout.goal_fields_per_chunk":
        return trace, len(host["cells"]) / 2
    runs, trace = fused["runs"], fused["trace"]
    steps = [(s, e) for s, e, n in trace.cpu if n == "train.step"]
    if name == "train.enqueue_ms":
        return trace, float(np.mean([e - s for s, e in steps])) / 1e6
    assert name == "train.steps_per_run"
    return trace, len(steps) / len(runs)


@pytest.mark.parametrize("name", ["rollout.goal_field_share", "rollout.instruction_read_share", "rollout.upload_share",
                                  "rollout.goal_fields_per_chunk", "train.enqueue_ms", "train.steps_per_run"])
def test_span_metrics_read_the_spans(name, scan, host, fused):
    trace, want = _expected(name, scan, host, fused)
    reader = harness.metric_reader(name)
    got = reader.read({"trace": trace, "window_s": trace.window_s})
    assert got == pytest.approx(want, rel=1e-9) and got > 0
    # a trace without the program's spans (a program before them), and no trace
    _, bare = _traced(lambda: torch.ones(4).add_(1))
    assert reader.read({"trace": bare, "window_s": bare.window_s}) is None
    assert reader.read({"trace": None, "window_s": 1.0}) is None


@pytest.mark.parametrize("loop", ["scan", "fused"])
def test_split_by_span_name(loop, scan, fused):
    trace = scan["first"][1] if loop == "scan" else fused["trace"]
    parents = SCAN_PARENTS if loop == "scan" else TRAIN_PARENTS
    rows = {r["name"]: r for r in bench_spans.split(trace)}
    assert set(rows) == set(parents)
    for name in parents:
        r = rows[name]
        assert r["n"] == _count(trace, name) and r["s"] == pytest.approx(_seconds(trace, name), rel=1e-9)
        assert r["idle_s"] == pytest.approx(r["s"], rel=1e-9)  # the CPU run has no device events
        children = sum(rows[c]["s"] for c, p in parents.items() if p == name)
        assert r["self_s"] == pytest.approx(r["s"] - children, rel=1e-9, abs=1e-9) and r["self_s"] >= 0


@pytest.mark.parametrize("run_type", ["eval", "inference"])
def test_on_card_eval_and_inference_write_the_spans_under_profile_dir(run_type, tmp_path):
    from vlnce_torch.run import run_exp

    missing = str(tmp_path / "none.pth")  # no checkpoint: seeded weights
    opts = R2R_SMALL_OPTS + LOOP + [
        "EVAL.ON_DEVICE_SCAN", True, "INFERENCE.ON_DEVICE_SCAN", True, "EVAL.USE_CKPT_CONFIG", False,
        "INFERENCE.USE_CKPT_CONFIG", False, "INFERENCE.FORMAT", "r2r", "EVAL_CKPT_PATH_DIR", missing,
        "INFERENCE.CKPT_PATH", missing, "INFERENCE.PREDICTIONS_FILE", str(tmp_path / "preds.json"),
        "RESULTS_DIR", str(tmp_path / "evals"), "CUDA.PROFILE_DIR", str(tmp_path / "profile"), "LOG_FILE", "",
    ]
    run_exp(R2R_CMA, run_type, opts)
    folder = "eval_ckpt_0" if run_type == "eval" else "inference"
    with open(tmp_path / "profile" / folder / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert set(SCAN_PARENTS) <= names
