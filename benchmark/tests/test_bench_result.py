"""The result's last line: its keys, in order, for both kinds of run, and
the per-layer metrics each cell reports."""

import json

import pytest

from benchmark import harness, run
from benchmark.trace import Trace


class _Ev:
    def __init__(self, name, kind, start, dur):  # start and duration in microseconds
        self._n, self._k, self._s, self._d = name, kind, start * 1000, dur * 1000

    def name(self):
        return self._n

    def device_type(self):
        return self._k


    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d


def _trace():
    events = [_Ev("bench_window", "DeviceType.CPU", 0, 1000), _Ev("run_scan_rollouts", "DeviceType.CPU", 0, 600),
              _Ev("cudaLaunchKernel", "DeviceType.CPU", 10, 5), _Ev("cudaGraphLaunch", "DeviceType.CPU", 20, 5),
              _Ev("gru_sequence_kernel", "DeviceType.CUDA", 100, 100), _Ev("resize_normalize_kernel", "DeviceType.CUDA", 150, 100),
              _Ev("resize_normalize_kernel", "DeviceType.CUDA", 700, 50),
              _Ev("gru_sequence_backward_cluster_kernel", "DeviceType.CUDA", 800, 100),
              _Ev("bench_window", "DeviceType.CUDA", 0, 1000)]  # the span's mirror
    return Trace(events, 0, 1_000_000)


def test_trace_union_and_gaps():
    t = _trace()
    assert t.busy_s == pytest.approx(300e-6)  # [100, 250] + [700, 750] + [800, 900]: overlaps counted once
    assert t.launches == 2
    assert t.kernel("resize_normalize_kernel") == (2, pytest.approx(150e-6))
    gaps = dict(t.idle_gaps())
    assert gaps["run_scan_rollouts"] == pytest.approx(550e-6) and gaps["bench_window"] == pytest.approx(150e-6)
    assert sum(gaps.values()) == pytest.approx(t.window_s - t.busy_s)


def _outcome(trace):
    return {"setup_s": 12.5, "e2e": {"rollout_env_steps_per_s": 2000.0, "train_frames_per_s": 1.0}, "attempted": 64,
            "failed": 0, "compared": {"final_logit_rel": 0.0, "widest_gap_rel": 0.0, "stopped_early": 0.0,
                                          "tf32_switched_on": 0.0},
            "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1, "memory_peak_bytes": 1},
            "ctx": {"trace": trace, "window_s": 1e-6, "setup_seconds": 2e-7, "replays": 4, "env_steps": 256,
                    "b1_bound_s": 1e-8, "b2_pair_bound_s": 1e-8, "least_s": 1e-8}}


def test_last_line_keys():
    spec = harness.benchmark_spec()
    cell = harness.load_cell("rxr_cma.scan_rollout", 1, 1.0, False, spec)
    line = run.assemble(spec, cell, _outcome(None))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(line["metrics"]) == {"rollout_env_steps_per_s", "setup_s"}
    assert line["correct"] is True and list(line["checks"]) == [
        "final_logit_rel", "widest_gap_rel", "stopped_early", "tf32_switched_on"]
    json.dumps(line)
    cell.trace = True
    line = run.assemble(spec, cell, _outcome(_trace()))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["metrics"]) == {"rollout.chunk_setup_share", "rollout.replay_ms", "device_idle_share.rollout",
                                    "b1_roofline.rollout", "b2_roofline.rollout", "mfu.rollout"}
    assert len(line["breakdown"]["device_ops"]) <= 10 and len(line["breakdown"]["idle_gaps"]) <= 10


def test_every_cell_reports_setup_another_e2e_and_a_per_layer_metric():
    spec = harness.benchmark_spec()
    for w in spec["workloads"]:
        e2e = run.e2e_names(spec, w["name"])
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = run.per_layer_names(spec, w["name"], e2e)
        assert layer and all(m["moves"] in e2e for m in spec["per_layer"] if m["name"] in layer)


def test_an_absent_kernel_reads_nothing():
    reader = harness.metric_reader("b1_bwd_roofline.train")
    assert reader.read({"trace": Trace([], 0, 10), "b1_bwd_bound_s": 1.0}) is None


def test_failed_check_is_not_correct():
    spec = harness.benchmark_spec()
    cell = harness.load_cell("rxr_cma.scan_rollout", 1, 1.0, False, spec)
    out = _outcome(None)
    out["compared"]["final_logit_rel"] = 1e9
    assert run.assemble(spec, cell, out)["correct"] is False
