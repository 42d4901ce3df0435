"""The benchmark's cells cut to a size the CPU runs in seconds: the same
runners, program and reference, at small frames, batches and step caps
(the widths stay: ResNet50s, GRUs of 512), in f32."""

from __future__ import annotations

import time

import torch

from benchmark import harness

SEED = 2**31 + 4242

SCAN_OPTS = {
    "CUDA.PRECISION.compute_dtype": "float32",
    "TASK_CONFIG.SIMULATOR.RGB_SENSOR.HEIGHT": 120, "TASK_CONFIG.SIMULATOR.RGB_SENSOR.WIDTH": 160,
    "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.HEIGHT": 120, "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.WIDTH": 160,
    "RL.POLICY.OBS_TRANSFORMS.RESIZE_SHORTEST_EDGE.SIZE": 64,
    "RL.POLICY.OBS_TRANSFORMS.CENTER_CROPPER_PER_SENSOR.SENSOR_CROPS": [("rgb", (56, 56)), ("depth", (64, 64))],
    "EVAL.SCAN_BATCH": 8, "EVAL.SCAN_SEGMENT": 8, "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS": 24,
    "TASK_CONFIG.TASK.RXR_INSTRUCTION_SENSOR.max_text_len": 64,
}
SCAN_TRAFFIC = {"scenes": 4, "stream_chunks": 2, "sample_episodes": 8, "instruction_lengths": [5, 30, 64, 12]}

TRAIN_OPTS = {
    "CUDA.PRECISION.compute_dtype": "float32",
    "TASK_CONFIG.SIMULATOR.RGB_SENSOR.HEIGHT": 32, "TASK_CONFIG.SIMULATOR.RGB_SENSOR.WIDTH": 32,
    "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.HEIGHT": 32, "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.WIDTH": 32,
}
TRAIN_TRAFFIC = {"length_histogram": [[3, 10], [5, 10], [17, 5]], "instruction_tokens": [3, 12]}


def cell(workload: str, seed: int = SEED) -> harness.Cell:
    c = harness.load_cell(workload, seed=seed, seconds=0.0, trace=False)
    c.device = "cpu"
    if c.traffic["runner"] == "scan_rollout":
        c.extra_opts, c.traffic_overrides = dict(SCAN_OPTS), dict(SCAN_TRAFFIC)
    else:
        c.extra_opts, c.traffic_overrides = dict(TRAIN_OPTS), dict(TRAIN_TRAFFIC)
    return c


def run(workload: str, seed: int = SEED):
    """One run of the cell's runner, as benchmark.run makes it."""
    torch.set_num_threads(4)
    c = cell(workload, seed)
    out = harness.runner(c).run(c, time.perf_counter())
    compared = harness.checks(out["compared"], c.limits)
    return out, compared, harness.passed(compared) and out["failed"] == 0
