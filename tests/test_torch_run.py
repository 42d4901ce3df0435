"""`python -m vlnce_torch.run` as a user calls it: in a subprocess, with
forked env workers, on the CPU only because the command line says so."""

import json
import os
import subprocess
import sys

import pytest

from tests.torch_port_cases import RXR_CMA, SMALL_OPTS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEASURES = ["distance_to_goal", "ndtw", "oracle_success", "path_length", "spl", "steps_taken", "success"]


def _cli(value) -> str:
    return value if isinstance(value, str) else json.dumps(value)


def _run(run_type, tmp_path, extra=()):
    opts = SMALL_OPTS + [
        "TASK_CONFIG.DATASET.TYPE", "Synthetic-VLN-v0",
        "TASK_CONFIG.DATASET.NUM_EPISODES", 8,
        "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", 4,
        "NUM_ENVIRONMENTS", 2,
        "EVAL.EPISODE_COUNT", 3,
        "TENSORBOARD_DIR", "",
        "VERBOSE", False,
        "LOG_FILE", str(tmp_path / "run.log"),
        "RESULTS_DIR", str(tmp_path / "evals"),
        "EVAL_CKPT_PATH_DIR", str(tmp_path / "no_such_checkpoint.pth"),
        "INFERENCE.CKPT_PATH", str(tmp_path / "no_such_checkpoint.pth"),
        "INFERENCE.PREDICTIONS_FILE", str(tmp_path / "predictions.jsonl"),
        *extra,
    ]
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "VLNCE_TORCH_THREADED_ENVS")}
    return subprocess.run(
        [sys.executable, "-m", "vlnce_torch.run", "--exp-config", RXR_CMA, "--run-type", run_type, *map(_cli, opts)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )


CPU = ["CUDA.DEVICE", "cpu", "CUDA.PRECISION.compute_dtype", "float32"]


def test_eval_on_the_cpu_writes_the_stats_file(tmp_path):
    out = _run("eval", tmp_path, CPU)
    assert out.returncode == 0, out.stderr[-2000:]
    with open(tmp_path / "evals" / "stats_ckpt_0_val_unseen.json") as f:
        stats = json.load(f)
    assert sorted(stats) == MEASURES and all(isinstance(v, float) for v in stats.values())
    assert 1.0 <= stats["steps_taken"] <= 4.0
    log = (tmp_path / "run.log").read_text()
    assert "Initialized policy CMAPolicy on cpu" in log and "act_steps:" in log


def test_inference_on_the_cpu_writes_rxr_predictions(tmp_path):
    out = _run("inference", tmp_path, CPU + ["TASK_CONFIG.DATASET.NUM_EPISODES", 4])
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [json.loads(line) for line in open(tmp_path / "predictions.jsonl")]
    assert len(lines) == 4 and all(sorted(entry) == ["instruction_id", "path"] for entry in lines)


def test_train_fails_with_the_roadmap_message(tmp_path):
    out = _run("train", tmp_path, CPU)
    assert out.returncode != 0
    assert "NotImplementedError" in out.stderr and "recollect_trainer" in out.stderr
    assert "ROADMAP.md section A, 'Seq2Seq, recollection'" in out.stderr


def test_default_device_is_the_card(tmp_path):
    """Without `CUDA.DEVICE cpu` the entry point goes for the card; on a
    machine without one it fails instead of quietly running on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the failure is what a machine without one shows")
    out = _run("eval", tmp_path)
    assert out.returncode != 0 and not (tmp_path / "evals" / "stats_ckpt_0_val_unseen.json").exists()
    assert "cuda" in out.stderr.lower()
