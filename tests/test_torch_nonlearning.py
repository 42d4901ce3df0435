"""The nonlearning agents through `run --run-type eval / inference` of the
port's r2r_baselines/nonlearning.yaml, against the JAX package's
`evaluate_agent` and `nonlearning_inference` on the same config and seed:
the stats file and the predictions file are equal, key for key."""

import json

import pytest

import vlnce_tpu.tasks  # noqa: F401
from vlnce_tpu.config import get_config as jax_get_config
from vlnce_tpu.envs import ensure_registered as jax_ensure_registered
from vlnce_tpu.trainers.nonlearning_agents import evaluate_agent as jax_evaluate_agent
from vlnce_tpu.trainers.nonlearning_agents import nonlearning_inference as jax_nonlearning_inference
from vlnce_torch.registry import registry
from vlnce_torch.run import run_exp

jax_ensure_registered()

YAML = "r2r_baselines/nonlearning.yaml"
IMG = 16


def _opts(tmp, agent, seed):
    return [
        "TASK_CONFIG.DATASET.TYPE", "Synthetic-VLN-v0", "TASK_CONFIG.DATASET.NUM_EPISODES", 4,
        "TASK_CONFIG.SEED", seed, "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", 60,
        "TASK_CONFIG.SIMULATOR.RGB_SENSOR.HEIGHT", IMG, "TASK_CONFIG.SIMULATOR.RGB_SENSOR.WIDTH", IMG,
        "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.HEIGHT", IMG, "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.WIDTH", IMG,
        "EVAL.EPISODE_COUNT", 3, "EVAL.NONLEARNING.AGENT", agent, "INFERENCE.NONLEARNING.AGENT", agent,
        "RESULTS_DIR", str(tmp / "evals"), "INFERENCE.PREDICTIONS_FILE", str(tmp / "predictions.json"),
        "TENSORBOARD_DIR", "", "LOG_FILE", "", "VERBOSE", False,
    ]


@pytest.mark.parametrize("agent", ["RandomAgent", "HandcraftedAgent"])
def test_nonlearning_eval_matches_jax(tmp_path, agent):
    assert run_exp(f"vlnce_torch/config/experiments/{YAML}", "eval", _opts(tmp_path / "port", agent, 7)) is None
    jax_evaluate_agent(jax_get_config(f"vlnce_tpu/config/experiments/{YAML}", _opts(tmp_path / "jax", agent, 7)))
    name = f"stats_{agent}_val_unseen.json"
    with open(tmp_path / "port" / "evals" / name) as f, open(tmp_path / "jax" / "evals" / name) as jf:
        stats, jax_stats = json.load(f), json.load(jf)
    assert stats == jax_stats
    assert {"success", "spl", "ndtw", "path_length"} <= set(stats) and stats["path_length"] > 0
    assert registry.get_agent(agent).__module__ == "vlnce_torch.trainers.nonlearning_agents"


@pytest.mark.parametrize("agent", ["RandomAgent", "HandcraftedAgent"])
def test_nonlearning_inference_matches_jax(tmp_path, agent):
    run_exp(f"vlnce_torch/config/experiments/{YAML}", "inference", _opts(tmp_path / "port", agent, 3))
    jax_nonlearning_inference(jax_get_config(f"vlnce_tpu/config/experiments/{YAML}", _opts(tmp_path / "jax", agent, 3)))
    with open(tmp_path / "port" / "predictions.json") as f, open(tmp_path / "jax" / "predictions.json") as jf:
        preds, jax_preds = json.load(f), json.load(jf)
    assert preds == jax_preds and len(preds) == 4
    assert all(len(steps) >= 2 and sorted(steps[0]) == ["heading", "position", "stop"] for steps in preds.values())
