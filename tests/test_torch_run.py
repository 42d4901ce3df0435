"""`python -m vlnce_torch.run` as a user calls it: in a subprocess, with
forked env workers, on the CPU only because the command line says so."""

import json
import os
import subprocess
import sys

import pytest

from tests.torch_port_cases import R2R_CMA, R2R_SEQ2SEQ, R2R_SMALL_OPTS, RXR_CMA, RXR_SEQ2SEQ, SEQ2SEQ_SMALL_OPTS, SMALL_OPTS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEASURES = ["distance_to_goal", "ndtw", "oracle_success", "path_length", "spl", "steps_taken", "success"]


def _cli(value) -> str:
    return value if isinstance(value, str) else json.dumps(value)


def _command(run_type, tmp_path, extra=(), exp=RXR_CMA, small=SMALL_OPTS):
    """The command line and environment of one `python -m vlnce_torch.run`."""
    opts = small + [
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
    env["OMP_NUM_THREADS"] = "1"  # the command and its forked workers share the cores with the other test processes
    return [sys.executable, "-m", "vlnce_torch.run", "--exp-config", exp, "--run-type", run_type, *map(_cli, opts)], env


def _run(run_type, tmp_path, extra=(), exp=RXR_CMA, small=SMALL_OPTS):
    args, env = _command(run_type, tmp_path, extra, exp, small)
    return subprocess.run(args, cwd=REPO, env=env, capture_output=True, text=True, timeout=300)


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


@pytest.mark.parametrize("exp", [RXR_CMA, RXR_SEQ2SEQ], ids=["rxr_cma_en", "rxr_seq2seq"])
def test_recollect_train_on_the_cpu_leaves_a_checkpoint(tmp_path, exp):
    """`--run-type train` of an RxR baseline (TRAINER_NAME recollect_trainer)
    with forked workers: GT actions from the shortest-path oracle (no GT
    file), re-simulated frames, two batches accumulated per Adam step; then
    `--run-type eval` scores the checkpoint."""
    import torch

    train = [
        "TASK_CONFIG.DATASET.NUM_EPISODES", 4, "IL.batch_size", 2, "IL.epochs", 1,
        "IL.RECOLLECT_TRAINER.preload_size", 2, "IL.RECOLLECT_TRAINER.effective_batch_size", 4,
        "IL.RECOLLECT_TRAINER.trajectories_file", str(tmp_path / "trajectories.json.gz"),
        "IL.RECOLLECT_TRAINER.gt_file", str(tmp_path / "no_gt_{split}_{role}.json.gz"),
        "CHECKPOINT_FOLDER", str(tmp_path / "checkpoints"),
    ]
    out = _run("train", tmp_path, CPU + train, exp=exp)
    assert out.returncode == 0, out.stderr[-2000:]
    assert os.listdir(tmp_path / "checkpoints") == ["ckpt.0.ckpt"]
    ckpt = torch.load(tmp_path / "checkpoints" / "ckpt.0.ckpt", weights_only=True)
    assert ckpt["extra_state"] == {"epoch": 0, "step_id": 2} and len(ckpt["optim_state"]["state"]) > 0
    log = (tmp_path / "run.log").read_text()
    assert "deriving GT actions from the shortest-path oracle" in log and "[recollect epoch 0] mean_loss=" in log

    out = _run("eval", tmp_path, CPU + ["EVAL_CKPT_PATH_DIR", str(tmp_path / "checkpoints" / "ckpt.0.ckpt")], exp=exp)
    assert out.returncode == 0, out.stderr[-2000:]
    with open(tmp_path / "evals" / "stats_ckpt_0_val_unseen.json") as f:
        assert sorted(json.load(f)) == MEASURES


@pytest.mark.parametrize("name", ["rxr_cma_hi", "rxr_cma_te", "rxr_seq2seq"])
def test_rxr_baselines_evaluate_and_infer_on_the_cpu(tmp_path, name):
    """The other RxR baselines serve as rxr_cma_en.yaml does: eval writes the
    seven measures, inference the rxr predictions."""
    exp = f"vlnce_torch/config/experiments/rxr_baselines/{name}.yaml"
    out = _run("eval", tmp_path, CPU, exp=exp)
    assert out.returncode == 0, out.stderr[-2000:]
    with open(tmp_path / "evals" / "stats_ckpt_0_val_unseen.json") as f:
        assert sorted(json.load(f)) == MEASURES
    out = _run("inference", tmp_path, CPU + ["TASK_CONFIG.DATASET.NUM_EPISODES", 2], exp=exp)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [json.loads(line) for line in open(tmp_path / "predictions.jsonl")]
    assert len(lines) == 2 and all(sorted(entry) == ["instruction_id", "path"] for entry in lines)


def test_dagger_train_then_eval_of_its_checkpoint(tmp_path):
    """`--run-type train` of the R2R CMA DAgger recipe with forked workers:
    two rounds (beta 1, then 0.5) leave a store, a checkpoint per epoch with
    optimizer state, and `--run-type eval` scores the last one."""
    import torch

    from vlnce_torch.data.trajectory_store import store_length

    train = [
        "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", 6, "IL.load_from_ckpt", False, "IL.DAGGER.iterations", 2,
        "IL.DAGGER.update_size", 4, "IL.epochs", 1, "IL.batch_size", 2, "CUDA.PIPELINED_COLLECTION", True,
        "IL.DAGGER.lmdb_features_dir", str(tmp_path / "trajectories"), "CHECKPOINT_FOLDER", str(tmp_path / "checkpoints"),
    ]
    out = _run("train", tmp_path, CPU + train, exp=R2R_CMA, small=R2R_SMALL_OPTS)
    assert out.returncode == 0, out.stderr[-2000:]
    assert store_length(str(tmp_path / "trajectories")) >= 8
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["ckpt.0.ckpt", "ckpt.1.ckpt"]
    ckpt = torch.load(tmp_path / "checkpoints" / "ckpt.1.ckpt", weights_only=True)
    assert ckpt["extra_state"]["dagger_it"] == 1 and len(ckpt["optim_state"]["state"]) > 0
    log = (tmp_path / "run.log").read_text()
    assert "[collection it 0] 4 episodes" in log and "[dagger it 1 epoch 0] loss=" in log

    out = _run("eval", tmp_path, CPU + ["EVAL_CKPT_PATH_DIR", str(tmp_path / "checkpoints" / "ckpt.1.ckpt"), "EVAL.USE_CKPT_CONFIG", False],
               exp=R2R_CMA, small=R2R_SMALL_OPTS)
    assert out.returncode == 0, out.stderr[-2000:]
    with open(tmp_path / "evals" / "stats_ckpt_0_val_unseen.json") as f:
        stats = json.load(f)
    assert sorted(stats) == MEASURES
    assert "Loaded weights from checkpoint" in (tmp_path / "run.log").read_text()


def test_seq2seq_dagger_train_then_eval_of_its_checkpoint(tmp_path):
    """seq2seq_pm.yaml (with the prev-action embedding): DAgger collection
    stores the Seq2Seq encoders' features (the unpooled depth map, the
    pooled RGB vector), one epoch trains on them, and eval scores the
    checkpoint."""
    from vlnce_torch.data.trajectory_store import TrajectoryStoreReader

    train = [
        "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", 6, "IL.load_from_ckpt", False, "IL.DAGGER.iterations", 1,
        "IL.DAGGER.update_size", 4, "IL.epochs", 1, "IL.batch_size", 2,
        "IL.DAGGER.lmdb_features_dir", str(tmp_path / "trajectories"), "CHECKPOINT_FOLDER", str(tmp_path / "checkpoints"),
    ]
    out = _run("train", tmp_path, CPU + train, exp=R2R_SEQ2SEQ, small=SEQ2SEQ_SMALL_OPTS)
    assert out.returncode == 0, out.stderr[-2000:]
    reader = TrajectoryStoreReader(str(tmp_path / "trajectories"))
    obs, _, oracle = reader.get(0)
    assert obs["rgb_features"].shape == (len(oracle), 512, 1, 1) and obs["depth_features"].ndim == 4
    reader.close()
    assert os.listdir(tmp_path / "checkpoints") == ["ckpt.0.ckpt"]
    out = _run("eval", tmp_path, CPU + ["EVAL_CKPT_PATH_DIR", str(tmp_path / "checkpoints" / "ckpt.0.ckpt")],
               exp=R2R_SEQ2SEQ, small=SEQ2SEQ_SMALL_OPTS)
    assert out.returncode == 0, out.stderr[-2000:]
    with open(tmp_path / "evals" / "stats_ckpt_0_val_unseen.json") as f:
        assert sorted(json.load(f)) == MEASURES
    assert "Initialized policy Seq2SeqPolicy on cpu" in (tmp_path / "run.log").read_text()


WAYPOINT_SMOKE = "vlnce_torch/config/experiments/synthetic/smoke_waypoint.yaml"
WAYPOINT_MEASURES = sorted(MEASURES + ["waypoint_reward_measure"])


def test_waypoint_train_then_eval_of_its_checkpoint(tmp_path):
    """`--run-type train` of the synthetic waypoint experiment (TRAINER_NAME
    ddppo-waypoint: 2 updates of PPO over 2 forked workers, the two-group
    pipelined rollout), a checkpoint per update with its update counter and
    optimizer state; then `--run-type eval` of the last one over forked
    workers on VLNCEWaypointEnv."""
    import torch

    train = ["CHECKPOINT_FOLDER", str(tmp_path / "checkpoints"), "CUDA.PIPELINED_COLLECTION", True]
    out = _run("train", tmp_path, CPU + train, exp=WAYPOINT_SMOKE, small=[])
    assert out.returncode == 0, out.stderr[-2000:]
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["ckpt.0.ckpt", "ckpt.1.ckpt"]
    ckpt = torch.load(tmp_path / "checkpoints" / "ckpt.1.ckpt", weights_only=True)
    assert ckpt["extra_state"] == {"update": 1, "count_steps": 16} and len(ckpt["optim_state"]["state"]) > 0
    log = (tmp_path / "run.log").read_text()
    assert "Initialized WaypointPolicy on cpu" in log and "update 1\tfps" in log and "value_loss" in log

    out = _run("eval", tmp_path, CPU + ["EVAL_CKPT_PATH_DIR", str(tmp_path / "checkpoints" / "ckpt.1.ckpt")],
               exp=WAYPOINT_SMOKE, small=[])
    assert out.returncode == 0, out.stderr[-2000:]
    with open(tmp_path / "evals" / "stats_ckpt_0_val_unseen.json") as f:
        assert sorted(json.load(f)) == WAYPOINT_MEASURES
    assert "Loaded waypoint policy from" in (tmp_path / "run.log").read_text()


def test_waypoint_requeue_writes_the_state_and_resumes_from_it(tmp_path):
    """SIGUSR1 to a training run (the SLURM preemption signal) makes it stop
    at the next update and write its state to RL.DDPPO.requeue_path; a run
    with RL.DDPPO.start_from_requeue resumes from that update."""
    import signal
    import time

    import torch

    state = tmp_path / "interrupted_state.pth"
    ckpts = tmp_path / "checkpoints"
    common = CPU + ["CHECKPOINT_FOLDER", str(ckpts), "RL.DDPPO.requeue_path", str(state), "CUDA.ASYNC_CHECKPOINT", False]
    args, env = _command("train", tmp_path, common + ["RL.NUM_UPDATES", 200], exp=WAYPOINT_SMOKE, small=[])
    proc = subprocess.Popen(args, cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 240
        while not (ckpts / "ckpt.0.ckpt").exists() and proc.poll() is None and time.time() < deadline:
            time.sleep(0.05)
        assert proc.poll() is None, proc.stderr.read()[-2000:]
        proc.send_signal(signal.SIGUSR1)
        _, err = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err[-2000:]
    saved = torch.load(state, weights_only=True)
    update = saved["extra_state"]["update"]
    assert 1 <= update < 200 and saved["extra_state"]["count_steps"] == 8 * update
    assert len(saved["optim_state"]["state"]) > 0
    assert "Saved interrupted state for requeue" in (tmp_path / "run.log").read_text()

    out = _run("train", tmp_path, common + ["RL.NUM_UPDATES", update + 1, "RL.DDPPO.start_from_requeue", True],
               exp=WAYPOINT_SMOKE, small=[])
    assert out.returncode == 0, out.stderr[-2000:]
    assert f"Resumed from requeue state at update {update}" in (tmp_path / "run.log").read_text()
    resumed = torch.load(ckpts / f"ckpt.{update}.ckpt", weights_only=True)
    assert resumed["extra_state"] == {"update": update, "count_steps": 8 * (update + 1)}


def test_default_device_is_the_card(tmp_path):
    """Without `CUDA.DEVICE cpu` the entry point goes for the card; on a
    machine without one it fails instead of quietly running on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the failure is what a machine without one shows")
    out = _run("eval", tmp_path)
    assert out.returncode != 0 and not (tmp_path / "evals" / "stats_ckpt_0_val_unseen.json").exists()
    assert "cuda" in out.stderr.lower()
