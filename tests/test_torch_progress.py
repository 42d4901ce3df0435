"""The port's small pieces beside the parity check: the progress reporter
(vlnce_torch/utils/progress.py) and its SLURM rule, the inference-merge
tool, and the SLURM launch scripts (vlnce_torch/sbatch_scripts/)."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from vlnce_tpu.trainers.base_trainer import is_slurm_batch_job as jax_is_slurm_batch_job
from vlnce_torch.trainers.base_trainer import is_slurm_batch_job
from vlnce_torch.utils.progress import tqdm, trange

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = "vlnce_torch/config/experiments/synthetic/smoke_seq2seq.yaml"


@pytest.mark.parametrize("job_id", [None, "4242"])
@pytest.mark.parametrize("pty_port", [None, "36001"])
def test_is_slurm_batch_job_matches_jax(monkeypatch, job_id, pty_port):
    for name, value in (("SLURM_JOB_ID", job_id), ("SLURM_PTY_PORT", pty_port)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    assert is_slurm_batch_job() == jax_is_slurm_batch_job() == (job_id is not None and pty_port is None)


def test_reporter_writes_to_stderr_only(monkeypatch, capsys):
    """Every way the loops use a bar: total and update, an iterable with its
    length, trange, a context manager, leave=False; a closed bar stays
    closed. Nothing reaches stdout."""
    from vlnce_torch.utils import progress

    monkeypatch.setattr(progress, "MININTERVAL", 0.0)
    pbar = tqdm(total=3, desc="eval ckpt 0", dynamic_ncols=True)
    for _ in range(3):
        pbar.update()
    pbar.close()
    pbar.close()
    assert list(tqdm({"a": 1, "b": 2}.items(), "GT Collection")) == [("a", 1), ("b", 2)]
    assert list(trange(2, dynamic_ncols=True)) == [0, 1]
    with tqdm(total=2, desc="inference") as bar:
        bar.update(2)
    assert list(tqdm(iter([5, 6]), leave=False)) == [5, 6]  # no length: a count without a bar
    out, err = capsys.readouterr()
    assert out == ""
    assert "eval ckpt 0: 100%|" in err and "3/3" in err and "GT Collection: 100%|" in err and "2/2" in err
    assert "inference: 100%|" in err and err.count("\n") == 4  # one line left per bar; leave=False clears its own


def test_reporter_throttles_and_disables(capsys):
    pbar = tqdm(total=1000, desc="throttled")  # MININTERVAL 0.1 s: the first draw, then nothing within 0.1 s
    for _ in range(999):
        pbar.update()
    drawn = capsys.readouterr().err
    assert drawn.count("throttled") == 1
    pbar.update()
    pbar.close()
    assert "1000/1000" in capsys.readouterr().err

    quiet = tqdm(total=2, desc="quiet", disable=True)
    quiet.update(2)
    quiet.close()
    assert quiet.n == 2
    assert list(tqdm(range(3), disable=True)) == [0, 1, 2]
    assert capsys.readouterr() == ("", "")


def _smoke_opts(tmp_path):
    img = 16
    return [
        "CUDA.DEVICE", "cpu", "CUDA.PRECISION.compute_dtype", "float32",
        "TASK_CONFIG.DATASET.NUM_EPISODES", 2, "TASK_CONFIG.DATASET.NUM_SCENES", 1,
        "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", 4, "NUM_ENVIRONMENTS", 1,
        "TASK_CONFIG.SIMULATOR.RGB_SENSOR.HEIGHT", img, "TASK_CONFIG.SIMULATOR.RGB_SENSOR.WIDTH", img,
        "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.HEIGHT", img, "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.WIDTH", img,
        "EVAL.EPISODE_COUNT", -1, "EVAL_CKPT_PATH_DIR", str(tmp_path / "none.pth"), "RESULTS_DIR", str(tmp_path / "evals"),
        "INFERENCE.CKPT_PATH", str(tmp_path / "none.pth"), "INFERENCE.SPLIT", "val_unseen",
        "INFERENCE.PREDICTIONS_FILE", str(tmp_path / "predictions.json"), "INFERENCE.FORMAT", "r2r",
        "TENSORBOARD_DIR", "", "LOG_FILE", "", "VERBOSE", False,
    ]


@pytest.mark.parametrize("slurm", [False, True])
def test_host_eval_bars_off_under_slurm_batch_jobs(monkeypatch, capsys, tmp_path, slurm):
    """The host eval and inference loops draw their bars on stderr, and
    none under a SLURM batch job, where the JAX loops turn theirs off."""
    from vlnce_torch.run import run_exp

    monkeypatch.setenv("VLNCE_TORCH_THREADED_ENVS", "1")
    monkeypatch.delenv("SLURM_PTY_PORT", raising=False)
    if slurm:
        monkeypatch.setenv("SLURM_JOB_ID", "4242")
    else:
        monkeypatch.delenv("SLURM_JOB_ID", raising=False)
    capsys.readouterr()
    run_exp(SMOKE, "eval", _smoke_opts(tmp_path))
    run_exp(SMOKE, "inference", _smoke_opts(tmp_path))
    out, err = capsys.readouterr()
    assert (tmp_path / "evals" / "stats_ckpt_0_val_unseen.json").exists() and (tmp_path / "predictions.json").exists()
    assert "eval ckpt" not in out and "%|" not in out
    if slurm:
        assert "eval ckpt" not in err and "inference:" not in err and "%|" not in err
    else:
        assert "eval ckpt 0: 100%|" in err and "inference: 100%|" in err


def _merge_inputs(tmp_path, rng):
    """Two RxR JSONL files and two R2R JSON files of seeded predictions."""
    rxr, r2r = [], []
    ids = rng.permutation(1000)[:12]
    for k in range(2):
        path = tmp_path / f"rxr_{k}.jsonl"
        with open(path, "w") as f:
            for i in ids[6 * k : 6 * k + 6]:
                steps = rng.randint(1, 5)
                f.write(json.dumps({"instruction_id": int(i), "path": rng.normal(size=(steps, 3)).round(4).tolist()}) + "\n")
            f.write("\n")  # a blank line is skipped
        rxr.append(str(path))
        path = tmp_path / f"r2r_{k}.json"
        with open(path, "w") as f:
            json.dump({str(i): [{"position": rng.normal(size=3).tolist(), "heading": float(rng.uniform()),
                                 "stop": bool(rng.randint(2))}] for i in ids[6 * k : 6 * k + 6]}, f)
        r2r.append(str(path))
    return rxr, r2r


def test_merge_tool_matches_root_script(monkeypatch, capsys, tmp_path):
    """Byte for byte the root script's files and message, for both formats;
    both refuse a duplicate id with the same error."""
    import scripts.merge_inference_predictions as jax_merge
    from vlnce_torch.scripts.merge_inference_predictions import main

    rxr, r2r = _merge_inputs(tmp_path, np.random.RandomState(7))
    for fmt, inputs in (("rxr", rxr), ("r2r", r2r)):
        outputs = {}
        for pkg in ("root", "port"):
            out = str(tmp_path / f"{pkg}_merged_{fmt}")
            argv = ["--format", fmt, "--out", out, *inputs]
            if pkg == "root":
                monkeypatch.setattr(sys, "argv", ["merge_inference_predictions.py", *argv])
                jax_merge.main()
            else:
                main(argv)
            with open(out, "rb") as f:
                outputs[pkg] = (f.read(), capsys.readouterr().out.replace(out, "<out>"))
        assert outputs["port"] == outputs["root"] and outputs["root"][1] == "merged 12 predictions -> <out>\n"
        errors = []
        for pkg in ("root", "port"):
            argv = ["--format", fmt, "--out", str(tmp_path / "dup"), inputs[0], inputs[0]]
            with pytest.raises(ValueError) as e:
                if pkg == "root":
                    monkeypatch.setattr(sys, "argv", ["merge_inference_predictions.py", *argv])
                    jax_merge.main()
                else:
                    main(argv)
            errors.append(str(e.value))
        assert errors[0] == errors[1] and "duplicate" in errors[0]


SBATCH = ("cluster_example.sh", "waypoint_train.sh", "waypoint_train_single_node.sh")


@pytest.mark.parametrize("name", SBATCH)
def test_launch_scripts_run_the_port(name):
    """Each script keeps the JAX script's job name, output, nodes, tasks,
    CPUs, time, requeue signal and open mode, gives each task its card or
    cards, runs `-m vlnce_torch.run` on a YAML of the port that its opts
    parse against, names nothing of the JAX package, and is valid bash."""
    from vlnce_torch.config import get_config

    path = os.path.join(REPO, "vlnce_torch", "sbatch_scripts", name)
    with open(path) as f:
        text = f.read()
    with open(os.path.join(REPO, "sbatch_scripts", name)) as f:
        jax_text = f.read()
    assert "vlnce_tpu" not in text and "TPU." not in text and "run.py" not in text
    sbatch = set(re.findall(r"^#SBATCH .*$", text, re.M))
    assert set(re.findall(r"^#SBATCH .*$", jax_text, re.M)) <= sbatch
    assert any(line.startswith("#SBATCH --gpus-per-task") for line in sbatch)
    assert "#SBATCH --signal=USR1@600" in sbatch
    assert "-m vlnce_torch.run" in text and "srun -u" in text
    command = re.search(r"--exp-config\s+(\S+)\s*\\\s*\n\s*--run-type\s+(\w+)((?:\s*\\\s*\n[^\n']*)*)", text)
    exp, run_type, rest = command.group(1), command.group(2), command.group(3)
    assert run_type == "train" and exp.startswith("vlnce_torch/config/experiments/") and os.path.exists(os.path.join(REPO, exp))
    opts = [o for o in rest.replace("\\", " ").split() if o != "&"]  # the single-node task starts torchrun in the background
    cfg = get_config(os.path.join(REPO, exp), opts or None)
    if "waypoint" in name:
        assert opts == ["CUDA.MESH.DATA", "-1"] and cfg.CUDA.MESH.DATA == -1 and cfg.TRAINER_NAME == "ddppo-waypoint"
    else:
        assert opts == [] and cfg.TRAINER_NAME == "dagger"
    if name == "waypoint_train_single_node.sh":
        assert "torchrun --standalone --nproc_per_node" in text
    assert subprocess.run(["bash", "-n", path], capture_output=True).returncode == 0
