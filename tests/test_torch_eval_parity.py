"""The port's asset-day parity check (vlnce_torch/scripts/eval_parity.py)
against the JAX package's (scripts/eval_parity.py), on the CPU.

The fixture is the JAX package's own dry run
(tests/test_scene_import.py::test_eval_parity_asset_day_dryrun):
smoke_seq2seq.yaml at 16x16 frames, 2 val_unseen episodes of at most 6
steps, a connectivity pickle of 2 m lattice graphs over the split's scenes,
and one checkpoint saved by the JAX DAgger trainer, which the port reads.
Each package's eval_parity runs on its own copy of the inputs, in f32 with in-process envs.

- Both give the same exit code, write the same stats files, and
  give the same host-loop and scan-eval stats: `success` exactly, every
  other measure within 1e-6 (both packages compute the measures in f64 on
  the host from the same actions; the features differ within f32 rounding).
  The bank route passes `--resident-tolerance 2.0`, as the JAX dry run does:
  its features are looked up at the graph's nodes and headings, so its
  episodes may legitimately differ from the host loop's.
- The failure paths: expected numbers a full point off, and a stats file
  that already exists, return 1 in both.
- The rendered route: per episode, the host loop's actions equal the scan
  loop's on the imported scenes, for the smoke Seq2Seq and for RxR CMA
  at small widths (the configuration whose resident-vs-host comparison the
  card holds at eval_parity's default 0.02).
"""

import json
import os
import pickle
import shutil
import sys

import numpy as np
import pytest

import vlnce_tpu.models  # noqa: F401
import vlnce_tpu.tasks  # noqa: F401
import vlnce_tpu.trainers  # noqa: F401
from vlnce_tpu.config import get_config as jax_get_config
from vlnce_tpu.envs import ensure_registered as jax_ensure_registered
from vlnce_tpu.envs import rl_envs as jax_rl_envs  # noqa: F401
from vlnce_tpu.registry import registry as jax_registry
from vlnce_tpu.tasks.datasets import make_dataset as jax_make_dataset
from vlnce_tpu.utils.nav_graph import synthetic_lattice_graph
from vlnce_torch.envs.scene_import import _scene_stem

from tests.torch_port_cases import RXR_CMA, SMALL_OPTS, SceneRegistrySnapshot, build_pair

JAX_YAML = "vlnce_tpu/config/experiments/synthetic/smoke_seq2seq.yaml"
YAML = "vlnce_torch/config/experiments/synthetic/smoke_seq2seq.yaml"
IMG = 16
SPLIT = "val_unseen"


def _opts(tmp):
    """tests/test_scene_import.py's dry-run options, under `tmp`."""
    return [
        "TASK_CONFIG.DATASET.NUM_EPISODES", "2",
        "TASK_CONFIG.DATASET.NUM_SCENES", "1",
        "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "6",
        "TASK_CONFIG.SIMULATOR.RGB_SENSOR.HEIGHT", str(IMG),
        "TASK_CONFIG.SIMULATOR.RGB_SENSOR.WIDTH", str(IMG),
        "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.HEIGHT", str(IMG),
        "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.WIDTH", str(IMG),
        "NUM_ENVIRONMENTS", "2",
        "EVAL.SCAN_BATCH", "2",
        "EVAL.SCAN_SEGMENT", "4",
        "IL.DAGGER.lmdb_features_dir", f"{tmp}/traj",
        "RESULTS_DIR", f"{tmp}/evals",
        "CHECKPOINT_FOLDER", f"{tmp}/ckpts",
        "EVAL_CKPT_PATH_DIR", f"{tmp}/ckpts",
    ]


@pytest.fixture
def logs():
    """The lines both packages' loggers write while the test runs."""
    import logging

    from vlnce_tpu.utils.logging import logger as jax_logger
    from vlnce_torch.utils.logging import logger

    lines = []

    class Lines(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    handler = Lines()
    for lg in (jax_logger, logger):
        lg.addHandler(handler)
    yield lines
    for lg in (jax_logger, logger):
        lg.removeHandler(handler)


@pytest.fixture(autouse=True)
def clean_scene_registry(monkeypatch):
    monkeypatch.setenv("VLNCE_TPU_THREADED_ENVS", "1")
    monkeypatch.setenv("VLNCE_TORCH_THREADED_ENVS", "1")
    with SceneRegistrySnapshot():
        yield


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The JAX DAgger trainer's checkpoint of its seeded Seq2Seq policy, and a
    connectivity pickle over the scenes of both splits."""
    jax_ensure_registered()
    tmp = str(tmp_path_factory.mktemp("inputs"))
    cfg = jax_get_config(JAX_YAML, _opts(tmp))
    stems = set()
    for split in ("train", SPLIT):
        ds_cfg = cfg.TASK_CONFIG.DATASET.clone()
        ds_cfg.defrost()
        ds_cfg.SPLIT = split
        ds_cfg.freeze()
        stems |= {_scene_stem(ep.scene_id) for ep in jax_make_dataset(ds_cfg.TYPE, ds_cfg).episodes}
    with open(f"{tmp}/connectivity_graphs.pkl", "wb") as f:
        pickle.dump({stem: synthetic_lattice_graph(world_size=16.0, spacing=2.0) for stem in stems}, f)

    from vlnce_tpu.utils.checkpoints import wait_for_pending

    trainer = jax_registry.get_trainer("dagger")(cfg)
    obs_space, act_space = trainer._get_spaces(cfg)
    trainer._initialize_policy(cfg, load_from_ckpt=False, observation_space=obs_space, action_space=act_space)
    os.makedirs(f"{tmp}/ckpts", exist_ok=True)
    trainer.save_checkpoint("ckpt.0.ckpt")
    wait_for_pending()
    assert os.path.exists(f"{tmp}/ckpts/ckpt.0.ckpt")
    return tmp


def _copy_inputs(inputs, tmp):
    os.makedirs(f"{tmp}/ckpts")
    shutil.copy(f"{inputs}/ckpts/ckpt.0.ckpt", f"{tmp}/ckpts/ckpt.0.ckpt")
    shutil.copy(f"{inputs}/connectivity_graphs.pkl", f"{tmp}/connectivity_graphs.pkl")


def _run_both(monkeypatch, inputs, tmp_path, flags, opts_of=lambda tmp: []):
    """Each package's eval_parity on its own copy of the inputs; returns {package: (rc, tmp)}.
    `flags` is a function of the copy's directory."""
    import scripts.eval_parity as jax_parity
    from vlnce_torch.scripts.eval_parity import main

    out = {}
    for pkg in ("jax", "torch"):
        tmp = str(tmp_path / pkg)
        _copy_inputs(inputs, tmp)
        yaml = JAX_YAML if pkg == "jax" else YAML
        dtype = ["TPU.PRECISION.compute_dtype", "float32"] if pkg == "jax" else [
            "CUDA.DEVICE", "cpu", "CUDA.PRECISION.compute_dtype", "float32"]
        argv = ["--exp-config", yaml, "--checkpoint", f"{tmp}/ckpts/ckpt.0.ckpt", "--split", SPLIT] + flags(tmp) + (
            _opts(tmp) + dtype + opts_of(tmp))
        if pkg == "jax":
            monkeypatch.setattr(sys, "argv", ["eval_parity.py"] + argv)
            rc = jax_parity.main()
        else:
            rc = main(argv)
        out[pkg] = (rc, tmp)
    return out


def _stats_files(tmp):
    """{path relative to RESULTS_DIR: stats} of every stats file written."""
    out = {}
    root = f"{tmp}/evals"
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.endswith(".json"):
                with open(os.path.join(dirpath, name)) as f:
                    out[os.path.relpath(os.path.join(dirpath, name), root)] = json.load(f)
    return out


def _assert_same_stats(got, want):
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    for name in want:
        assert sorted(got[name]) == sorted(want[name]), name
        for k, v in want[name].items():
            if k == "success":
                assert got[name][k] == v, (name, k)
            else:
                np.testing.assert_allclose(got[name][k], v, rtol=0, atol=1e-6, err_msg=f"{name} {k}")


@pytest.mark.parametrize("route", ["bank", "rendered"])
def test_eval_parity_matches_jax(monkeypatch, inputs, tmp_path, logs, route):
    """The whole `--resident` flow in both packages: geometry export from the
    connectivity pickle, (on the bank route) the feature banks of the
    checkpoint's frozen encoders, the host-loop eval, the scan eval and the
    host-vs-resident comparison. eval_parity passes its opts to the bank
    generator, so the banks are encoded by the checkpoint named there (the
    seeded encoders of the two packages are different draws)."""

    def flags(tmp):
        out = ["--resident", "--geometry-dir", f"{tmp}/geom", "--connectivity", f"{tmp}/connectivity_graphs.pkl"]
        if route == "bank":
            out += ["--bank-dir", f"{tmp}/bank", "--bank-headings", "4", "--resident-tolerance", "2.0"]
        return out

    def opts_of(tmp):
        return ["IL.load_from_ckpt", "True", "IL.ckpt_to_load", f"{tmp}/ckpts/ckpt.0.ckpt"] if route == "bank" else []

    runs = _run_both(monkeypatch, inputs, tmp_path, flags, opts_of)
    log = "\n".join(logs)
    (jax_rc, jax_tmp), (rc, tmp) = runs["jax"], runs["torch"]
    assert rc == jax_rc == 0, log[-3000:]
    assert log.count("PARITY OK") == 2 and "[resident-vs-host] spl" in log
    assert sorted(os.listdir(f"{tmp}/geom")) == sorted(os.listdir(f"{jax_tmp}/geom")) != []
    if route == "bank":
        assert sorted(os.listdir(f"{tmp}/bank")) == sorted(os.listdir(f"{jax_tmp}/bank")) != []
    got, want = _stats_files(tmp), _stats_files(jax_tmp)
    assert sorted(got) == [f"resident/stats_ckpt_0_{SPLIT}.json", f"stats_ckpt_0_{SPLIT}.json"]
    _assert_same_stats(got, want)
    _assert_imported(f"{tmp}/connectivity_graphs.pkl")


def _assert_imported(connectivity):
    """The port ran the exported scenes (the fixture's lattice lies at the
    origin, so unlike `assert_imported` this checks the type only)."""
    from vlnce_torch.envs.gridworld import get_scene
    from vlnce_torch.envs.scene_import import ImportedScene

    with open(connectivity, "rb") as f:
        for stem in pickle.load(f):
            assert isinstance(get_scene(f"synthetic/{stem}.glb"), ImportedScene), stem


@pytest.mark.parametrize("failure", ["expected_off", "stats_exist"])
def test_eval_parity_failures_match_jax(monkeypatch, inputs, tmp_path, logs, failure):
    """Expected numbers a full point (1.0) off the host SPL, and a stats
    file that already exists, return 1 in both packages."""
    if failure == "expected_off":
        # the untrained policy's host SPL lies in [0, 1]: 1.5 is at least 0.5 away,
        # -1.0 is a full point below any SPL of 0
        runs = _run_both(monkeypatch, inputs, tmp_path, lambda tmp: ["--expected-spl", "1.5", "--expected-ndtw", "-1.0"])
        log = "\n".join(logs)
        assert log.count("PARITY FAILED for: ['host:spl', 'host:ndtw']") == 2, log[-3000:]
    else:
        def flags(tmp):
            os.makedirs(f"{tmp}/evals")
            with open(f"{tmp}/evals/stats_ckpt_0_{SPLIT}.json", "w") as f:
                f.write("{}")
            return []

        runs = _run_both(monkeypatch, inputs, tmp_path, flags)
        log = "\n".join(logs)
        assert log.count("eval skipped (stats file already exists)") == 2, log[-3000:]
    assert runs["jax"][0] == runs["torch"][0] == 1


def _record_host_actions(monkeypatch):
    """{episode id: {env index: actions}} of the host eval loop, read where it
    steps its envs (two envs over one scene both run its episodes)."""
    from vlnce_torch.trainers import base_trainer

    actions = {}
    real = base_trainer._ActLoop.step_envs

    def step_envs(self, envs, active_ids, actions_np):
        episodes = envs.current_episodes()
        for i in active_ids:
            actions.setdefault(episodes[i].episode_id, {}).setdefault(i, []).append(int(actions_np[i]))
        return real(self, envs, active_ids, actions_np)

    monkeypatch.setattr(base_trainer._ActLoop, "step_envs", step_envs)
    return actions


def _record_scan_actions(monkeypatch):
    """{episode id: actions} of the scan eval's rollouts on the card's world."""
    from vlnce_torch.trainers import scan_eval

    actions = {}
    real = scan_eval.run_scan_rollouts

    def run_scan_rollouts(policy, transforms, config, episodes, *args, **kwargs):
        seqs = real(policy, transforms, config, episodes, *args, **kwargs)
        actions.update({ep.episode_id: [int(a) for a in seq] for ep, seq in zip(episodes, seqs)})
        return seqs

    monkeypatch.setattr(scan_eval, "run_scan_rollouts", run_scan_rollouts)
    return actions


@pytest.mark.parametrize("exp", ["smoke_seq2seq", "rxr_cma"])
def test_rendered_route_actions_equal_host_loop(monkeypatch, inputs, tmp_path, exp):
    """The rendered route (`--resident` without a bank) on the imported
    scenes: per episode, the host eval loop's actions equal the scan loop's,
    greedy, in f32, for the smoke Seq2Seq and for RxR CMA at small widths
    (4 episodes of at most 12 steps, one scene per chunk)."""
    from vlnce_torch.config import get_config
    from vlnce_torch.run import run_exp
    from vlnce_torch.scripts.export_scene_geometry import main as export_main
    from vlnce_torch.tasks.datasets import make_dataset

    if exp == "smoke_seq2seq":
        yaml, opts = YAML, _opts(str(tmp_path)) + ["EVAL_CKPT_PATH_DIR", f"{inputs}/ckpts/ckpt.0.ckpt"]
    else:
        yaml, opts = RXR_CMA, SMALL_OPTS + [
            "TASK_CONFIG.DATASET.TYPE", "Synthetic-VLN-v0", "TASK_CONFIG.DATASET.NUM_EPISODES", 4,
            "TASK_CONFIG.DATASET.NUM_SCENES", 1, "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", 12,
            "NUM_ENVIRONMENTS", 2, "EVAL.SCAN_BATCH", 2, "EVAL.SCAN_SEGMENT", 4,
            "RESULTS_DIR", str(tmp_path / "evals"), "EVAL_CKPT_PATH_DIR", str(tmp_path / "rxr.pth"),
        ]
        # perturbed weights with a unit-gain head (tests/torch_port_cases.py), so the actions vary along a path
        from vlnce_torch.utils.checkpoints import save_checkpoint

        _, (policy, _), cfg = build_pair(seed=6)
        save_checkpoint(str(tmp_path / "rxr.pth"), policy.state_dict(), config=cfg)
    # the fixture's lattice over this split's scenes, exported by the port's CLI
    dataset = get_config(yaml, opts + ["TASK_CONFIG.DATASET.SPLIT", SPLIT]).TASK_CONFIG.DATASET
    stems = {_scene_stem(ep.scene_id) for ep in make_dataset(dataset.TYPE, dataset).episodes}
    connectivity, geometry = str(tmp_path / "graphs.pkl"), str(tmp_path / "geom")
    with open(connectivity, "wb") as f:
        pickle.dump({stem: synthetic_lattice_graph(world_size=16.0, spacing=2.0) for stem in stems}, f)
    export_main(["--out-dir", geometry, "--connectivity", connectivity])
    opts = opts + ["CUDA.DEVICE", "cpu", "CUDA.PRECISION.compute_dtype", "float32", "EVAL.SAMPLE", False,
                   "EVAL.SPLIT", SPLIT, "EVAL.EPISODE_COUNT", -1, "EVAL.USE_CKPT_CONFIG", False,
                   "TASK_CONFIG.SIMULATOR.GEOMETRY_DIR", geometry, "TENSORBOARD_DIR", "", "LOG_FILE", ""]
    host = _record_host_actions(monkeypatch)
    run_exp(yaml, "eval", opts)
    scan = _record_scan_actions(monkeypatch)
    run_exp(yaml, "eval", opts + ["EVAL.ON_DEVICE_SCAN", True, "RESULTS_DIR", str(tmp_path / "evals" / "resident")])
    assert sorted(host) == sorted(scan) and len(scan) >= 2, (sorted(host), sorted(scan))
    # episode -> (env, the first step at which the host loop's action differs)
    differ = {ep: (i, next(t for t, (a, b) in enumerate(zip(seq + [None], scan[ep] + [None])) if a != b))
              for ep in scan for i, seq in host[ep].items() if seq != scan[ep]}
    _assert_imported(connectivity)
    assert not differ, f"episodes whose actions differ, at the first differing step: {differ}; {host} {scan}"
