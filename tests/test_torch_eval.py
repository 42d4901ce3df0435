"""The serving slice as a whole: the port's eval and inference loops against
the JAX trainer's, on weights carried across with
`state_dict_from_jax_params`.

Both run the RxR CMA policy at the small widths of tests/torch_port_cases.py,
greedy, in f32 (the port with `CUDA.DEVICE cpu`, so its kernels' wrappers run
their plain versions; the JAX side as its own tests run it), over in-process
envs, 2 at a time, each from its own checkpoint file. Checked: the same
episode ids in the same order, per-episode measures within atol 1e-6, equal
r2r and rxr prediction files. The act steps agree to 1e-4
(tests/test_torch_cma_act.py), so the test also asserts that every greedy
choice on the JAX side was made by a top-two logit margin above 1e-3: no
action can have flipped unseen.
"""

import json
import zlib

import numpy as np
import pytest
import torch

import jax

import vlnce_tpu.models  # noqa: F401
import vlnce_tpu.tasks  # noqa: F401
import vlnce_tpu.trainers  # noqa: F401
from vlnce_tpu.config import get_config as jax_get_config
from vlnce_tpu.envs import ensure_registered as jax_ensure_registered
from vlnce_tpu.envs import rl_envs as jax_rl_envs  # noqa: F401
from vlnce_tpu.ops.obs_transforms import apply_obs_transforms_batch as jax_apply_batch
from vlnce_tpu.trainers.base_trainer import BaseVLNCETrainer as JaxTrainer
from vlnce_tpu.utils.checkpoints import save_checkpoint as jax_save_checkpoint
import vlnce_torch.tasks  # noqa: F401
from vlnce_tpu.tasks import sensors as jax_sensors
from vlnce_torch.tasks import sensors as port_sensors
from vlnce_torch.config import get_config
from vlnce_torch.envs import Env
from vlnce_torch.envs.batch import stack_obs
from vlnce_torch.models.convert import state_dict_from_jax_params
from vlnce_torch.registry import registry
from vlnce_torch.run import run_exp
from vlnce_torch.trainers.base_trainer import make_fused_act_step
from vlnce_torch.utils.checkpoints import save_checkpoint

from tests.torch_port_cases import JAX_RXR_CMA, RXR_CMA, SMALL_OPTS, build_pair, configs, video_files

jax_ensure_registered()

N_ENVS = 2
MEASURES = ["steps_taken", "path_length", "distance_to_goal", "success", "oracle_success", "spl", "ndtw"]


class _NullWriter:
    def add_scalar(self, *args):
        pass


class _MarginRecordingJaxTrainer(JaxTrainer):
    """The JAX trainer, also recording each act step's top-two logit margins."""

    def __init__(self, config):
        super().__init__(config)
        self.margins = []

    def _make_fused_act_step(self):
        fused = super()._make_fused_act_step()
        policy, transforms = self.policy, self.obs_transforms

        @jax.jit
        def logits_of(params, obs, rnn_states, prev_actions, masks):
            batch = jax_apply_batch(obs, transforms)
            return policy.module.apply({"params": params}, batch, rnn_states, prev_actions, masks)[0]

        def step(params, obs, rnn_states, prev_actions, masks, rng, deterministic):
            top = np.sort(np.asarray(logits_of(params, obs, rnn_states, prev_actions, masks)), axis=-1)
            self.margins.append(top[:, -1] - top[:, -2])
            return fused(params, obs, rnn_states, prev_actions, masks, rng, deterministic)

        return step


def _jax_config(opts):
    return jax_get_config(JAX_RXR_CMA, SMALL_OPTS + ["TPU.PRECISION.compute_dtype", "float32", "TPU.MESH.DATA", 1] + opts)


def _loop_opts(tmp, extra=()):
    return [
        "TASK_CONFIG.DATASET.TYPE", "Synthetic-VLN-v0",
        "TASK_CONFIG.DATASET.NUM_EPISODES", 8,
        "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", 12,
        "NUM_ENVIRONMENTS", N_ENVS,
        "TENSORBOARD_DIR", "",
        "LOG_FILE", "",
        "VERBOSE", False,
        "EVAL.SAMPLE", False,
        "EVAL.EPISODE_COUNT", 5,
        "EVAL.USE_CKPT_CONFIG", False,
        "INFERENCE.SAMPLE", False,
        "INFERENCE.USE_CKPT_CONFIG", False,
        "INFERENCE.SPLIT", "val_unseen",
        # the JAX trainer's optimizer mask looks for a pretrained embedding
        # table to freeze, which the BERT-feature encoder does not have
        "MODEL.INSTRUCTION_ENCODER.use_pretrained_embeddings", False,
        *extra,
    ]


def _spread_actions(params, policy, transforms, cfg, gain=30.0):
    """Seeded weights give logits that hardly move with the observation, so a
    greedy agent repeats one action. Centre the head's bias on the mean logits
    over 8 start observations and scale the head by `gain`: the greedy action
    then follows what the agent sees, and episodes differ in length and path."""
    task_config = cfg.TASK_CONFIG.clone().defrost()
    task_config.DATASET.TYPE = "Synthetic-VLN-v0"
    env = Env(task_config)
    obs = {k: torch.from_numpy(v) for k, v in stack_obs([env.reset() for _ in range(8)]).items()}
    env.close()
    logits = make_fused_act_step(policy, transforms)(
        obs, policy.initial_rnn_states(8), torch.zeros(8, 1, dtype=torch.long), torch.zeros(8, 1), True)[2]
    head = params["action_distribution"]
    head["bias"] = ((head["bias"] - logits.mean(0).numpy()) * gain).astype(np.float32)
    head["kernel"] = (head["kernel"] * gain).astype(np.float32)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """One set of seeded weights as a checkpoint file of each package."""
    tmp = tmp_path_factory.mktemp("ckpts")
    (_, _, params), (policy, transforms), cfg = build_pair(seed=3)
    _spread_actions(params, policy, transforms, cfg)
    jcfg, _ = configs()
    jax_path, port_path = str(tmp / "jax" / "ckpt.0.ckpt"), str(tmp / "port" / "ckpt.0.pth")
    jax_save_checkpoint(jax_path, params, config=jcfg)
    save_checkpoint(port_path, state_dict_from_jax_params(params), config=cfg)
    return jax_path, port_path


HASH_PREFIX = "a"  # with it the narrowest greedy margin on the JAX side is 5.5e-3


@pytest.fixture(scope="module", autouse=True)
def stable_instruction_features():
    """Both packages' RxR sensors seed their synthetic instruction features
    from `hash(str)`, which Python salts per process, so the agents' greedy
    choices, and how narrow their closest margin is, changed from run to run
    (about every third salt puts one choice on a margin below the act step's
    tolerance, which the tests below refuse). Pin the hash for this module
    (the envs run in-process), so that every run makes the same choices."""
    patch = pytest.MonkeyPatch()
    for module in (jax_sensors, port_sensors):
        patch.setattr(module, "hash", lambda text: zlib.crc32((HASH_PREFIX + text).encode()), raising=False)
    yield
    patch.undo()


@pytest.fixture(autouse=True)
def threaded_envs(monkeypatch):
    monkeypatch.setenv("VLNCE_TPU_THREADED_ENVS", "1")
    monkeypatch.setenv("VLNCE_TORCH_THREADED_ENVS", "1")


def test_eval_matches_jax_trainer(tmp_path, checkpoints):
    jax_path, port_path = checkpoints
    jcfg = _jax_config(_loop_opts(tmp_path, ["RESULTS_DIR", str(tmp_path / "jax_evals")]))
    jax_trainer = _MarginRecordingJaxTrainer(jcfg)
    jax_stats = jax_trainer._eval_checkpoint(jax_path, _NullWriter(), 0)
    jax_episodes = jax_trainer._last_eval_episode_stats

    opts = SMALL_OPTS + _loop_opts(tmp_path, [
        "CUDA.DEVICE", "cpu", "CUDA.PRECISION.compute_dtype", "float32",
        "RESULTS_DIR", str(tmp_path / "port_evals"), "EVAL_CKPT_PATH_DIR", port_path,
    ])
    trainer = run_exp(RXR_CMA, "eval", opts)
    episodes = trainer._last_eval_episode_stats

    margins = np.concatenate(jax_trainer.margins)
    print(f"smallest top-two margin on the JAX side: {margins.min():.3e} over {margins.size} choices")
    assert margins.min() > 1e-3, f"a greedy choice on the JAX side hung on a margin of {margins.min():.2e}"
    assert type(trainer) is registry.get_trainer("recollect_trainer") and trainer.policy.device.type == "cpu"
    assert list(episodes) == list(jax_episodes)
    assert 5 <= len(episodes) <= 5 + N_ENVS - 1
    for ep_id, stats in episodes.items():
        assert sorted(stats) == sorted(MEASURES)
        for k in MEASURES:
            np.testing.assert_allclose(stats[k], jax_episodes[ep_id][k], rtol=0, atol=1e-6, err_msg=f"episode {ep_id} {k}")
    # the agent really moved, and episodes ended both by STOP and by the step limit
    assert len({s["steps_taken"] for s in episodes.values()}) > 2 and max(s["path_length"] for s in episodes.values()) > 0

    with open(tmp_path / "port_evals" / "stats_ckpt_0_val_unseen.json") as f:
        written = json.load(f)
    with open(tmp_path / "jax_evals" / "stats_ckpt_0_val_unseen.json") as f:
        jax_written = json.load(f)
    assert sorted(written) == sorted(jax_written) == sorted(MEASURES)
    for k in MEASURES:
        np.testing.assert_allclose(written[k], jax_written[k], rtol=0, atol=1e-6)
        np.testing.assert_allclose(written[k], jax_stats[k], rtol=0, atol=1e-6)

    timing = trainer.last_loop_timing
    assert timing["act_steps"] == len(jax_trainer.margins) and timing["env_steps"] <= N_ENVS * timing["act_steps"]
    assert timing["pth_time"] > 0 and timing["env_time"] > 0

    # a second run finds the stats file and skips; a directory is polled
    again = run_exp(RXR_CMA, "eval", opts)
    assert again.policy is None


@pytest.mark.parametrize("fmt", ["r2r", "rxr"])
def test_inference_matches_jax_trainer(tmp_path, checkpoints, fmt):
    jax_path, port_path = checkpoints
    extra = ["INFERENCE.FORMAT", fmt, "TASK_CONFIG.DATASET.NUM_EPISODES", 4]
    jax_file, port_file = str(tmp_path / f"jax_preds.{fmt}"), str(tmp_path / f"port_preds.{fmt}")
    jcfg = _jax_config(_loop_opts(tmp_path, extra + ["INFERENCE.CKPT_PATH", jax_path, "INFERENCE.PREDICTIONS_FILE", jax_file]))
    jax_trainer = _MarginRecordingJaxTrainer(jcfg)
    jax_trainer.inference()

    run_exp(RXR_CMA, "inference", SMALL_OPTS + _loop_opts(tmp_path, extra + [
        "CUDA.DEVICE", "cpu", "CUDA.PRECISION.compute_dtype", "float32",
        "INFERENCE.CKPT_PATH", port_path, "INFERENCE.PREDICTIONS_FILE", port_file]))

    assert np.concatenate(jax_trainer.margins).min() > 1e-3
    if fmt == "r2r":
        with open(port_file) as f, open(jax_file) as jf:
            preds, jax_preds = json.load(f), json.load(jf)
        assert preds == jax_preds and len(preds) == 4
        for steps in preds.values():
            assert len(steps) >= 2 and all(sorted(s) == ["heading", "position", "stop"] for s in steps)
    else:
        with open(port_file) as f, open(jax_file) as jf:
            lines, jax_lines = [json.loads(l) for l in f], [json.loads(l) for l in jf]
        assert lines == jax_lines and len(lines) == 4
        for entry in lines:
            assert sorted(entry) == ["instruction_id", "path"]
            assert all(a != b for a, b in zip(entry["path"][:-1], entry["path"][1:]))


def test_eval_polls_a_directory_in_mtime_order(tmp_path, checkpoints):
    import os
    import shutil

    _, port_path = checkpoints
    ckpts = tmp_path / "ckpts"
    ckpts.mkdir()
    for age, name in enumerate(["ckpt.9.pth", "ckpt.1.pth"]):
        shutil.copy(port_path, ckpts / name)
        os.utime(ckpts / name, (2000 + age, 2000 + age))
    run_exp(RXR_CMA, "eval", SMALL_OPTS + _loop_opts(tmp_path, [
        "CUDA.DEVICE", "cpu", "CUDA.PRECISION.compute_dtype", "float32", "EVAL.EPISODE_COUNT", 2,
        "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", 3,
        "RESULTS_DIR", str(tmp_path / "evals"), "EVAL_CKPT_PATH_DIR", str(ckpts)]))
    assert sorted(os.listdir(tmp_path / "evals")) == ["stats_ckpt_0_val_unseen.json", "stats_ckpt_1_val_unseen.json"]


def test_eval_of_a_directory_of_jax_checkpoints(tmp_path, checkpoints):
    """`run --run-type eval` over a directory of files the JAX package wrote
    (`.ckpt` and `.msgpack`, both flax msgpack) gives the JAX eval's measures.
    The files carry a config that differs from the run's (6 steps per
    episode against 12) and EVAL.USE_CKPT_CONFIG is on: both packages
    evaluate under the file's config."""
    import os
    import shutil

    jax_path, _ = checkpoints
    params = _jax_params(jax_path)
    file_cfg = _jax_config(_loop_opts(tmp_path, ["TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", 6]))
    ckpts = tmp_path / "jax_ckpts"
    jax_save_checkpoint(str(ckpts / "ckpt.0.ckpt"), params, config=file_cfg)
    shutil.copy(ckpts / "ckpt.0.ckpt", ckpts / "ckpt.1.msgpack")
    for age, name in enumerate(["ckpt.0.ckpt", "ckpt.1.msgpack"]):
        os.utime(ckpts / name, (3000 + age, 3000 + age))

    jax_trainer = _MarginRecordingJaxTrainer(_jax_config(_loop_opts(tmp_path, [
        "EVAL.USE_CKPT_CONFIG", True, "RESULTS_DIR", str(tmp_path / "jax_evals")])))
    jax_stats = jax_trainer._eval_checkpoint(str(ckpts / "ckpt.0.ckpt"), _NullWriter(), 0)
    jax_episodes = jax_trainer._last_eval_episode_stats
    assert np.concatenate(jax_trainer.margins).min() > 1e-3

    trainer = run_exp(RXR_CMA, "eval", SMALL_OPTS + _loop_opts(tmp_path, [
        "CUDA.DEVICE", "cpu", "CUDA.PRECISION.compute_dtype", "float32", "EVAL.USE_CKPT_CONFIG", True,
        "RESULTS_DIR", str(tmp_path / "port_evals"), "EVAL_CKPT_PATH_DIR", str(ckpts)]))
    assert sorted(os.listdir(tmp_path / "port_evals")) == ["stats_ckpt_0_val_unseen.json", "stats_ckpt_1_val_unseen.json"]
    episodes = trainer._last_eval_episode_stats
    assert list(episodes) == list(jax_episodes)
    # the file's config ran: no episode took more than its 6 steps, some took all of them
    assert max(s["steps_taken"] for s in episodes.values()) == 6
    for ep_id, stats in episodes.items():
        for k in MEASURES:
            np.testing.assert_allclose(stats[k], jax_episodes[ep_id][k], rtol=0, atol=1e-6, err_msg=f"episode {ep_id} {k}")
    for index in (0, 1):
        with open(tmp_path / "port_evals" / f"stats_ckpt_{index}_val_unseen.json") as f:
            written = json.load(f)
        for k in MEASURES:
            np.testing.assert_allclose(written[k], jax_stats[k], rtol=0, atol=1e-6)


def _jax_params(path):
    from vlnce_tpu.utils.checkpoints import load_checkpoint as jax_load_checkpoint

    return jax_load_checkpoint(path)["state_dict"]


@pytest.mark.parametrize("opts,match", [
    # the scan eval and its feature-bank route run since the device-resident loops came, and on imported scene
    # geometry since the scene import came: the case runs the scan eval on an export of the split's scenes
    pytest.param(["EVAL.ON_DEVICE_SCAN", True, "TASK_CONFIG.SIMULATOR.GEOMETRY_DIR", "{geometry}"],
                 "GEOMETRY_DIR", id="opts0-ON_DEVICE_SCAN"),
    (["VIDEO_OPTION", ["disk"]], "VIDEO_OPTION"),
    # the nonlearning agents run since their port came
    (["EVAL.EVAL_NONLEARNING", True], "nonlearning"),
])
def test_parts_that_wait_raise_and_name_the_roadmap(tmp_path, checkpoints, opts, match):
    """Each case raised naming the roadmap until its part came, and now runs:
    the scan eval over imported geometry (every scene it ran is an
    ImportedScene away from the origin, not the procedural fallback of a
    missing export), the nonlearning agent's eval, each writing its stats
    file, and VIDEO_OPTION, held against the JAX trainer's eval with video
    (`_assert_video_eval_matches_jax`)."""
    from vlnce_torch.tasks.datasets import make_dataset

    from tests.torch_port_cases import SceneRegistrySnapshot, assert_imported, export_synthetic_geometry

    _, port_path = checkpoints
    opts = [str(tmp_path / "geometry") if o == "{geometry}" else o for o in opts]
    run_opts = SMALL_OPTS + _loop_opts(tmp_path, [
        "CUDA.DEVICE", "cpu", "CUDA.PRECISION.compute_dtype", "float32",
        "RESULTS_DIR", str(tmp_path / "evals"), "EVAL_CKPT_PATH_DIR", port_path, *opts])
    if match == "VIDEO_OPTION":
        _assert_video_eval_matches_jax(tmp_path, checkpoints, run_opts)
        return
    with SceneRegistrySnapshot():
        if match == "GEOMETRY_DIR":
            split = get_config(RXR_CMA, run_opts).TASK_CONFIG.DATASET.clone()
            split.defrost()
            split.SPLIT = "val_unseen"
            scene_ids = {e.scene_id for e in make_dataset(split.TYPE, split).episodes}
            export_synthetic_geometry(str(tmp_path / "geometry"), scene_ids)
        trainer = run_exp(RXR_CMA, "eval", run_opts)
        if match == "GEOMETRY_DIR":
            assert trainer.last_loop_timing["env_steps"] > 0
            assert_imported(scene_ids)
            assert (tmp_path / "evals" / "stats_ckpt_0_val_unseen.json").exists()
        else:
            assert trainer is None and (tmp_path / "evals" / "stats_RandomAgent_val_unseen.json").exists()


def _assert_video_eval_matches_jax(tmp_path, checkpoints, run_opts):
    """VIDEO_OPTION [disk]: the JAX trainer's eval and the port's write one
    video per episode under the same names (up to the extension) with the
    same number and shape of frames; the port's episodes and scalar metrics
    equal those of its run without video, and JAX's."""
    jax_path, port_path = checkpoints
    video_opts = ["VIDEO_OPTION", ["disk"], "VIDEO_DIR", str(tmp_path / "port_videos")]
    trainer = run_exp(RXR_CMA, "eval", run_opts + video_opts)
    with_video = trainer._last_eval_episode_stats
    plain = run_exp(RXR_CMA, "eval", [o if o != str(tmp_path / "evals") else str(tmp_path / "plain_evals") for o in run_opts])
    assert list(with_video) == list(plain._last_eval_episode_stats)
    for ep_id, stats in with_video.items():
        assert stats == plain._last_eval_episode_stats[ep_id], ep_id
    jcfg = _jax_config(_loop_opts(tmp_path, ["RESULTS_DIR", str(tmp_path / "jax_evals"),
                                             "VIDEO_OPTION", ["disk"], "VIDEO_DIR", str(tmp_path / "jax_videos")]))
    jax_trainer = JaxTrainer(jcfg)
    jax_trainer._eval_checkpoint(jax_path, _NullWriter(), 0)
    for ep_id, stats in with_video.items():
        for k in MEASURES:
            np.testing.assert_allclose(stats[k], jax_trainer._last_eval_episode_stats[ep_id][k], rtol=0, atol=1e-6)
    port_videos, jax_videos = video_files(tmp_path / "port_videos"), video_files(tmp_path / "jax_videos")
    assert len(port_videos) == len(with_video) and sorted(port_videos) == sorted(jax_videos)
    for name, frames in port_videos.items():
        assert frames.shape == jax_videos[name].shape, name
        assert frames.shape[0] == with_video[name.split("-")[0].split("=")[1]]["steps_taken"]
        assert frames.dtype == np.uint8 and frames.std() > 0
    assert (tmp_path / "evals" / "stats_ckpt_0_val_unseen.json").exists()


def test_trainer_checkpoint_carries_its_config_into_eval(tmp_path, checkpoints):
    """`save_checkpoint` writes weights + config into CHECKPOINT_FOLDER; with
    EVAL.USE_CKPT_CONFIG the eval builds the (small) model and task from the
    file's config, under the current run's EVAL, RESULTS_DIR, NUM_ENVIRONMENTS
    and CUDA settings."""
    _, port_path = checkpoints
    first = run_exp(RXR_CMA, "eval", SMALL_OPTS + _loop_opts(tmp_path, [
        "CUDA.DEVICE", "cpu", "CUDA.PRECISION.compute_dtype", "float32", "EVAL.EPISODE_COUNT", 2,
        "CHECKPOINT_FOLDER", str(tmp_path / "ckpts"), "NUM_ENVIRONMENTS", 1,
        "RESULTS_DIR", str(tmp_path / "first"), "EVAL_CKPT_PATH_DIR", port_path]))
    first.save_checkpoint("ckpt.7.pth", extra_state={"epoch": 7})
    saved = first.load_checkpoint(str(tmp_path / "ckpts" / "ckpt.7.pth"))
    assert saved["extra_state"] == {"epoch": 7} and "NUM_ENVIRONMENTS: 1" in saved["config_yaml"]

    # no model or frame sizes on this command line: they come from the file
    second = run_exp(RXR_CMA, "eval", [
        "CUDA.DEVICE", "cpu", "CUDA.PRECISION.compute_dtype", "float32",
        "EVAL.USE_CKPT_CONFIG", True, "EVAL.SAMPLE", False, "EVAL.EPISODE_COUNT", 3, "NUM_ENVIRONMENTS", N_ENVS,
        "TENSORBOARD_DIR", "", "LOG_FILE", "", "VERBOSE", False,
        "RESULTS_DIR", str(tmp_path / "second"), "EVAL_CKPT_PATH_DIR", str(tmp_path / "ckpts" / "ckpt.7.pth")])
    assert second.policy.hidden_size == 64 and second.policy.device.type == "cpu"
    assert 3 <= len(second._last_eval_episode_stats) <= 3 + N_ENVS - 1
    assert (tmp_path / "second" / "stats_ckpt_0_val_unseen.json").exists()
    for k, v in first.policy.state_dict().items():
        assert torch.equal(second.policy.state_dict()[k], v), k
