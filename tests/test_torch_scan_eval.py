"""The port's closed loops on the device (trainers/scan_eval.py,
trainers/device_dagger.py) against the JAX package's, at small sizes on the
CPU, where the port's step runs eagerly and its kernels' wrappers run their
plain versions (the JAX side as its own tests run it).

- R2R CMA (16x16 frames, ResNet18s, vocab 64), greedy, weights carried by
  `state_dict_from_jax_params`: the same action sequences as
  `vlnce_tpu.trainers.scan_eval.run_scan_rollouts`, and measures within
  atol 1e-6, with SCAN_BATCH 3 over 4 episodes (a padded last chunk);
  the early exit between segments.
- RxR CMA at 48x64 frames (B2's plain version against Pallas interpret),
  through both trainers: per-episode measures within atol 1e-6 (so the same
  actions), and inference's predictions file equal to JAX's.
- The metrics replay against stepping the port's Env.
- On-device DAgger at beta 1.0 against JAX's payloads (prev_action and
  oracle exact, progress atol 1e-6, features atol 1e-4, the tolerance of
  tests/test_torch_dagger.py), the beta mix at 0.5 statistically, an
  episode whose STOP lands on a segment's last step, and the trainer end
  to end into its store.
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
from vlnce_tpu.envs import ensure_registered as jax_ensure_registered
from vlnce_tpu.envs import rl_envs as jax_rl_envs  # noqa: F401
from vlnce_tpu.tasks import sensors as jax_sensors
from vlnce_tpu.tasks.datasets import make_dataset as jax_make_dataset
from vlnce_tpu.trainers import device_dagger as jax_dagger
from vlnce_tpu.trainers import scan_eval as jax_scan
from vlnce_tpu.trainers.base_trainer import BaseVLNCETrainer as JaxTrainer
from vlnce_tpu.utils.checkpoints import save_checkpoint as jax_save_checkpoint
import vlnce_torch.tasks  # noqa: F401
from vlnce_torch.data.trajectory_store import TrajectoryStoreReader, store_length
from vlnce_torch.envs import Env, ensure_registered
from vlnce_torch.models.convert import state_dict_from_jax_params
from vlnce_torch.run import run_exp
from vlnce_torch.tasks import sensors as port_sensors
from vlnce_torch.tasks.datasets import make_dataset
from vlnce_torch.trainers import device_dagger, scan_eval
from vlnce_torch.utils.checkpoints import save_checkpoint

from tests.torch_port_cases import (
    JAX_RXR_CMA, R2R_CMA, R2R_SMALL_OPTS, RXR_CMA, SMALL_OPTS, build_pair, build_r2r_pair, configs,
)

jax_ensure_registered()
ensure_registered()

MEASURES = ["steps_taken", "path_length", "distance_to_goal", "success", "oracle_success", "spl", "ndtw"]
LOOP = [
    "TASK_CONFIG.DATASET.NUM_EPISODES", 4,
    "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", 6,
    "EVAL.SCAN_BATCH", 3,  # 4 episodes: the last chunk is padded
    "EVAL.SCAN_SEGMENT", 4,
    "EVAL.SAMPLE", False,
    "NUM_ENVIRONMENTS", 2,
]


@pytest.fixture(scope="module", autouse=True)
def stable_instruction_features():
    """Both packages' RxR sensors seed their synthetic instruction features
    from `hash(str)`, which Python salts per process: pin it, so that every
    run makes the same greedy choices (as tests/test_torch_eval.py does)."""
    patch = pytest.MonkeyPatch()
    for module in (jax_sensors, port_sensors):
        patch.setattr(module, "hash", lambda text: zlib.crc32(("a" + text).encode()), raising=False)
    yield
    patch.undo()


def _spread_head(params, gain=30.0, bias=None):
    """Seeded heads give logits that hardly move with the observation, so a
    greedy agent repeats one action: scale the head by `gain` and give it
    `bias`, so that the greedy action follows what the agent sees."""
    head = params["action_distribution"]
    head["kernel"] = (head["kernel"] * gain).astype(np.float32)
    if bias is not None:
        head["bias"] = np.asarray(bias, np.float32)


def _episodes(cfg, jcfg):
    eps = list(make_dataset(cfg.TASK_CONFIG.DATASET.TYPE, cfg.TASK_CONFIG.DATASET).episodes)
    jeps = list(jax_make_dataset(jcfg.TASK_CONFIG.DATASET.TYPE, jcfg.TASK_CONFIG.DATASET).episodes)
    assert [e.episode_id for e in eps] == [e.episode_id for e in jeps]
    return eps, jeps


@pytest.fixture(scope="module")
def r2r():
    (jax_policy, params), policy, (jcfg, cfg) = build_r2r_pair(seed=1, extra=LOOP)
    _spread_head(params, bias=[6.0, 3.0, 1.5, 1.5])
    jax_policy.params = params
    policy.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return jax_policy, policy, jcfg, cfg


def test_r2r_scan_rollouts_match_jax(r2r):
    jax_policy, policy, jcfg, cfg = r2r
    eps, jeps = _episodes(cfg, jcfg)
    want = jax_scan.run_scan_rollouts(jax_policy, [], jcfg, jeps, jax.random.PRNGKey(0))
    stats = {}
    got = scan_eval.run_scan_rollouts(policy, [], cfg, eps, stats=stats)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert len({len(a) for a in got}) > 1 and any((a == 1).any() for a in got)  # moved, and ended apart
    # 2 chunks (3 episodes, then 1 padded to 3) of at most 2 segments; one read-back each
    assert stats["batch"] == 3 and stats["seg_len"] == 4 and 2 <= stats["segments"] <= 4
    assert stats["readbacks"] == stats["segments"] and stats["replays"] == 4 * stats["segments"]
    assert stats["graph"] is False and stats["env_steps"] == sum(len(a) for a in got)

    jm = jax_scan.metrics_from_actions(jcfg, jeps, want)
    m = scan_eval.metrics_from_actions(cfg, eps, got)
    assert list(m) == list(jm)
    for ep_id, stats_ep in m.items():
        assert sorted(stats_ep) == sorted(jm[ep_id])
        for k, v in stats_ep.items():
            np.testing.assert_allclose(v, jm[ep_id][k], rtol=0, atol=1e-6, err_msg=f"{ep_id} {k}")


def test_segments_stop_early_once_every_episode_stopped(r2r):
    """A head that always chooses STOP: each chunk ends after its first
    segment, and each episode is the one STOP."""
    _, policy, _, cfg = r2r
    cfg = cfg.clone()
    cfg.defrost()
    cfg.EVAL.SCAN_SEGMENT = 2
    cfg.freeze()
    saved = policy.action_distribution.linear.bias.detach().clone()
    with torch.no_grad():
        policy.action_distribution.linear.bias.copy_(torch.tensor([1e4, 0.0, 0.0, 0.0]))
    try:
        stats = {}
        got = scan_eval.run_scan_rollouts(policy, [], cfg, list(make_dataset(cfg.TASK_CONFIG.DATASET.TYPE, cfg.TASK_CONFIG.DATASET).episodes), stats=stats)
    finally:
        with torch.no_grad():
            policy.action_distribution.linear.bias.copy_(saved)
    assert [a.tolist() for a in got] == [[0]] * 4
    assert stats["segments"] == 2 and stats["readbacks"] == 2  # one per chunk, of 3 possible each


def test_metrics_replay_matches_stepping_the_env(r2r):
    _, _, _, cfg = r2r
    task_cfg = cfg.TASK_CONFIG.clone()
    task_cfg.defrost()
    task_cfg.ENVIRONMENT.ITERATOR_OPTIONS.SHUFFLE = False
    task_cfg.freeze()
    env = Env(task_cfg)
    env.reset()
    episode = env.current_episode
    actions = [1, 2, 1, 1, 0]
    for a in actions:
        env.step(a)
        info = env.get_metrics()
        if env.episode_over:
            break
    env.close()
    replay = scan_eval.metrics_from_actions(cfg, [episode], [np.asarray(actions)])[episode.episode_id]
    host = {k: v for k, v in info.items() if np.isscalar(v) or isinstance(v, (int, float))}
    assert set(replay) == set(host)
    for k in host:
        np.testing.assert_allclose(replay[k], host[k], rtol=0, atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# RxR CMA through both trainers
# ---------------------------------------------------------------------------


def _rxr_opts(tmp):
    return LOOP + [
        "TASK_CONFIG.DATASET.TYPE", "Synthetic-VLN-v0", "TENSORBOARD_DIR", "", "LOG_FILE", "", "VERBOSE", False,
        "EVAL.EPISODE_COUNT", 4, "EVAL.USE_CKPT_CONFIG", False, "EVAL.ON_DEVICE_SCAN", True,
        "EVAL.SPLIT", "val_unseen", "INFERENCE.SAMPLE", False, "INFERENCE.USE_CKPT_CONFIG", False,
        "INFERENCE.SPLIT", "val_unseen",
        "INFERENCE.ON_DEVICE_SCAN", True, "INFERENCE.FORMAT", "r2r",
        "MODEL.INSTRUCTION_ENCODER.use_pretrained_embeddings", False,
        "RESULTS_DIR", f"{tmp}/evals",
    ]


@pytest.fixture(scope="module")
def rxr_checkpoints(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rxr")
    (_, _, params), _, cfg = build_pair(seed=3)
    _spread_head(params, gain=30.0, bias=[2.5, 3.0, 1.0, 1.0, 0.5, 0.5])
    jcfg, _ = configs()
    jax_path, port_path = str(tmp / "ckpt.0.ckpt"), str(tmp / "ckpt.0.pth")
    jax_save_checkpoint(jax_path, params, config=jcfg)
    save_checkpoint(port_path, state_dict_from_jax_params(params), config=cfg)
    return jax_path, port_path


class _NullWriter:
    def add_scalar(self, *args):
        pass


def test_rxr_scan_eval_and_inference_match_jax(tmp_path, rxr_checkpoints):
    from vlnce_tpu.config import get_config as jax_get_config

    jax_path, port_path = rxr_checkpoints
    jcfg = jax_get_config(JAX_RXR_CMA, SMALL_OPTS + ["TPU.PRECISION.compute_dtype", "float32", "TPU.MESH.DATA", 1]
                          + _rxr_opts(tmp_path / "jax") + ["INFERENCE.CKPT_PATH", jax_path,
                                                           "INFERENCE.PREDICTIONS_FILE", str(tmp_path / "jax.json")])
    jax_trainer = JaxTrainer(jcfg)
    jax_trainer._eval_checkpoint(jax_path, _NullWriter(), 0)
    jax_episodes = jax_trainer._last_eval_episode_stats
    jax_trainer.inference()

    port_opts = SMALL_OPTS + ["CUDA.DEVICE", "cpu", "CUDA.PRECISION.compute_dtype", "float32"] + _rxr_opts(tmp_path / "port")
    trainer = run_exp(RXR_CMA, "eval", port_opts + ["EVAL_CKPT_PATH_DIR", port_path])
    episodes = trainer._last_eval_episode_stats
    assert list(episodes) == list(jax_episodes) and len(episodes) == 4
    for ep_id, stats in episodes.items():
        assert sorted(stats) == sorted(MEASURES)
        for k in MEASURES:
            np.testing.assert_allclose(stats[k], jax_episodes[ep_id][k], rtol=0, atol=1e-6, err_msg=f"{ep_id} {k}")
    assert len({s["steps_taken"] for s in episodes.values()}) > 1 and max(s["path_length"] for s in episodes.values()) > 0
    timing = trainer.last_loop_timing
    assert timing["readbacks"] == timing["segments"] >= 2 and timing["graph"] is False
    with open(tmp_path / "port" / "evals" / "stats_ckpt_0_val_unseen.json") as f, \
            open(tmp_path / "jax" / "evals" / "stats_ckpt_0_val_unseen.json") as jf:
        written, jax_written = json.load(f), json.load(jf)
    assert sorted(written) == sorted(jax_written) == sorted(MEASURES)
    for k in MEASURES:
        np.testing.assert_allclose(written[k], jax_written[k], rtol=0, atol=1e-6)

    run_exp(RXR_CMA, "inference", port_opts + ["INFERENCE.CKPT_PATH", port_path,
                                                "INFERENCE.PREDICTIONS_FILE", str(tmp_path / "port.json")])
    with open(tmp_path / "port.json") as f, open(tmp_path / "jax.json") as jf:
        preds, jax_preds = json.load(f), json.load(jf)
    assert preds == jax_preds and len(preds) == 4
    for steps in preds.values():
        assert len(steps) >= 2 and all(sorted(s) == ["heading", "position", "stop"] for s in steps)


def test_rxr_scan_eval_with_video_matches_jax(tmp_path, rxr_checkpoints):
    """EVAL.ON_DEVICE_SCAN with VIDEO_OPTION [disk]: the host replay keeps its
    cameras and composes the frames. The port writes one video per episode
    under the JAX trainer's names (up to the extension) with as many frames
    as the JAX files, and its scalar metrics equal its run without video."""
    from vlnce_tpu.config import get_config as jax_get_config

    from tests.torch_port_cases import video_files

    jax_path, port_path = rxr_checkpoints
    video = ["VIDEO_OPTION", ["disk"], "TASK_CONFIG.TASK.TOP_DOWN_MAP_VLNCE.MAP_RESOLUTION", 256]
    jcfg = jax_get_config(JAX_RXR_CMA, SMALL_OPTS + ["TPU.PRECISION.compute_dtype", "float32", "TPU.MESH.DATA", 1]
                          + _rxr_opts(tmp_path / "jax") + video + ["VIDEO_DIR", str(tmp_path / "jax_videos")])
    jax_trainer = JaxTrainer(jcfg)
    jax_trainer._eval_checkpoint(jax_path, _NullWriter(), 0)
    port_opts = SMALL_OPTS + ["CUDA.DEVICE", "cpu", "CUDA.PRECISION.compute_dtype", "float32", "EVAL_CKPT_PATH_DIR", port_path]
    trainer = run_exp(RXR_CMA, "eval", port_opts + _rxr_opts(tmp_path / "port") + video
                      + ["VIDEO_DIR", str(tmp_path / "port_videos")])
    plain = run_exp(RXR_CMA, "eval", port_opts + _rxr_opts(tmp_path / "plain"))
    episodes = trainer._last_eval_episode_stats
    assert episodes == plain._last_eval_episode_stats and len(episodes) == 4
    for ep_id, stats in episodes.items():
        for k in MEASURES:
            np.testing.assert_allclose(stats[k], jax_trainer._last_eval_episode_stats[ep_id][k], rtol=0, atol=1e-6)
    port_videos, jax_videos = video_files(tmp_path / "port_videos"), video_files(tmp_path / "jax_videos")
    assert len(port_videos) == 4 and sorted(port_videos) == sorted(jax_videos)
    for name, frames in port_videos.items():
        assert frames.shape == jax_videos[name].shape, name
        assert frames.shape[0] == episodes[name.split("-")[0].split("=")[1]]["steps_taken"]


# ---------------------------------------------------------------------------
# on-device DAgger collection
# ---------------------------------------------------------------------------


def _dagger_configs(r2r, n_episodes=4, steps=6, envs=2, seg=4):
    _, _, jcfg, cfg = r2r
    jcfg, cfg = jcfg.clone(), cfg.clone()
    for c, tree in ((jcfg, "TPU"), (cfg, "CUDA")):
        c.defrost()
        c.TASK_CONFIG.DATASET.NUM_EPISODES = n_episodes
        c.TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS = steps
        c.NUM_ENVIRONMENTS = envs
        c[tree].DAGGER_SEGMENT = seg
        c.freeze()
    return jcfg, cfg


def test_dagger_collection_at_beta_1_matches_jax(r2r):
    jax_policy, policy, _, _ = r2r
    jcfg, cfg = _dagger_configs(r2r, n_episodes=5, envs=2, seg=4)
    eps, jeps = _episodes(cfg, jcfg)
    want = jax_dagger.collect_episodes_on_device(jax_policy, [], jcfg, jeps, 1.0, jax.random.PRNGKey(0))
    stats = {}
    got = device_dagger.collect_episodes_on_device(policy, [], cfg, eps, 1.0, torch.Generator().manual_seed(0),
                                                   stats=stats)
    assert len(got) == len(want) == 5
    for (obs, prev, oracle), (jobs, jprev, joracle) in zip(got, want):
        np.testing.assert_array_equal(prev, jprev)
        np.testing.assert_array_equal(oracle, joracle)
        assert prev.dtype == oracle.dtype == np.int64 and prev[0] == 0
        np.testing.assert_array_equal(prev[1:], oracle[:-1])  # beta 1: the expert's actions were taken
        assert sorted(obs) == sorted(jobs) == ["depth_features", "instruction", "progress", "rgb_features"]
        for k in obs:
            assert obs[k].shape == jobs[k].shape and obs[k].dtype == jobs[k].dtype, k
        np.testing.assert_array_equal(obs["instruction"], jobs["instruction"])
        np.testing.assert_allclose(obs["progress"], jobs["progress"], rtol=0, atol=1e-6)
        for k in ("rgb_features", "depth_features"):
            np.testing.assert_allclose(obs[k], jobs[k], rtol=0, atol=1e-4, err_msg=k)
    assert len({int(a) for _, _, o in got for a in o}) >= 3  # the expert turned and walked
    # 3 chunks (2, 2, 1 padded) of at most 2 segments, one read-back of the flags each, one bulk copy per chunk
    assert stats["readbacks"] == stats["segments"] and stats["chunk_readbacks"] == 3


def test_dagger_beta_mixing_statistics(r2r):
    """At beta 0.5 the executed actions agree with the expert at the rate
    0.5 + 0.5 * agree(0): the expert's share of the mix is beta, with the
    policy's chance agreement measured by the beta 0 run (the same policy,
    episodes and generator seed), as the JAX package's test holds it."""
    from vlnce_torch.envs.spaces import action_space_from_config, observation_space_from_config
    from vlnce_torch.models.cma_policy import CMAPolicy

    _, cfg = _dagger_configs(r2r, n_episodes=64, steps=16, envs=16, seg=8)
    # the seeded policy as built: its head's small gain draws near-uniform actions
    policy = CMAPolicy.from_config(cfg, observation_space_from_config(cfg.TASK_CONFIG), action_space_from_config(cfg.TASK_CONFIG))
    eps = list(make_dataset(cfg.TASK_CONFIG.DATASET.TYPE, cfg.TASK_CONFIG.DATASET).episodes)[:64]

    def agreement(beta):
        res = device_dagger.collect_episodes_on_device(policy, [], cfg, eps, beta, torch.Generator().manual_seed(42))
        agree = total = 0
        for _, prev, oracle in res:
            agree += int((prev[1:] == oracle[:-1]).sum())
            total += len(prev) - 1
        return agree / max(total, 1), total

    a0, n0 = agreement(0.0)
    a5, n5 = agreement(0.5)
    assert n0 > 150 and n5 > 100, (n0, n5)
    assert abs(a5 - (0.5 + 0.5 * a0)) < 0.09, (a5, a0)
    assert a5 > a0 + 0.15, (a5, a0)


def test_dagger_stop_on_a_segments_last_step(r2r):
    """An episode whose STOP lands on the last step of the final segment gets
    no done flag into done_before: its length is the recorded rows, and its
    payload equals a collection with one segment longer than the episode."""
    _, policy, _, _ = r2r
    _, cfg = _dagger_configs(r2r, n_episodes=1, steps=64, envs=1, seg=64)
    eps = list(make_dataset(cfg.TASK_CONFIG.DATASET.TYPE, cfg.TASK_CONFIG.DATASET).episodes)[:1]
    ref_obs, ref_prev, ref_oracle = device_dagger.collect_episodes_on_device(policy, [], cfg, eps, 1.0)[0]
    L = len(ref_prev)
    assert 2 <= L < 64, L
    cfg.defrost()
    cfg.CUDA.DAGGER_SEGMENT = L
    cfg.freeze()
    obs, prev, oracle = device_dagger.collect_episodes_on_device(policy, [], cfg, eps, 1.0)[0]
    np.testing.assert_array_equal(prev, ref_prev)
    np.testing.assert_array_equal(oracle, ref_oracle)
    for k in ref_obs:
        assert obs[k].shape == ref_obs[k].shape, k


def test_dagger_trainer_collects_on_device_into_its_store(tmp_path, r2r):
    """`--run-type train` with CUDA.ON_DEVICE_DAGGER: two rounds (beta 1,
    then 0.5) into the store and a checkpoint each; the first round's
    episodes are the first update_size of the split, collected at beta 1."""
    _, _, jcfg, _ = r2r
    opts = R2R_SMALL_OPTS + [
        "CUDA.DEVICE", "cpu", "CUDA.PRECISION.compute_dtype", "float32", "CUDA.ON_DEVICE_DAGGER", True,
        "CUDA.DAGGER_SEGMENT", 4, "TASK_CONFIG.DATASET.NUM_EPISODES", 4, "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", 6,
        "NUM_ENVIRONMENTS", 2, "IL.epochs", 1, "IL.batch_size", 2, "IL.DAGGER.iterations", 2, "IL.DAGGER.update_size", 3,
        "IL.DAGGER.p", 0.5, "IL.load_from_ckpt", False, "IL.DAGGER.lmdb_features_dir", str(tmp_path / "traj"),
        "CHECKPOINT_FOLDER", str(tmp_path / "ckpts"), "LOG_FILE", "", "VERBOSE", False,
    ]
    trainer = run_exp(R2R_CMA, "train", opts)
    assert sorted(p.name for p in (tmp_path / "ckpts").iterdir()) == ["ckpt.0.ckpt", "ckpt.1.ckpt"]
    assert [s["beta"] for s in trainer.collection_stats] == [1.0, 0.5]
    assert [s["episodes"] for s in trainer.collection_stats] == [3, 3]
    for s in trainer.collection_stats:
        assert s["readbacks"] == s["segments"] and s["env_steps"] > 0 and s["graph"] is False
    assert store_length(str(tmp_path / "traj")) == 6
    reader = TrajectoryStoreReader(str(tmp_path / "traj"))
    # round 0 (beta 1) against the JAX package's device expert on the same episodes
    jcfg = jcfg.clone()
    jcfg.defrost()
    jcfg.TASK_CONFIG.DATASET.NUM_EPISODES = 4
    jcfg.NUM_ENVIRONMENTS = 2
    jcfg.TPU.DAGGER_SEGMENT = 4
    jcfg.freeze()
    jeps = list(jax_make_dataset(jcfg.TASK_CONFIG.DATASET.TYPE, jcfg.TASK_CONFIG.DATASET).episodes)[:3]
    jax_policy = r2r[0]
    want = jax_dagger.collect_episodes_on_device(jax_policy, [], jcfg, jeps, 1.0, jax.random.PRNGKey(0))
    for k, (_, jprev, joracle) in enumerate(want):
        obs, prev, oracle = reader.get(k)
        np.testing.assert_array_equal(prev, jprev)
        np.testing.assert_array_equal(oracle, joracle)
        assert obs["rgb_features"].dtype == np.float32 and obs["rgb_features"].shape[0] == len(oracle)
    reader.close()
    assert trainer.loss_history and all(np.isfinite(l[2]) for l in trainer.loss_history)

    # the trained checkpoint through the scan eval and the scan inference of the CLI
    scan = opts + ["EVAL.ON_DEVICE_SCAN", True, "EVAL.SCAN_BATCH", 2, "EVAL.EPISODE_COUNT", 3, "EVAL.USE_CKPT_CONFIG", False,
                   "EVAL_CKPT_PATH_DIR", str(tmp_path / "ckpts" / "ckpt.1.ckpt"), "RESULTS_DIR", str(tmp_path / "evals"),
                   "INFERENCE.ON_DEVICE_SCAN", True, "INFERENCE.USE_CKPT_CONFIG", False, "INFERENCE.FORMAT", "r2r",
                   "INFERENCE.CKPT_PATH", str(tmp_path / "ckpts" / "ckpt.1.ckpt"),
                   "INFERENCE.PREDICTIONS_FILE", str(tmp_path / "preds.json")]
    evaluator = run_exp(R2R_CMA, "eval", scan)
    assert len(evaluator._last_eval_episode_stats) == 3
    head = "action_distribution.linear.weight"
    assert torch.equal(evaluator.policy.state_dict()[head], trainer.policy.state_dict()[head])
    with open(tmp_path / "evals" / "stats_ckpt_0_val_unseen.json") as f:
        assert sorted(json.load(f)) == sorted(MEASURES)
    run_exp(R2R_CMA, "inference", scan)
    with open(tmp_path / "preds.json") as f:
        preds = json.load(f)
    assert len(preds) >= 1 and all(sorted(s) == ["heading", "position", "stop"] for steps in preds.values() for s in steps)
