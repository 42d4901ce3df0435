"""The port's DAgger trainer against the JAX package's, at a small size on
the CPU (ResNet18s, H=64, 16x16 frames, 2 in-process envs, episodes of 6
steps): what collection stores, the first training losses, checkpoints with
optimizer state, the requeue, the beta mix, and the asynchronous writer.

Both trainers load the same weights from a checkpoint (the JAX package's
msgpack file and the port's torch file of one perturbed parameter set), so
`IL.load_from_ckpt` is on and the first collection round runs at beta =
p ** 1. Tolerances: stored features 1e-4 (two frameworks' ResNets); losses
rtol 1e-3 (they pass through those features and an Adam step each).
"""

import os
import threading

import numpy as np
import pytest
import torch

import vlnce_tpu.models  # noqa: F401
import vlnce_tpu.tasks  # noqa: F401
import vlnce_tpu.trainers  # noqa: F401
import vlnce_torch.models.cma_policy  # noqa: F401
import vlnce_torch.tasks  # noqa: F401
import vlnce_torch.trainers  # noqa: F401
from vlnce_tpu.config import get_config as jax_get_config
from vlnce_tpu.data.trajectory_store import TrajectoryStoreReader as JaxReader
from vlnce_tpu.envs import ensure_registered as jax_ensure_registered
from vlnce_tpu.envs import rl_envs as jax_rl_envs  # noqa: F401
from vlnce_tpu.ops.obs_transforms import get_active_obs_transforms as jax_get_transforms
from vlnce_tpu.registry import registry as jax_registry
from vlnce_tpu.utils.checkpoints import save_checkpoint as jax_save_checkpoint
from vlnce_torch.config import get_config
from vlnce_torch.data.trajectory_store import TrajectoryStoreReader, store_length
from vlnce_torch.envs import ensure_registered
from vlnce_torch.envs import rl_envs  # noqa: F401
from vlnce_torch.registry import registry
from vlnce_torch.trainers import dagger_trainer
from vlnce_torch.utils import checkpoints
from vlnce_torch.utils.checkpoints import load_checkpoint, save_checkpoint, wait_for_pending

from tests.torch_port_cases import JAX_R2R_CMA, R2R_CMA, R2R_SMALL_OPTS, build_r2r_pair

jax_ensure_registered()
ensure_registered()

EPISODES = 6  # IL.DAGGER.update_size: three batches of two


def _opts(tmp, extra=()):
    return R2R_SMALL_OPTS + [
        "TASK_CONFIG.DATASET.NUM_EPISODES", 8,
        "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", 6,
        "NUM_ENVIRONMENTS", 2,
        "IL.epochs", 1, "IL.batch_size", 2, "IL.DAGGER.iterations", 1, "IL.DAGGER.update_size", EPISODES,
        "IL.DAGGER.p", 1.0, "IL.load_from_ckpt", True,
        "IL.DAGGER.lmdb_features_dir", f"{tmp}/trajectories", "CHECKPOINT_FOLDER", f"{tmp}/checkpoints",
        "EVAL_CKPT_PATH_DIR", f"{tmp}/checkpoints/ckpt.0.ckpt", "RESULTS_DIR", f"{tmp}/evals",
        "EVAL.EPISODE_COUNT", 2, "EVAL.USE_CKPT_CONFIG", False, "VERBOSE", False,
        *extra,
    ]


def _jax_trainer(tmp, ckpt, extra=()):
    cfg = jax_get_config(JAX_R2R_CMA, _opts(tmp, ["TPU.PRECISION.compute_dtype", "float32", "IL.ckpt_to_load", ckpt, *extra]))
    return jax_registry.get_trainer("dagger")(cfg)


def _torch_trainer(tmp, ckpt, extra=()):
    cfg = get_config(R2R_CMA, _opts(tmp, ["CUDA.DEVICE", "cpu", "CUDA.PRECISION.compute_dtype", "float32", "IL.ckpt_to_load", ckpt, *extra]))
    return registry.get_trainer("dagger")(cfg)


def _jax_setup(trainer):
    """What the JAX trainer's `train` does before its first collection round."""
    from vlnce_tpu.data.trajectory_store import TrajectoryStoreWriter

    TrajectoryStoreWriter(trainer.features_dir, drop_existing=True).close()
    config = trainer.config.defrost()
    config.TASK_CONFIG.TASK.SENSORS.append(config.IL.DAGGER.expert_policy_sensor)
    if config.IL.DAGGER.p == 1.0:
        config.TASK_CONFIG.ENVIRONMENT.ITERATOR_OPTIONS.MAX_SCENE_REPEAT_STEPS = -1
    config.freeze()
    trainer.config = config
    trainer.obs_transforms = jax_get_transforms(config)
    observation_space, action_space = trainer._get_spaces(config)
    trainer._initialize_policy(config, True, observation_space, action_space)


def _record_updates(trainer):
    """Keep every batch handed to `_update_agent` and the triple it returns."""
    seen = []
    update = trainer._update_agent

    def recording(observations, prev_actions, masks, corrected, weights, **kw):
        triple = update(observations, prev_actions, masks, corrected, weights, **kw)
        seen.append(({k: np.asarray(v) for k, v in observations.items()}, np.asarray(prev_actions), np.asarray(corrected),
                     np.asarray(weights), triple, np.asarray(masks)))
        return triple

    trainer._update_agent = recording
    return seen


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both trainers' `train()` from the same weights: one collection round
    at beta 1 (teacher forcing) and one epoch of three batches."""
    tmp = tmp_path_factory.mktemp("dagger")
    patch = pytest.MonkeyPatch()
    patch.setenv("VLNCE_TPU_THREADED_ENVS", "1")
    patch.setenv("VLNCE_TORCH_THREADED_ENVS", "1")
    (_, params), policy, _ = build_r2r_pair(seed=3)
    jax_ckpt, torch_ckpt = str(tmp / "start.jax.ckpt"), str(tmp / "start.torch.ckpt")
    jax_save_checkpoint(jax_ckpt, params)
    save_checkpoint(torch_ckpt, policy.state_dict())

    out = {"tmp": tmp, "jax_ckpt": jax_ckpt, "torch_ckpt": torch_ckpt, "start": {k: v.clone() for k, v in policy.state_dict().items()}}
    jax_trainer = _jax_trainer(tmp / "jax", jax_ckpt)
    out["jax_updates"] = _record_updates(jax_trainer)
    jax_trainer.train()
    trainer = _torch_trainer(tmp / "torch", torch_ckpt)
    out["updates"] = _record_updates(trainer)
    trainer.train()
    out["trainer"] = trainer
    yield out
    patch.undo()


def _assert_stores_hold_the_same_episodes(jax_dir, torch_dir):
    jax_reader, reader = JaxReader(str(jax_dir)), TrajectoryStoreReader(str(torch_dir))
    assert len(reader) == len(jax_reader) >= EPISODES
    for k in range(len(reader)):
        (ref_obs, ref_prev, ref_oracle), (obs, prev, oracle) = jax_reader.get(k), reader.get(k)
        assert sorted(obs) == sorted(ref_obs) == ["depth_features", "instruction", "progress", "rgb_features"]
        np.testing.assert_array_equal(prev, np.asarray(ref_prev))
        np.testing.assert_array_equal(oracle, np.asarray(ref_oracle))
        np.testing.assert_array_equal(obs["instruction"], ref_obs["instruction"])
        np.testing.assert_allclose(obs["progress"], ref_obs["progress"], atol=1e-6)
        for key in ("rgb_features", "depth_features"):
            assert obs[key].dtype == np.float32 and obs[key].shape == ref_obs[key].shape
            np.testing.assert_allclose(obs[key], ref_obs[key], atol=1e-4, err_msg=f"episode {k} {key}")
        # teacher forcing: the action taken is the expert's, so each step's previous action is the oracle's last
        np.testing.assert_array_equal(prev[1:], oracle[:-1])
    jax_reader.close()
    reader.close()


def test_teacher_forcing_store_holds_the_jax_trainers_episodes(runs):
    _assert_stores_hold_the_same_episodes(runs["tmp"] / "jax" / "trajectories", runs["tmp"] / "torch" / "trajectories")
    stats = runs["trainer"].collection_stats
    assert len(stats) == 1 and stats[0]["beta"] == 1.0 and stats[0]["episodes"] == store_length(str(runs["tmp"] / "torch" / "trajectories"))


def test_pipelined_collection_stores_the_jax_trainers_episodes(runs, tmp_path):
    jax_trainer = _jax_trainer(tmp_path / "jax", runs["jax_ckpt"], ["TPU.PIPELINED_COLLECTION", True])
    _jax_setup(jax_trainer)
    jax_trainer._update_dataset(1)
    trainer = _torch_trainer(tmp_path / "torch", runs["torch_ckpt"], ["CUDA.PIPELINED_COLLECTION", True])
    trainer._setup_training()
    trainer._update_dataset(1)
    _assert_stores_hold_the_same_episodes(tmp_path / "jax" / "trajectories", tmp_path / "torch" / "trajectories")
    # two groups of one env: a collect step per env step, where the serial round takes one for both envs
    serial, piped = runs["trainer"].collection_stats[0], trainer.collection_stats[0]
    assert piped["collect_steps"] == piped["env_steps"] and 2 * serial["collect_steps"] == serial["env_steps"]
    assert abs(piped["env_steps"] - serial["env_steps"]) <= 1  # the round ends between the two groups


def test_first_training_losses_and_batch_order_match_jax(runs):
    ref, got = runs["jax_updates"], runs["updates"]
    assert len(got) == len(ref) == 3
    for (ref_obs, ref_prev, ref_corrected, ref_weights, ref_triple, _), (obs, prev, corrected, weights, triple, _) in zip(ref, got):
        np.testing.assert_array_equal(corrected, ref_corrected)
        np.testing.assert_array_equal(prev, ref_prev)
        np.testing.assert_array_equal(weights, ref_weights)
        np.testing.assert_array_equal(obs["instruction"], ref_obs["instruction"])
        assert corrected.shape == (16, 2)  # episodes of 6 steps, padded to the quantum
        np.testing.assert_allclose(triple, ref_triple, rtol=1e-3)
    assert [h[2:] for h in runs["trainer"].loss_history] == [tuple(g[4]) for g in got]
    assert runs["trainer"].train_lengths == {16: 3}


def test_train_steps_are_timed_only_when_asked(runs, tmp_path):
    assert runs["trainer"].step_clock is None  # `time_train_steps` is off by default: a step records nothing
    trainer = _torch_trainer(tmp_path, runs["torch_ckpt"])
    trainer.time_train_steps = True
    trainer._setup_training()
    obs, prev, corrected, weights, triple, masks = runs["updates"][0]
    # the same first step from the same weights, now with the clock's marks in it
    assert trainer._update_agent(obs, prev, masks, corrected, weights) == triple
    totals = trainer.step_clock.totals()
    assert sorted(totals) == ["backward", "forward", "optimizer", "upload"] and trainer.step_clock.steps == 1
    assert all(ms > 0 for ms in totals.values()) and trainer.step_clock.first == totals


def test_train_writes_a_checkpoint_with_optimizer_state_that_eval_reads(runs):
    trainer, tmp = runs["trainer"], runs["tmp"] / "torch"
    assert sorted(os.listdir(tmp / "checkpoints")) == ["ckpt.0.ckpt"]
    ckpt = load_checkpoint(str(tmp / "checkpoints" / "ckpt.0.ckpt"))
    assert ckpt["extra_state"] == {"epoch": 0, "step_id": 3, "dagger_it": 0} and "config_yaml" in ckpt
    trainable = [n for n, p in trainer.policy.named_parameters() if p.requires_grad]
    state = ckpt["optim_state"]["state"]
    assert len(state) == len(trainable) == len(ckpt["optim_state"]["param_groups"][0]["params"])
    assert all(float(s["step"]) == 3.0 and float(s["exp_avg_sq"].abs().max()) >= 0 for s in state.values())
    for name, value in trainer.policy.state_dict().items():
        assert torch.equal(ckpt["state_dict"][name], value), name
        moved = not torch.equal(value, runs["start"][name])
        assert moved == (name in trainable), name

    evaluator = _torch_trainer(tmp, runs["torch_ckpt"])
    evaluator.eval()
    assert os.path.exists(tmp / "evals" / "stats_ckpt_0_val_unseen.json")
    head = "action_distribution.linear.weight"
    assert torch.equal(evaluator.policy.state_dict()[head], ckpt["state_dict"][head])


def test_requeue_restores_epoch_step_and_adam_moments(runs):
    tmp = runs["tmp"] / "torch"
    ckpt_path = str(tmp / "checkpoints" / "ckpt.0.ckpt")
    trainer = _torch_trainer(tmp / "requeue", ckpt_path, ["IL.is_requeue", True])
    trainer._setup_training()
    assert (trainer.start_epoch, trainer.step_id) == (1, 3)
    saved = load_checkpoint(ckpt_path)["optim_state"]["state"]
    params = trainer.optimizer.param_groups[0]["params"]
    assert len(trainer.optimizer.state) == len(saved) == len(params)
    for index, p in enumerate(params):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(trainer.optimizer.state[p][key], saved[index][key])
    # without the requeue flag the weights load and the optimizer starts anew
    fresh = _torch_trainer(tmp / "fresh", ckpt_path)
    fresh._setup_training()
    assert (fresh.start_epoch, fresh.step_id) == (0, 0) and len(fresh.optimizer.state) == 0


def test_beta_mix_takes_the_experts_action_where_the_draw_says_so(runs, tmp_path, monkeypatch):
    """The first round of a run that loaded a checkpoint, at p = 0.5 (data_it
    = 1, so beta = 0.5): every collect step's action is the expert's exactly
    where its draw is below beta, and the stored previous actions are those
    mixed actions."""
    recorded = []
    make = dagger_trainer.make_collect_step

    def recording_make(*args):
        step = make(*args)

        def collect_step(*a):
            out = step(*a)
            recorded.append((a[4], *(t.clone() for t in (out[0], out[3], out[4], out[5]))))
            return out

        return collect_step

    monkeypatch.setattr(dagger_trainer, "make_collect_step", recording_make)
    trainer = _torch_trainer(tmp_path, runs["torch_ckpt"], ["IL.DAGGER.p", 0.5])
    trainer._setup_training()
    trainer._update_dataset(1)
    assert trainer.collection_stats[0]["beta"] == 0.5 and len(recorded) == trainer.collection_stats[0]["collect_steps"]
    took_expert = took_policy = 0
    for beta, actions, expert, policy_actions, draws in recorded:
        assert beta == 0.5 and float(draws.min()) >= 0.0 and float(draws.max()) < 1.0
        below = draws < beta
        assert torch.equal(actions[below], expert[below]) and torch.equal(actions[~below], policy_actions[~below])
        took_expert, took_policy = took_expert + int(below.sum()), took_policy + int((~below).sum())
    assert took_expert > 0 and took_policy > 0
    reader = TrajectoryStoreReader(str(tmp_path / "trajectories"))
    assert len(reader) >= EPISODES
    some_off_expert = False
    for k in range(len(reader)):
        _, prev, oracle = reader.get(k)
        # prev[0] is the last action of the env's previous episode, as in the JAX trainer: masked out at t = 0
        assert prev.min() >= 0 and prev.max() < 4
        some_off_expert |= bool((prev[1:] != oracle[:-1]).any())
    assert some_off_expert
    reader.close()


def test_async_writer_never_leaves_a_torn_file(tmp_path, monkeypatch):
    """While the writer thread is inside torch.save the old file stays whole;
    a snapshot is a copy, so changing the live tensor afterwards does not
    reach the file."""
    path = str(tmp_path / "ckpt.0.ckpt")
    live = torch.ones(4)
    save_checkpoint(path, {"w": live}, optim_state={"state": {0: {"step": torch.tensor(1.0)}}, "param_groups": []})
    entered, release = threading.Event(), threading.Event()
    real_save = torch.save

    def slow_save(payload, f):
        f.write(b"half a file")
        f.flush()
        entered.set()
        assert release.wait(30)
        f.seek(0)
        f.truncate()
        real_save(payload, f)

    monkeypatch.setattr(checkpoints.torch, "save", slow_save)
    live.fill_(2.0)
    save_checkpoint(path, {"w": live}, async_write=True)
    assert entered.wait(30)
    live.fill_(3.0)  # after the snapshot
    monkeypatch.setattr(checkpoints.torch, "save", real_save)
    assert torch.equal(load_checkpoint(path)["state_dict"]["w"], torch.ones(4))  # the old file, whole
    assert any(name.startswith("ckpt.0.ckpt.tmp.") for name in os.listdir(tmp_path))
    release.set()
    wait_for_pending()
    assert os.listdir(tmp_path) == ["ckpt.0.ckpt"]
    assert torch.equal(load_checkpoint(path)["state_dict"]["w"], torch.full((4,), 2.0))


def test_wait_for_pending_surfaces_a_failed_write(tmp_path, monkeypatch):
    def failing_save(payload, f):
        raise OSError("disk full")

    monkeypatch.setattr(checkpoints.torch, "save", failing_save)
    save_checkpoint(str(tmp_path / "a.ckpt"), {"w": torch.ones(1)}, async_write=True)
    with pytest.raises(RuntimeError, match="async checkpoint write failed") as err:
        wait_for_pending()
    assert isinstance(err.value.__cause__, OSError)
    monkeypatch.undo()
    wait_for_pending()  # the error was handed over once
    save_checkpoint(str(tmp_path / "b.ckpt"), {"w": torch.ones(1)}, async_write=True)
    wait_for_pending()
    assert torch.equal(load_checkpoint(str(tmp_path / "b.ckpt"))["state_dict"]["w"], torch.ones(1))
