"""The port's recollect trainer and its dataset against the JAX package's, at
a small size on the CPU (the RxR CMA cases: ResNet18s, H=64, 48x64 frames
resized and cropped to 32x32, 16 x 32-d instruction features; in-process
envs, synthetic scenes, the shortest-path oracle in place of a GT file).

Both trainers load the same weights from a checkpoint (the JAX package's
msgpack file and the port's torch file of one perturbed parameter set). The
JAX side runs with `use_pretrained_embeddings False`, without which its
optimizer mask raises for the RxR CMA policy (ROADMAP.md section C).
Tolerances: batches bit-equal; losses rtol 1e-3 (they pass through two
frameworks' ResNets and biLSTMs and an Adam step); the accumulation step's
parameters as in tests/test_torch_il_step.py.
"""

import copy
import gzip
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import vlnce_tpu.models  # noqa: F401
import vlnce_tpu.tasks  # noqa: F401
import vlnce_tpu.trainers  # noqa: F401
import vlnce_torch.models.cma_policy  # noqa: F401
import vlnce_torch.models.seq2seq_policy  # noqa: F401
import vlnce_torch.tasks  # noqa: F401
import vlnce_torch.trainers  # noqa: F401
from vlnce_tpu.config import get_config as jax_get_config
from vlnce_tpu.data.recollection import TeacherRecollectionDataset as JaxDataset
from vlnce_tpu.envs import ensure_registered as jax_ensure_registered
from vlnce_tpu.envs import rl_envs as jax_rl_envs  # noqa: F401
from vlnce_tpu.parallel.il_step import build_il_accum_step as jax_build_il_accum_step
from vlnce_tpu.parallel.optim import masked_adam as jax_masked_adam
from vlnce_tpu.registry import registry as jax_registry
from vlnce_tpu.utils.checkpoints import save_checkpoint as jax_save_checkpoint
from vlnce_torch.config import get_config
from vlnce_torch.data.recollection import TeacherRecollectionDataset
from vlnce_torch.envs import ensure_registered
from vlnce_torch.envs import rl_envs  # noqa: F401
from vlnce_torch.models.convert import state_dict_from_jax_params
from vlnce_torch.parallel.il_step import build_il_accum_step
from vlnce_torch.parallel.optim import masked_adam
from vlnce_torch.registry import registry
from vlnce_torch.utils.checkpoints import load_checkpoint, save_checkpoint

from tests.torch_port_cases import JAX_RXR_CMA, RXR_CMA, SMALL_OPTS, build_pair, observations

jax_ensure_registered()
ensure_registered()

LR = 2.5e-4  # IL.lr
EPISODES = 6  # three batches of two: accumulation 2 applies after the second


def _opts(tmp, extra=()):
    return SMALL_OPTS + [
        "TASK_CONFIG.DATASET.TYPE", "Synthetic-VLN-v0",
        "TASK_CONFIG.DATASET.NUM_EPISODES", EPISODES,
        "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", 6,
        "NUM_ENVIRONMENTS", 2,
        "IL.epochs", 1, "IL.batch_size", 2, "IL.RECOLLECT_TRAINER.preload_size", 2,
        "IL.RECOLLECT_TRAINER.effective_batch_size", 4,
        "IL.RECOLLECT_TRAINER.trajectories_file", f"{tmp}/trajectories.json.gz",
        "IL.RECOLLECT_TRAINER.gt_file", f"{tmp}/missing_{{split}}_{{role}}_gt.json.gz",
        "IL.load_from_ckpt", True, "CHECKPOINT_FOLDER", f"{tmp}/checkpoints", "TENSORBOARD_DIR", "", "VERBOSE", False,
        *extra,
    ]


def _jax_config(tmp, ckpt, extra=()):
    return jax_get_config(JAX_RXR_CMA, _opts(tmp, [
        "TPU.PRECISION.compute_dtype", "float32", "MODEL.INSTRUCTION_ENCODER.use_pretrained_embeddings", False,
        "IL.ckpt_to_load", ckpt, *extra]))


def _config(tmp, ckpt, extra=()):
    return get_config(RXR_CMA, _opts(tmp, ["CUDA.DEVICE", "cpu", "CUDA.PRECISION.compute_dtype", "float32",
                                           "IL.ckpt_to_load", ckpt, *extra]))


@pytest.fixture(autouse=True)
def threaded_envs(monkeypatch):
    monkeypatch.setenv("VLNCE_TPU_THREADED_ENVS", "1")
    monkeypatch.setenv("VLNCE_TORCH_THREADED_ENVS", "1")


@pytest.fixture(scope="module")
def start(tmp_path_factory):
    """One perturbed parameter set of the small RxR CMA policy, as a
    checkpoint of each package."""
    tmp = tmp_path_factory.mktemp("recollect_start")
    (_, _, params), (policy, _), _ = build_pair(seed=11)
    jax_ckpt, torch_ckpt = str(tmp / "start.jax.ckpt"), str(tmp / "start.torch.ckpt")
    jax_save_checkpoint(jax_ckpt, params)
    save_checkpoint(torch_ckpt, policy.state_dict())
    return {"jax_ckpt": jax_ckpt, "torch_ckpt": torch_ckpt, "params": params, "policy": policy,
            "state": {k: v.clone() for k, v in policy.state_dict().items()}}


@pytest.fixture(scope="module")
def runs(start, tmp_path_factory):
    """Both trainers' `train()` from the same weights: one epoch of three
    batches with two batches accumulated per Adam step. The losses of every
    accumulation step are recorded on both sides."""
    tmp = tmp_path_factory.mktemp("recollect")
    patch = pytest.MonkeyPatch()
    patch.setenv("VLNCE_TPU_THREADED_ENVS", "1")
    patch.setenv("VLNCE_TORCH_THREADED_ENVS", "1")

    jax_trainer = jax_registry.get_trainer("recollect_trainer")(_jax_config(tmp / "jax", start["jax_ckpt"]))
    jax_losses = []
    build = jax_trainer._build_accum_step

    def recording_build(apply, obs_shapes=None):
        step = build(apply, obs_shapes)

        def accum_step(*args):
            out = step(*args)
            jax_losses.append((bool(apply), float(args[3]), *(float(x) for x in out[3:])))
            return out

        return accum_step

    jax_trainer._build_accum_step = recording_build
    jax_trainer.train()

    trainer = registry.get_trainer("recollect_trainer")(_config(tmp / "torch", start["torch_ckpt"]))
    seen = []
    update = trainer._update_agent

    def recording(*batch, apply, accumulation):
        out = update(*batch, apply=apply, accumulation=accumulation)
        seen.append((apply, accumulation, batch))
        return out

    trainer._update_agent = recording
    trainer.train()
    yield {"tmp": tmp, "jax_losses": jax_losses, "trainer": trainer, "seen": seen}
    patch.undo()


def test_first_accumulation_step_losses_match_jax(runs):
    ref, trainer = runs["jax_losses"], runs["trainer"]
    assert len(ref) == len(trainer.loss_history) == len(runs["seen"]) == 3
    # accumulation 2: the second batch applies the Adam step, the third adds to fresh gradients
    assert [r[:2] for r in ref] == [(False, 2.0), (True, 2.0), (False, 2.0)]
    assert [s[:2] for s in runs["seen"]] == [(False, 2), (True, 2), (False, 2)]
    for (_, _, *jax_triple), (_, *triple) in zip(ref, trainer.loss_history):
        np.testing.assert_allclose(triple, jax_triple, rtol=1e-3)
    assert all(np.isfinite(h[1:]).all() for h in trainer.loss_history)
    assert trainer.resimulation["episodes"] >= EPISODES and trainer.resimulation["env_steps"] > 0


def test_checkpoint_holds_epoch_step_and_optimizer_state(runs, start):
    trainer, tmp = runs["trainer"], runs["tmp"] / "torch"
    ckpt = load_checkpoint(str(tmp / "checkpoints" / "ckpt.0.ckpt"))
    assert ckpt["extra_state"] == {"epoch": 0, "step_id": 3} and "config_yaml" in ckpt
    trainable = [n for n, p in trainer.policy.named_parameters() if p.requires_grad]
    state = ckpt["optim_state"]["state"]
    assert len(state) == len(trainable) and all(float(s["step"]) == 1.0 for s in state.values())
    for name, value in trainer.policy.state_dict().items():
        assert torch.equal(ckpt["state_dict"][name], value), name
        # one Adam step moved every trainable tensor; the third batch's gradients were never applied
        assert (not torch.equal(value, start["state"][name])) == (name in trainable), name
    assert all(p.grad is not None for n, p in trainer.policy.named_parameters() if n in trainable)


def _datasets(tmp, start, extra=()):
    jax_ds = JaxDataset(_jax_config(tmp / "jax", start["jax_ckpt"], extra))
    ds = TeacherRecollectionDataset(_config(tmp / "torch", start["torch_ckpt"], extra))
    return jax_ds, ds


def _collector(dataset_cls, config):
    """A dataset object that has its config and nothing else: enough for
    `collect_dataset`, without a sim pool."""
    ds = dataset_cls.__new__(dataset_cls)
    ds.config = config
    return ds


def test_oracle_trajectories_equal_jax(start, tmp_path):
    """No GT file: both packages roll the shortest-path oracle through every
    episode, keep those within max_traj_len and write the same file."""
    def both(max_traj_len):
        extra = ["TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", 40, "IL.RECOLLECT_TRAINER.max_traj_len", max_traj_len]
        ref = _collector(JaxDataset, _jax_config(tmp_path / "jax", start["jax_ckpt"], extra)).collect_dataset()
        got = _collector(TeacherRecollectionDataset, _config(tmp_path / "torch", start["torch_ckpt"], extra)).collect_dataset()
        assert json.loads(json.dumps(got)) == json.loads(json.dumps(ref))
        return got

    lengths = sorted(len(t) for t in both(-1).values())
    cut = lengths[-1] - 1
    assert len(lengths) == EPISODES and lengths[0] < lengths[-1]
    got = both(cut)
    assert 0 < len(got) == sum(n <= cut for n in lengths) < EPISODES
    assert all(len(t) <= cut and t[0][0] == 0 and t[-1][1] == 0 for t in got.values())
    for t in got.values():  # [prev, action, oracle]: prev is the last step's action
        assert [s[0] for s in t[1:]] == [s[1] for s in t[:-1]] and all(s[1] == s[2] for s in t)
    with gzip.open(tmp_path / "torch" / "trajectories.json.gz", "rt") as f:
        assert json.load(f) == json.loads(json.dumps(got))


def test_gt_file_pattern_takes_each_role(start, tmp_path):
    """A `{role}` GT file is read for every role the dataset config lists."""
    tmp = tmp_path / "torch"
    tmp.mkdir()
    cfg = _config(tmp, start["torch_ckpt"], ["TASK_CONFIG.DATASET.ROLES", ["guide", "follower"]])
    gt = {"guide": {"a": {"actions": [1, 2, 0]}}, "follower": {"b": {"actions": [3, 0]}, "c": {"actions": [1] * 9}}}
    for role, data in gt.items():
        with gzip.open(cfg.IL.RECOLLECT_TRAINER.gt_file.format(split=cfg.TASK_CONFIG.DATASET.SPLIT, role=role), "wt") as f:
            json.dump(data, f)
    cfg = cfg.clone().defrost()
    cfg.IL.RECOLLECT_TRAINER.max_traj_len = 8
    assert _collector(TeacherRecollectionDataset, cfg).collect_dataset() == {"a": [[0, 1, 1], [1, 2, 2], [2, 0, 0]], "b": [[0, 3, 3], [3, 0, 0]]}


def test_first_collated_batches_equal_jax(start, tmp_path):
    jax_ds, ds = _datasets(tmp_path, start)
    try:
        assert ds.length == jax_ds.length == EPISODES
        assert ds.observation_space["rgb"].shape == (32, 32, 3) and ds.action_space.n == 6
        got, ref = list(ds.batches(2)), list(jax_ds.batches(2))
        for (obs, *rest), (ref_obs, *ref_rest) in zip(got, ref):
            assert sorted(obs) == sorted(ref_obs) == ["depth", "rgb", "rxr_instruction"]
            assert obs["rgb"].shape[1:] == (48, 64, 3) and obs["rgb"].dtype == np.uint8  # the raw frames
            for k in obs:
                assert obs[k].dtype == ref_obs[k].dtype, k
                np.testing.assert_array_equal(obs[k], ref_obs[k], err_msg=k)
            for a, b in zip(rest, ref_rest):  # prev, masks, oracle, weights
                assert a.dtype == np.asarray(b).dtype
                np.testing.assert_array_equal(a, np.asarray(b))
            assert rest[2].shape[0] == 16  # padded to the length quantum
    finally:
        jax_ds.close_sims()
        ds.close_sims()


def test_preload_holds_whole_episodes_of_their_gt_length(start, tmp_path):
    ds = TeacherRecollectionDataset(_config(tmp_path, start["torch_ckpt"]))
    try:
        it = ds.episodes()
        for _ in range(EPISODES):
            obs, prev, oracle, weights = next(it)
            assert len(prev) == len(oracle) == len(weights) == obs["rgb"].shape[0]
            assert any(len(t) == len(oracle) and [s[2] for s in t] == oracle.tolist() for t in ds.trajectories.values())
        assert ds.sim_stats["episodes"] >= EPISODES
    finally:
        ds.close_sims()


@pytest.mark.parametrize("key", ["ON_DEVICE_RECOLLECT", "RECOLLECT_RESIDENT"])
def test_device_resident_keys_raise_naming_the_roadmap(start, tmp_path, key, monkeypatch):
    # recollection on the card trains since its slice came (tests/test_torch_device_recollect.py), and on imported
    # scene geometry since the scene import came (until then it raised here naming the roadmap): the shortest-path
    # oracle's GT trajectories over an export of every scene of the split (host envs), then one epoch rendered on
    # the card, with no env pool
    from vlnce_torch.data import recollection
    from vlnce_torch.tasks.datasets import make_dataset

    from tests.torch_port_cases import SceneRegistrySnapshot, assert_imported, export_synthetic_geometry

    def no_pool(*args, **kwargs):
        raise AssertionError("the env pool was constructed")

    geometry = ["TASK_CONFIG.SIMULATOR.GEOMETRY_DIR", str(tmp_path / "geometry")]
    with SceneRegistrySnapshot():
        cfg = _config(tmp_path, start["torch_ckpt"], geometry)
        scene_ids = {e.scene_id for e in make_dataset(cfg.TASK_CONFIG.DATASET.TYPE, cfg.TASK_CONFIG.DATASET).episodes}
        export_synthetic_geometry(str(tmp_path / "geometry"), scene_ids)
        trajectories = tmp_path / "trajectories.json.gz"
        with gzip.open(trajectories, "wt") as f:
            json.dump(_collector(TeacherRecollectionDataset, cfg).collect_dataset(), f)
        monkeypatch.setattr(recollection, "construct_envs", no_pool)
        trainer = registry.get_trainer("recollect_trainer")(_config(tmp_path, start["torch_ckpt"], geometry + [
            "CUDA.ON_DEVICE_RECOLLECT", True, f"CUDA.{key}", True,
            "IL.RECOLLECT_TRAINER.preload_trajectories_file", True, "IL.RECOLLECT_TRAINER.trajectories_file", str(trajectories)]))
        trainer.train()
        assert_imported(scene_ids)
    assert trainer.resimulation["episodes"] >= EPISODES and np.isfinite(np.array([h[1:] for h in trainer.loss_history])).all()
    assert load_checkpoint(str(tmp_path / "checkpoints" / "ckpt.0.ckpt"))["extra_state"]["epoch"] == 0


@pytest.mark.parametrize("accumulation", [1, 2])
def test_accumulation_step_against_jax(start, accumulation):
    """`accumulation` micro-batches of the RxR CMA policy through the port's
    and JAX's accumulation steps: each adds grad / accumulation, Adam steps
    only on the last (before it every parameter is unchanged), the gradients
    are cleared after it, and only trainable tensors move."""
    jcfg = _jax_config("/nonexistent", start["jax_ckpt"])
    cfg = _config("/nonexistent", start["torch_ckpt"])
    (jax_policy, _, _), _, _ = build_pair(seed=11)
    rng = np.random.RandomState(12)
    T, Nb = 5, 2
    batches = []
    for _ in range(accumulation):
        obs = observations(rng, T * Nb, cfg.TASK_CONFIG)
        obs = {"rgb": obs["rgb"][:, :32, :32], "depth": obs["depth"][:, :32, :32], "rxr_instruction": obs["rxr_instruction"]}
        weights = np.where(rng.rand(T, Nb) < 0.3, 1.9, 1.0).astype(np.float32)
        weights[3:, 1] = 0.0
        masks = np.ones((T, Nb), np.float32)
        masks[0] = 0.0
        batches.append(({k: v.reshape((T, Nb) + v.shape[1:]) for k, v in obs.items()}, rng.randint(0, 6, (T, Nb)),
                        masks, rng.randint(0, 6, (T, Nb)), weights))
    tx = jax_masked_adam(LR, start["params"], jcfg.MODEL)
    params = jax.tree_util.tree_map(jnp.array, start["params"])
    state, accum = tx.init(params), jax.tree_util.tree_map(jnp.zeros_like, params)
    policy = copy.deepcopy(start["policy"])
    optimizer = masked_adam(LR, policy, cfg.MODEL)
    optimizer.zero_grad(set_to_none=True)
    before = {k: v.clone() for k, v in policy.state_dict().items()}
    for i, (obs, prev, masks, corrected, weights) in enumerate(batches):
        apply = i == accumulation - 1
        jax_step = jax_build_il_accum_step(jax_policy.module, tx, jax_policy.num_recurrent_layers, jax_policy.hidden_size,
                                           apply=apply)
        params, state, accum, jax_loss, _, _ = jax_step(
            params, state, accum, float(accumulation), {k: jnp.asarray(v) for k, v in obs.items()},
            jnp.asarray(prev, jnp.int32), jnp.asarray(masks), jnp.asarray(corrected, jnp.int32), jnp.asarray(weights))
        loss, _, _ = build_il_accum_step(policy, optimizer, apply)(
            float(accumulation), {k: torch.from_numpy(v) for k, v in obs.items()}, torch.from_numpy(prev),
            torch.from_numpy(masks), torch.from_numpy(corrected), torch.from_numpy(weights))
        np.testing.assert_allclose(float(loss), float(jax_loss), rtol=1e-5)
        if not apply:
            assert all(torch.equal(v, before[k]) for k, v in policy.state_dict().items())
            ref = state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, accum))
            for name, p in policy.named_parameters():
                if p.requires_grad:
                    np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(), atol=1e-5, rtol=1e-4, err_msg=name)
    assert all(p.grad is None for p in policy.parameters())  # cleared after the applying step
    ref = state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    moved = off = count = 0
    for name, p in policy.named_parameters():
        if p.requires_grad:
            # Adam's first step moves each element by about lr x sign(grad): the two agree within 1e-5 except
            # where a gradient within rounding of zero took the other sign (a step apart, 2 lr at most)
            diff = (p.detach() - ref[name]).abs()
            assert float(diff.max()) <= 2 * LR * 1.01, name
            off, count = off + int((diff > 1e-5).sum()), count + p.numel()
            moved += int(not torch.equal(p.detach(), before[name]))
        else:
            assert torch.equal(p.detach(), before[name]), name
    assert moved == sum(p.requires_grad for p in policy.parameters()) and off <= 0.01 * count, (off, count)
