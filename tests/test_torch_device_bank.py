"""The port's trajectory bank on the card (data/device_bank.py, the resident
half of trainers/device_dagger.py and the DAgger trainer's resident modes)
against the JAX package's, at a small size on the CPU.

- A bank of seeded ragged rows (with padding rows at a chunk's tail): its
  gathers in both layouts equal JAX's exactly, and equal the port's
  `collate_episodes` of the same episodes (the instruction compared only
  where the weights are > 0: the bank broadcasts it over the padding rows,
  collate pads with 1, and no loss reads those rows); `extend`; the resident
  iterator's batches over two epochs equal JAX's and the store iterator's,
  and its concatenated `epoch_runs` JAX's; `write_to_store` / `from_store`.
- The trainer with CUDA.DAGGER_RESIDENT at beta 1 from one checkpoint (as
  tests/test_torch_dagger.py loads it) against the JAX resident trainer:
  bank rows within 1e-4 (two frameworks' ResNets), compared by offsets, and
  losses within rtol 1e-3 (they pass through those features and Adam
  steps). Within the port: resident against the store-wired
  CUDA.ON_DEVICE_DAGGER within rtol 2e-6 (the JAX package's own bound for
  the same pair, tests/test_trainers.py), RESIDENT_EPOCH_SCAN against
  per-batch (the same losses and parameters, bit for bit: the same ops on
  the same data), preload with the bank against the store path (2e-6).
- The enqueued epoch never reads a value back before its run's one
  read-back.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import vlnce_tpu.models  # noqa: F401
import vlnce_tpu.tasks  # noqa: F401
import vlnce_tpu.trainers  # noqa: F401
import vlnce_torch.models.cma_policy  # noqa: F401
import vlnce_torch.tasks  # noqa: F401
import vlnce_torch.trainers  # noqa: F401
from vlnce_tpu.config import get_config as jax_get_config
from vlnce_tpu.data import device_bank as jax_bank
from vlnce_tpu.data.trajectory_store import TrajectoryStoreReader as JaxReader
from vlnce_tpu.envs import ensure_registered as jax_ensure_registered
from vlnce_tpu.envs import rl_envs as jax_rl_envs  # noqa: F401
from vlnce_tpu.registry import registry as jax_registry
from vlnce_tpu.utils.checkpoints import save_checkpoint as jax_save_checkpoint
from vlnce_torch.config import get_config
from vlnce_torch.data.collate import TrajectoryBatchIterator, collate_episodes, inflection_weights
from vlnce_torch.data.device_bank import DeviceTrajectoryBank, ResidentBatchIterator, run_fused_epoch
from vlnce_torch.data.trajectory_store import TrajectoryStoreReader, TrajectoryStoreWriter, store_length
from vlnce_torch.envs import ensure_registered
from vlnce_torch.envs import rl_envs  # noqa: F401
from vlnce_torch.registry import registry
from vlnce_torch.run import run_exp
from vlnce_torch.utils.checkpoints import save_checkpoint

from tests.torch_port_cases import JAX_R2R_CMA, R2R_CMA, R2R_SMALL_OPTS, build_r2r_pair, write_both_stores

jax_ensure_registered()
ensure_registered()

COEF = 3.2
FEAT = {"rgb_features": (4, 2, 2), "depth_features": (3, 2, 2), "progress": (1,)}
CHUNKS = [([5, 9, 3], 2), ([12, 7], 0)]  # (episode lengths, padding rows at the chunk's tail)


# ---------------------------------------------------------------------------
# a bank of seeded rows in both packages
# ---------------------------------------------------------------------------


def _seeded_chunks(seed=0, chunks=CHUNKS):
    """Per chunk: rows {key: [n, F]} (f16 features, f32 progress), prev and
    oracle [n] int32, instruction [E, 8] int32, the lengths; and each
    episode's store payload [obs, prev, oracle]."""
    rng = np.random.RandomState(seed)
    out, episodes = [], []
    for lengths, pad in chunks:
        n = sum(lengths) + pad
        rows = {k: rng.randn(n, int(np.prod(s))).astype(np.float16) for k, s in FEAT.items() if k != "progress"}
        rows["progress"] = rng.rand(n, 1).astype(np.float32)
        # runs of one action, so that not every step is an inflection
        starts = np.maximum.accumulate(np.where(rng.rand(n) < 0.4, np.arange(n), 0))
        oracle = rng.randint(0, 4, n).astype(np.int32)[starts]
        prev = rng.randint(0, 4, n).astype(np.int32)
        instr = rng.randint(1, 50, (len(lengths), 8)).astype(np.int32)
        out.append((rows, prev, oracle, instr, lengths))
        lo = 0
        for e, T in enumerate(lengths):
            obs = {k: (v[lo : lo + T].astype(np.float32) if v.dtype == np.float16 else v[lo : lo + T]).reshape((T,) + FEAT[k])
                   for k, v in rows.items()}
            obs["instruction"] = np.repeat(instr[e][None], T, axis=0)
            episodes.append([obs, prev[lo : lo + T].astype(np.int64), oracle[lo : lo + T].astype(np.int64)])
            lo += T
    return out, episodes


def _banks(chunks):
    lengths = [T for c in chunks for T in c[4]]
    jax_b = jax_bank.DeviceTrajectoryBank.from_rows(
        [{k: jnp.asarray(v) for k, v in c[0].items()} for c in chunks], [jnp.asarray(c[1]) for c in chunks],
        [jnp.asarray(c[2]) for c in chunks], [c[3] for c in chunks], lengths, FEAT)
    port_b = DeviceTrajectoryBank.from_rows(
        [{k: torch.from_numpy(v) for k, v in c[0].items()} for c in chunks], [torch.from_numpy(c[1]) for c in chunks],
        [torch.from_numpy(c[2]) for c in chunks], [torch.from_numpy(c[3]) for c in chunks], lengths, FEAT)
    return jax_b, port_b


@pytest.fixture(scope="module")
def seeded():
    chunks, episodes = _seeded_chunks()
    jax_b, port_b = _banks(chunks)
    return chunks, episodes, jax_b, port_b


def _assert_batches_equal(got, want):
    obs, *rest = got
    wobs, *wrest = want
    assert sorted(obs) == sorted(wobs)
    for k in obs:
        assert obs[k].shape == tuple(wobs[k].shape), k
        np.testing.assert_array_equal(obs[k].numpy(), np.asarray(wobs[k]), err_msg=k)
    for a, b in zip(rest, wrest):
        assert a.shape == tuple(b.shape)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("time_major", [False, True])
def test_gather_matches_jax_in_both_layouts(seeded, time_major):
    _, _, jax_b, port_b = seeded
    assert port_b.trash_index == sum(sum(c[0]) + c[1] for c in CHUNKS)  # after the rows and the chunk-tail padding
    for ids in ([0, 2], [3, 1, 4], [4, 4], [2]):
        got = port_b.gather_batch(ids, COEF, time_major=time_major)
        want = jax_b.gather_batch(ids, COEF, time_major=time_major)
        _assert_batches_equal(got, want)
        assert got[0]["rgb_features"].dtype == torch.float32 and got[1].dtype == torch.int64


def test_gathered_batches_equal_collate_of_the_same_episodes(seeded):
    _, episodes, _, port_b = seeded
    for ids in ([0, 2], [3, 1, 4], [1]):
        obs, prev, masks, corrected, weights = port_b.gather_batch(ids, COEF)
        batch = [(ep[0], ep[1], ep[2], inflection_weights(ep[2], COEF)) for ep in (episodes[i] for i in ids)]
        cobs, cprev, cmasks, ccorrected, cweights = collate_episodes(batch)
        np.testing.assert_array_equal(weights.numpy(), cweights)
        assert (cweights == COEF).sum() > len(ids) and (cweights == 1.0).any()  # inflections and plain steps both
        for a, b in ((prev, cprev), (masks, cmasks), (corrected, ccorrected)):
            assert a.shape == b.shape
            np.testing.assert_array_equal(a.numpy(), b)
        assert sorted(obs) == sorted(cobs)
        for k in FEAT:
            np.testing.assert_array_equal(obs[k].numpy(), cobs[k], err_msg=k)  # padding rows hold 1.0 in both
        real = cweights.reshape(-1) > 0
        np.testing.assert_array_equal(obs["instruction"].numpy()[real], cobs["instruction"][real])


def test_extend_then_gather_matches_jax(seeded):
    chunks, _, jax_b, port_b = seeded
    more, _ = _seeded_chunks(seed=1, chunks=[([4, 6], 3)])
    jax_more, port_more = _banks(more)
    jax_x, port_x = jax_b.extend(jax_more), port_b.extend(port_more)
    assert len(port_x) == len(jax_x) == 7 and port_x.num_steps == jax_x.num_steps
    np.testing.assert_array_equal(port_x.lengths, jax_x.lengths)
    for ids in ([5, 0], [6, 2, 5], [1, 6]):
        for time_major in (False, True):
            _assert_batches_equal(port_x.gather_batch(ids, COEF, time_major=time_major),
                                  jax_x.gather_batch(ids, COEF, time_major=time_major))


def _many_episodes(n=23, seed=2):
    rng = np.random.RandomState(seed)
    lengths = list(rng.randint(1, 40, n))
    return _seeded_chunks(seed=seed, chunks=[(lengths[:11], 2), (lengths[11:], 0)])


def test_resident_iterator_matches_jax_and_the_store_iterator(tmp_path):
    """Two epochs of one iterator each (the rng lives across epochs): the
    same batches as JAX's resident iterator and as the store iterator over
    the same episodes (drop_last: 23 episodes give 7 batches of 3)."""
    chunks, episodes = _many_episodes()
    jax_b, port_b = _banks(chunks)
    writer = TrajectoryStoreWriter(str(tmp_path / "store"), drop_existing=True)
    for ep in episodes:
        writer.put(ep)
    writer.close()
    reader = TrajectoryStoreReader(str(tmp_path / "store"))
    it = ResidentBatchIterator(port_b, batch_size=3, seed=11)
    jit = jax_bank.ResidentBatchIterator(jax_b, batch_size=3, seed=11)
    sit = TrajectoryBatchIterator(reader, batch_size=3, seed=11)
    assert len(it) == len(jit) == len(sit) == 7
    for _ in range(2):
        got, want, stored = list(it), list(jit), list(sit)
        assert len(got) == len(want) == len(stored) == 7
        for g, w, s in zip(got, want, stored):
            _assert_batches_equal(g, w)
            weights = g[4].numpy()
            np.testing.assert_array_equal(weights, s[4])
            for a, b in zip(g[1:4], s[1:4]):
                np.testing.assert_array_equal(a.numpy(), b)
            real = weights.reshape(-1) > 0
            np.testing.assert_array_equal(g[0]["instruction"].numpy()[real], s[0]["instruction"][real])
            for k in FEAT:
                np.testing.assert_array_equal(g[0][k].numpy(), s[0][k])
    reader.close()


def test_epoch_runs_match_jax():
    """The runs of one padded length, concatenated, are JAX's (which also
    splits each run into power-of-2 pieces to bound its compile cache)."""
    chunks, _ = _many_episodes()
    jax_b, port_b = _banks(chunks)
    it = ResidentBatchIterator(port_b, batch_size=2, seed=5)
    jit = jax_bank.ResidentBatchIterator(jax_b, batch_size=2, seed=5)
    for _ in range(2):
        runs, jruns = list(it.epoch_runs()), list(jit.epoch_runs())
        assert len(runs) <= len(jruns)
        assert all(runs[i][0] != runs[i + 1][0] for i in range(len(runs) - 1))  # each run is one whole stretch of a length
        rows = np.concatenate([r for _, r in runs])
        np.testing.assert_array_equal(rows, np.concatenate([r for _, r in jruns]))
        np.testing.assert_array_equal(np.concatenate([[T] * len(r) for T, r in runs]),
                                      np.concatenate([[T] * len(r) for T, r in jruns]))
        assert rows.shape == (11, 2) and rows.dtype == np.int64


def test_store_roundtrip_and_from_store_match_jax(seeded, tmp_path):
    """write_to_store writes the host loop's schema; a bank read back with
    from_store holds the same rows, and equals the JAX package's from_store
    of the same episodes in its own store."""
    _, episodes, _, port_b = seeded
    writer = TrajectoryStoreWriter(str(tmp_path / "archive"), drop_existing=True)
    assert port_b.write_to_store(writer) == 5
    writer.close()
    reader = TrajectoryStoreReader(str(tmp_path / "archive"))
    assert len(reader) == 5
    for (obs, prev, oracle), ep in zip((reader.get(i) for i in range(5)), episodes):
        assert sorted(obs) == sorted(ep[0]) and prev.dtype == np.int64
        for k in obs:
            np.testing.assert_array_equal(obs[k], ep[0][k], err_msg=k)
        np.testing.assert_array_equal(prev, ep[1])
        np.testing.assert_array_equal(oracle, ep[2])
    rebuilt = DeviceTrajectoryBank.from_store(reader)
    reader.close()
    write_both_stores(episodes, tmp_path / "jax", tmp_path / "port")
    jax_reader = JaxReader(str(tmp_path / "jax"))
    jax_rebuilt = jax_bank.DeviceTrajectoryBank.from_store(jax_reader)
    jax_reader.close()
    np.testing.assert_array_equal(rebuilt.offsets, jax_rebuilt.offsets)
    np.testing.assert_array_equal(rebuilt.lengths, port_b.lengths)
    assert rebuilt.trash_index == jax_rebuilt.trash_index == port_b.num_steps
    for ids in ([0, 4], [2, 3, 1]):
        _assert_batches_equal(rebuilt.gather_batch(ids, COEF), jax_rebuilt.gather_batch(ids, COEF))
        _assert_batches_equal(rebuilt.gather_batch(ids, COEF, time_major=True), port_b.gather_batch(ids, COEF, time_major=True))


# ---------------------------------------------------------------------------
# the trainer's resident modes
# ---------------------------------------------------------------------------


def _opts(tmp, tree, extra=()):
    return R2R_SMALL_OPTS + [
        "TASK_CONFIG.DATASET.NUM_EPISODES", 8, "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", 6, "NUM_ENVIRONMENTS", 2,
        "IL.epochs", 2, "IL.batch_size", 2, "IL.DAGGER.iterations", 2, "IL.DAGGER.update_size", 6,
        "IL.DAGGER.p", 1.0, "IL.load_from_ckpt", True, f"{tree}.DAGGER_SEGMENT", 4,
        "IL.DAGGER.lmdb_features_dir", f"{tmp}/trajectories", "CHECKPOINT_FOLDER", f"{tmp}/checkpoints",
        "LOG_FILE", "", "VERBOSE", False, *extra,
    ]


def _port_opts(tmp, ckpt, extra=()):
    return _opts(tmp, "CUDA", ["CUDA.DEVICE", "cpu", "CUDA.PRECISION.compute_dtype", "float32", "IL.ckpt_to_load", ckpt,
                               *extra])


def _port_trainer(tmp, ckpt, extra=()):
    return registry.get_trainer("dagger")(get_config(R2R_CMA, _port_opts(tmp, ckpt, extra)))


def _losses(trainer):
    return np.asarray([h[2:] for h in trainer.loss_history])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """From one checkpoint: the JAX resident trainer, and the port's
    store-wired, resident and enqueued-epoch trainers (the last through
    the CLI's run_exp, archiving its bank into the store). Two rounds at
    beta 1 of 6 episodes, two epochs of batches of 2."""
    tmp = tmp_path_factory.mktemp("bank")
    (_, params), policy, _ = build_r2r_pair(seed=3)
    jax_ckpt, ckpt = str(tmp / "start.jax.ckpt"), str(tmp / "start.torch.ckpt")
    jax_save_checkpoint(jax_ckpt, params)
    save_checkpoint(ckpt, policy.state_dict())
    out = {"tmp": tmp, "ckpt": ckpt}

    jcfg = jax_get_config(JAX_R2R_CMA, _opts(tmp / "jax", "TPU", [
        "TPU.PRECISION.compute_dtype", "float32", "IL.ckpt_to_load", jax_ckpt,
        "TPU.ON_DEVICE_DAGGER", True, "TPU.DAGGER_RESIDENT", True]))
    jax_trainer = jax_registry.get_trainer("dagger")(jcfg)
    jax_losses = []
    update = jax_trainer._update_agent

    def recording(*args, **kwargs):
        triple = update(*args, **kwargs)
        jax_losses.append(triple)
        return triple

    jax_trainer._update_agent = recording
    jax_trainer.train()
    out["jax"], out["jax_losses"] = jax_trainer, np.asarray(jax_losses)

    for name, extra in (("store", ["CUDA.ON_DEVICE_DAGGER", True]),
                        ("resident", ["CUDA.ON_DEVICE_DAGGER", True, "CUDA.DAGGER_RESIDENT", True])):
        trainer = _port_trainer(tmp / name, ckpt, extra)
        trainer.train()
        out[name] = trainer
    scan_runs = []
    enqueue = DeviceTrajectoryBank.enqueue_steps
    patch = pytest.MonkeyPatch()
    patch.setattr(DeviceTrajectoryBank, "enqueue_steps", lambda self, step, idx, *a: scan_runs.append(idx.shape[0])
                  or enqueue(self, step, idx, *a))
    try:
        out["scan"] = run_exp(R2R_CMA, "train", _port_opts(tmp / "scan", ckpt, [
            "CUDA.ON_DEVICE_DAGGER", True, "CUDA.DAGGER_RESIDENT", True, "CUDA.RESIDENT_EPOCH_SCAN", True,
            "CUDA.DAGGER_ARCHIVE_STORE", True]))
    finally:
        patch.undo()
    out["scan_runs"] = scan_runs
    return out


def test_resident_bank_rows_match_jax(runs):
    bank, jbank = runs["resident"]._bank, runs["jax"]._bank
    assert len(bank) == len(jbank) == 12  # two rounds of the same 6 episodes, joined
    np.testing.assert_array_equal(bank.lengths, jbank.lengths)
    assert sorted(bank.data) == sorted(jbank.data) == ["depth_features", "progress", "rgb_features"]
    assert bank.feat_shapes == {k: tuple(v) for k, v in jbank.feat_shapes.items()}
    prev, oracle, jprev, joracle = bank.prev.numpy(), bank.oracle.numpy(), np.asarray(jbank.prev), np.asarray(jbank.oracle)
    instr = bank.instruction.numpy()
    for e in range(len(bank)):
        lo, jlo, T = int(bank.offsets[e]), int(jbank.offsets[e]), int(bank.lengths[e])
        np.testing.assert_array_equal(prev[lo : lo + T], jprev[jlo : jlo + T])
        np.testing.assert_array_equal(oracle[lo : lo + T], joracle[jlo : jlo + T])
        np.testing.assert_array_equal(prev[lo + 1 : lo + T], oracle[lo : lo + T - 1])  # beta 1: the expert acted
        np.testing.assert_array_equal(instr[e], jbank._instr_host[e])
        for k in bank.data:
            np.testing.assert_allclose(bank.data[k][lo : lo + T].float().numpy(),
                                       np.asarray(jbank.data[k][jlo : jlo + T], np.float32), rtol=0, atol=1e-4, err_msg=k)


def test_resident_losses_match_jax(runs):
    losses = _losses(runs["resident"])
    assert losses.shape == (18, 3)  # 3 batches x 2 epochs, then 6 x 2
    np.testing.assert_allclose(losses, runs["jax_losses"], rtol=1e-3)


def test_resident_losses_match_the_store_wired_trainer(runs):
    np.testing.assert_allclose(_losses(runs["resident"]), _losses(runs["store"]), rtol=2e-6, atol=1e-7)
    store, resident = runs["store"].collection_stats, runs["resident"].collection_stats
    for s, r in zip(store, resident):  # the same schema; the rows came back nowhere
        assert set(s) <= set(r) and r["chunk_readbacks"] == 0 and s["chunk_readbacks"] > 0
        assert r["env_steps"] == s["env_steps"] and r["readbacks"] == r["segments"] == s["segments"]
        assert r["bank_bytes"] > 0 and r["graph"] is False


def test_epoch_scan_matches_per_batch(runs):
    scan, resident = runs["scan"], runs["resident"]
    np.testing.assert_array_equal(_losses(scan), _losses(resident))
    assert [h[:2] for h in scan.loss_history] == [h[:2] for h in resident.loss_history]
    for k, v in scan.policy.state_dict().items():
        assert torch.equal(v, resident.policy.state_dict()[k]), k
    # every batch has T 16 here: one run per epoch, one read-back each
    assert runs["scan_runs"] == [3, 3, 6, 6]
    assert sorted(os.listdir(runs["tmp"] / "scan" / "checkpoints")) == [f"ckpt.{i}.ckpt" for i in range(4)]


def test_archive_store_holds_the_bank_rows(runs):
    bank = runs["scan"]._bank
    path = str(runs["tmp"] / "scan" / "trajectories")
    assert store_length(path) == len(bank) == 12
    reader = TrajectoryStoreReader(path)
    for e in range(len(bank)):
        obs, prev, oracle = reader.get(e)
        lo, T = int(bank.offsets[e]), int(bank.lengths[e])
        np.testing.assert_array_equal(prev, bank.prev[lo : lo + T].numpy())
        np.testing.assert_array_equal(oracle, bank.oracle[lo : lo + T].numpy())
        np.testing.assert_array_equal(obs["instruction"], np.repeat(bank.instruction[e][None].numpy(), T, axis=0))
        for k, shape in bank.feat_shapes.items():
            np.testing.assert_array_equal(obs[k], bank.data[k][lo : lo + T].float().numpy().reshape((T,) + shape))
    reader.close()


def test_enqueued_epoch_reads_back_once_per_run(runs, monkeypatch):
    """An epoch of the enqueued path with `Tensor.__bool__`, `.tolist()` and
    `.item()` refused while a run is enqueued (the optimizer's step counts,
    which live on the host, may be read): the run's losses come back in its
    one read-back, and they equal the per-batch path's from the same
    weights."""
    trainer = runs["scan"]
    saved = {k: v.clone() for k, v in trainer.policy.state_dict().items()}
    saved_optim = {id(p): {k: v.clone() for k, v in s.items()} for p, s in trainer.optimizer.state.items()}

    def riter():
        return ResidentBatchIterator(trainer._bank, batch_size=2, seed=99, time_major=True)

    def restore():
        trainer.policy.load_state_dict(saved)
        for p, s in trainer.optimizer.state.items():
            for k, v in saved_optim[id(p)].items():
                s[k].copy_(v)

    steps = {id(s["step"]) for s in trainer.optimizer.state.values()}
    assert steps and all(s["step"].device.type == "cpu" for s in trainer.optimizer.state.values())
    enqueue = DeviceTrajectoryBank.enqueue_steps
    real_tolist, real_item = torch.Tensor.tolist, torch.Tensor.item
    calls = {"enqueued": 0, "tolist": 0}

    def refuse(self):
        raise AssertionError("a tensor was tested for truth while a run was enqueued")

    def refusing(self, *args):
        calls["enqueued"] += 1
        with monkeypatch.context() as patch:
            patch.setattr(torch.Tensor, "__bool__", refuse)
            patch.setattr(torch.Tensor, "tolist", lambda t: refuse(t))
            patch.setattr(torch.Tensor, "item", lambda t: real_item(t) if id(t) in steps else refuse(t))
            return enqueue(self, *args)

    def counting_tolist(self):
        calls["tolist"] += 1
        return real_tolist(self)

    try:
        with monkeypatch.context() as patch:
            patch.setattr(DeviceTrajectoryBank, "enqueue_steps", refusing)
            patch.setattr(torch.Tensor, "tolist", counting_tolist)
            fused = run_fused_epoch(riter(), trainer._get_train_step())
        assert calls == {"enqueued": 1, "tolist": 1} and len(fused) == 6
        fused_state = {k: v.clone() for k, v in trainer.policy.state_dict().items()}
        restore()
        per_batch = [trainer._update_agent(*batch) for batch in riter()]
        np.testing.assert_array_equal(np.asarray(fused), np.asarray(per_batch))
        for k, v in trainer.policy.state_dict().items():
            assert torch.equal(v, fused_state[k]), k
    finally:
        restore()


def test_preload_resident_matches_the_store_path(runs, tmp_path):
    """IL.DAGGER.preload_lmdb_features with the bank (the store uploaded
    once) trains with the store path's losses."""
    store = str(runs["tmp"] / "store" / "trajectories")
    losses = {}
    for name, extra in (("store", []), ("resident", ["CUDA.DAGGER_RESIDENT", True])):
        trainer = _port_trainer(tmp_path / name, runs["ckpt"], ["IL.DAGGER.preload_lmdb_features", True,
                                                                "IL.DAGGER.lmdb_features_dir", store, "IL.epochs", 1, *extra])
        trainer.train()
        losses[name] = _losses(trainer)
        if extra:
            assert len(trainer._bank) == store_length(store) == 12 and trainer.collection_stats == []
    assert losses["store"].shape == (12, 3)  # two rounds over the same 12 stored episodes
    np.testing.assert_allclose(losses["resident"], losses["store"], rtol=2e-6, atol=1e-7)


def test_resident_without_a_source_raises(runs, tmp_path):
    trainer = _port_trainer(tmp_path, runs["ckpt"], ["CUDA.DAGGER_RESIDENT", True])
    with pytest.raises(RuntimeError, match="CUDA.DAGGER_RESIDENT needs CUDA.ON_DEVICE_DAGGER"):
        trainer.train()
