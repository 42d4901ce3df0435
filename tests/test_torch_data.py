"""The port's training data path (trajectory store, collate, batch iterator,
prefetch) against the JAX package's: the same seed must give bit-equal
batches in the same order, and the two stores must hold equal content."""

import random
import threading

import numpy as np
import pytest

from vlnce_tpu.data import collate as jax_collate
from vlnce_tpu.data.trajectory_store import TrajectoryStoreReader as JaxReader
from vlnce_torch.data import collate
from vlnce_torch.data.prefetch import PrefetchIterator
from vlnce_torch.data.trajectory_store import (
    TrajectoryStoreReader,
    TrajectoryStoreWriter,
    pack_episode,
    store_exists,
    store_length,
    unpack_episode,
)

from tests.torch_port_cases import write_both_stores


def _episodes(seed, lengths, fp16=False):
    rng = np.random.RandomState(seed)
    episodes = []
    for n in lengths:
        oracle = rng.randint(0, 4, n).astype(np.int64)
        episodes.append([
            {
                "instruction": np.repeat(rng.randint(0, 30, (1, 20)).astype(np.int32), n, axis=0),
                "progress": rng.rand(n, 1).astype(np.float32),
                "rgb_features": rng.randn(n, 8, 4, 4).astype(np.float16 if fp16 else np.float32),
                "depth_features": rng.randn(n, 6, 2, 2).astype(np.float16 if fp16 else np.float32),
            },
            np.concatenate([[0], oracle[:-1]]).astype(np.int64),
            oracle,
        ])
    return episodes


def _assert_same_tree(a, b):
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _assert_same_tree(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same_tree(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("coef", [3.2, 1.0])
def test_inflection_weights_equal_jax(coef):
    rng = np.random.RandomState(0)
    for n in (1, 2, 9):
        oracle = rng.randint(0, 3, n)
        _assert_same_tree(collate.inflection_weights(oracle, coef), jax_collate.inflection_weights(oracle, coef))
    assert collate.inflection_weights(np.array([1, 1, 2, 2, 0]), 3.2).tolist() == [np.float32(3.2), 1.0, np.float32(3.2), 1.0, np.float32(3.2)]


@pytest.mark.parametrize("quantum", [1, 16])
def test_collate_episodes_equal_jax(quantum):
    eps = _episodes(1, [3, 7, 5])
    batch = [(ep[0], ep[1], ep[2], collate.inflection_weights(ep[2], 3.2)) for ep in eps]
    got = collate.collate_episodes(batch, quantum)
    _assert_same_tree(got, jax_collate.collate_episodes(batch, quantum))
    obs, prev, masks, corrected, weights = got
    T = 7 if quantum == 1 else 16
    assert corrected.shape == (T, 3) and prev.shape == (T * 3, 1) and obs["rgb_features"].shape == (T * 3, 8, 4, 4)
    tn = obs["progress"].reshape(T, 3, 1)
    assert np.all(tn[3:, 0] == 1.0) and np.all(weights[3:, 0] == 0.0)  # obs padded with 1, the rest with 0
    assert np.all(masks.reshape(T, 3)[0] == 0.0) and np.all(masks.reshape(T, 3)[1:] == 1.0)
    assert collate.LENGTH_QUANTUM == jax_collate.LENGTH_QUANTUM == 16


@pytest.mark.parametrize("n,batch_size,preload", [(23, 4, 8), (5, 2, 200), (40, 5, 500)])
def test_iterate_episode_keys_equal_jax(n, batch_size, preload):
    lengths = np.random.RandomState(n).randint(1, 30, n)
    got = list(collate.iterate_episode_keys(n, lambda k: int(lengths[k]), batch_size, random.Random(7), preload))
    ref = list(jax_collate.iterate_episode_keys(n, lambda k: int(lengths[k]), batch_size, random.Random(7), preload))
    assert got == ref and sorted(got) == list(range(n))
    assert collate.block_shuffle(list(range(10)), 3, random.Random(1)) == jax_collate.block_shuffle(list(range(10)), 3, random.Random(1))


@pytest.mark.parametrize("use_iw", [True, False])
def test_batch_iterator_equals_jax_over_two_epochs(tmp_path, use_iw):
    eps = _episodes(2, [4, 9, 2, 6, 6, 3, 8])
    write_both_stores(eps, tmp_path / "jax", tmp_path / "torch")
    jax_reader, reader = JaxReader(str(tmp_path / "jax")), TrajectoryStoreReader(str(tmp_path / "torch"))
    ref_iter = jax_collate.TrajectoryBatchIterator(jax_reader, batch_size=2, use_iw=use_iw, seed=3)
    got_iter = collate.TrajectoryBatchIterator(reader, batch_size=2, use_iw=use_iw, seed=3)
    assert len(got_iter) == len(ref_iter) == 3
    for _ in range(2):  # the iterator's rng carries on across epochs
        ref, got = list(ref_iter), list(got_iter)
        assert len(got) == 3  # drop_last
        _assert_same_tree(got, ref)
    jax_reader.close()
    reader.close()


@pytest.mark.parametrize("fp16", [False, True])
def test_store_round_trip_keeps_dtypes_and_shapes(tmp_path, fp16):
    eps = _episodes(3, [3, 1, 5], fp16=fp16)
    assert not store_exists(str(tmp_path / "s")) and store_length(str(tmp_path / "s")) == 0
    writer = TrajectoryStoreWriter(str(tmp_path / "s"))
    assert [writer.put(ep) for ep in eps] == [0, 1, 2] and len(writer) == 3
    writer.close()
    assert store_exists(str(tmp_path / "s")) and store_length(str(tmp_path / "s")) == 3
    reader = TrajectoryStoreReader(str(tmp_path / "s"))
    assert len(reader) == 3
    for k, ep in enumerate(eps):
        _assert_same_tree(reader.get(k), ep)
        _assert_same_tree(unpack_episode(reader.get_raw(k)), ep)
    assert reader.get(0)[0]["rgb_features"].dtype == (np.float16 if fp16 else np.float32)
    reader.close()


def test_stores_of_both_packages_hold_equal_content(tmp_path):
    eps = _episodes(4, [2, 4])
    write_both_stores(eps, tmp_path / "jax", tmp_path / "torch")
    jax_reader, reader = JaxReader(str(tmp_path / "jax")), TrajectoryStoreReader(str(tmp_path / "torch"))
    assert len(jax_reader) == len(reader) == 2
    for k in range(2):
        ref, got = jax_reader.get(k), reader.get(k)
        assert sorted(got[0]) == sorted(ref[0])
        for name in got[0]:
            _assert_same_tree(got[0][name], ref[0][name])
        _assert_same_tree(got[1:], [np.asarray(x) for x in ref[1:]])


def test_store_reopens_and_appends(tmp_path):
    eps = _episodes(5, [2, 3, 4])
    writer = TrajectoryStoreWriter(str(tmp_path / "s"))
    writer.put(eps[0])
    writer.close()
    writer = TrajectoryStoreWriter(str(tmp_path / "s"))
    assert len(writer) == 1 and writer.put(eps[1]) == 1
    writer.close()
    reader = TrajectoryStoreReader(str(tmp_path / "s"))
    _assert_same_tree([reader.get(0), reader.get(1)], eps[:2])
    reader.close()
    TrajectoryStoreWriter(str(tmp_path / "s"), drop_existing=True).close()
    assert store_length(str(tmp_path / "s")) == 0 and len(TrajectoryStoreReader(str(tmp_path / "s"))) == 0


def test_reader_opened_while_the_writer_commits_sees_whole_episodes(tmp_path):
    eps = _episodes(6, [3, 3, 3, 3])
    writer = TrajectoryStoreWriter(str(tmp_path / "s"))
    writer.put(eps[0])
    writer.put(eps[1])
    writer.commit()
    writer.put(eps[2])  # buffered, not committed
    early = TrajectoryStoreReader(str(tmp_path / "s"))
    assert 2 <= len(early) <= 3
    for k in range(len(early)):
        _assert_same_tree(early.get(k), eps[k])
    writer.put(eps[3])
    writer.commit()
    assert len(early) <= 3  # a reader holds what was there when it opened
    late = TrajectoryStoreReader(str(tmp_path / "s"))
    assert len(late) == 4
    _assert_same_tree(late.get(3), eps[3])
    _assert_same_tree(early.get(1), eps[1])
    for r in (early, late):
        r.close()
    writer.close()


def test_store_refuses_object_arrays_and_never_unpickles(tmp_path):
    with pytest.raises(TypeError, match="object arrays"):
        pack_episode([{"x": np.array([{"a": 1}], dtype=object)}, np.zeros(1, np.int64), np.zeros(1, np.int64)])
    import io

    buf = io.BytesIO()
    np.savez(buf, **{"obs.x": np.array([{"a": 1}], dtype=object), "prev_actions": np.zeros(1), "oracle_actions": np.zeros(1)})
    with pytest.raises(ValueError, match="allow_pickle"):
        unpack_episode(buf.getvalue())


class _Source:
    def __init__(self, n, fail_at=None):
        self.n, self.fail_at, self.iterations, self.threads = n, fail_at, 0, set()

    def __len__(self):
        return self.n

    def __iter__(self):
        self.iterations += 1
        for i in range(self.n):
            self.threads.add(threading.current_thread().name)
            if i == self.fail_at:
                raise KeyError(f"item {i}")
            yield i


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_prefetch_keeps_order_and_iterates_again(depth):
    source = _Source(7)
    it = PrefetchIterator(source, depth=depth)
    assert len(it) == 7
    assert list(it) == list(range(7)) and list(it) == list(range(7)) and source.iterations == 2
    assert source.threads == ({"prefetch"} if depth > 0 else {threading.current_thread().name})


def test_prefetch_raises_the_source_error_where_it_occurred():
    got = []
    with pytest.raises(KeyError, match="item 3"):
        for item in PrefetchIterator(_Source(6, fail_at=3), depth=2):
            got.append(item)
    assert got == [0, 1, 2]


def test_prefetch_stops_its_thread_when_the_consumer_leaves():
    it = iter(PrefetchIterator(_Source(1000), depth=1))
    assert next(it) == 0
    it.close()
    assert not [t for t in threading.enumerate() if t.name == "prefetch" and t.is_alive()]
