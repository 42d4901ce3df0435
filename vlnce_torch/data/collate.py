"""Episode batching for IL training.

Behavioral parity with reference dagger_trainer.py:39-121 (collate_fn,
_block_shuffle) and the IWTrajectoryDataset length-sorted block-shuffled
iteration (reference dagger_trainer.py:124-231): pad episodes to the batch
max length (obs fill 1.0! prev/oracle/weights fill 0), stack time-major
[T, N, ...], flatten obs to [T*N, ...], not_done_masks all-ones except t=0.

A copy of vlnce_tpu/data/collate.py (numpy only): the same seed gives the
same batches in both packages. The padded length is rounded UP to a multiple
of ``length_quantum``, so T takes few values and the cooperative launch of
the masked-GRU kernel sees few shapes.
"""

from __future__ import annotations

import random
from typing import Dict, Iterator, List, Tuple

import numpy as np

LENGTH_QUANTUM = 16


def block_shuffle(lst: List, block_size: int, rng: random.Random) -> List:
    blocks = [lst[i : i + block_size] for i in range(0, len(lst), block_size)]
    rng.shuffle(blocks)
    return [ele for block in blocks for ele in block]


def inflection_weights(oracle_actions: np.ndarray, coef: float) -> np.ndarray:
    """Weight 1 at t=0 and wherever the oracle action changes, else coef^0
    (reference dagger_trainer.py:199-211: inflec_weights[inflections])."""
    inflections = np.concatenate(
        [[1], (oracle_actions[1:] != oracle_actions[:-1]).astype(np.int64)]
    )
    table = np.array([1.0, coef], dtype=np.float32)
    return table[inflections]


def _pad_to(arr: np.ndarray, target_len: int, fill_val) -> np.ndarray:
    if arr.shape[0] == target_len:
        return arr
    pad = np.full((target_len - arr.shape[0],) + arr.shape[1:], fill_val, arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def collate_episodes(
    batch: List[Tuple[Dict[str, np.ndarray], np.ndarray, np.ndarray, np.ndarray]],
    length_quantum: int = LENGTH_QUANTUM,
):
    """batch items: (obs_dict of [T_i, ...], prev_actions [T_i],
    oracle_actions [T_i], weights [T_i]).

    Returns (observations [T*N, ...] dict, prev_actions [T*N, 1],
    not_done_masks [T*N, 1], corrected_actions [T, N], weights [T, N]).
    """
    N = len(batch)
    max_len = max(ep[1].shape[0] for ep in batch)
    if length_quantum > 1:
        max_len = int(-(-max_len // length_quantum) * length_quantum)

    obs_keys = batch[0][0].keys()
    observations: Dict[str, np.ndarray] = {}
    for k in obs_keys:
        stacked = np.stack([_pad_to(np.asarray(ep[0][k]), max_len, 1.0 if np.issubdtype(np.asarray(ep[0][k]).dtype, np.floating) else 1) for ep in batch], axis=1)
        observations[k] = stacked.reshape((max_len * N,) + stacked.shape[2:])

    prev_actions = np.stack([_pad_to(ep[1].astype(np.int64), max_len, 0) for ep in batch], axis=1)
    corrected = np.stack([_pad_to(ep[2].astype(np.int64), max_len, 0) for ep in batch], axis=1)
    weights = np.stack([_pad_to(ep[3].astype(np.float32), max_len, 0.0) for ep in batch], axis=1)

    not_done_masks = np.ones((max_len, N), np.float32)
    not_done_masks[0] = 0.0

    return (
        observations,
        prev_actions.reshape(-1, 1),
        not_done_masks.reshape(-1, 1),
        corrected,
        weights,
    )


def iterate_episode_keys(
    num_episodes: int,
    length_fn,
    batch_size: int,
    rng: random.Random,
    preload_size: int,
):
    """The reference's length-sorted block-shuffled episode ORDER as a pure
    key stream (reference dagger_trainer.py:179-186): block-shuffle the key
    space, then per preload chunk sort by (length, shuffled priority) and
    block-shuffle at batch granularity.

    `length_fn(key)` is called once per key, chunk by chunk — callers may
    cache the full payload there."""
    order = block_shuffle(list(range(num_episodes)), preload_size, rng)
    for start in range(0, len(order), preload_size):
        chunk_keys = order[start : start + preload_size]
        lengths = [length_fn(k) for k in chunk_keys]
        priority = list(range(len(chunk_keys)))
        rng.shuffle(priority)
        sorted_order = sorted(
            range(len(chunk_keys)), key=lambda i: (lengths[i], priority[i])
        )
        for i in block_shuffle(sorted_order, batch_size, rng):
            yield chunk_keys[i]


class TrajectoryBatchIterator:
    """Iterates a TrajectoryStore as collated batches with the reference's
    length-sorted block-shuffled preload order."""

    def __init__(
        self,
        reader,
        batch_size: int,
        use_iw: bool = True,
        inflection_weight_coef: float = 3.2,
        seed: int = 0,
        length_quantum: int = LENGTH_QUANTUM,
    ):
        self.reader = reader
        self.batch_size = batch_size
        self.preload_size = batch_size * 100
        self.coef = inflection_weight_coef if use_iw else 1.0
        self._rng = random.Random(seed)
        self.length_quantum = length_quantum

    def __len__(self) -> int:
        return len(self.reader) // self.batch_size

    def _episodes(self) -> Iterator:
        # payloads are decoded once per key inside length_fn and held until
        # yielded — at most one preload chunk resident, exactly as before
        cache: Dict[int, tuple] = {}

        def length_fn(k: int) -> int:
            cache[k] = self.reader.get(k)
            return len(cache[k][1])

        for k in iterate_episode_keys(
            len(self.reader), length_fn, self.batch_size, self._rng, self.preload_size
        ):
            obs, prev_actions, oracle_actions = (
                cache[k][0], np.asarray(cache[k][1]), np.asarray(cache[k][2])
            )
            del cache[k]
            weights = inflection_weights(oracle_actions, self.coef)
            yield (obs, prev_actions, oracle_actions, weights)

    def __iter__(self):
        batch = []
        for ep in self._episodes():
            batch.append(ep)
            if len(batch) == self.batch_size:
                yield collate_episodes(batch, self.length_quantum)
                batch = []
        # drop_last semantics (reference DataLoader drop_last=True)
