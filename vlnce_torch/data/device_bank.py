"""The trajectory bank on the card: collected DAgger features stay in device
memory and feed the IL train step directly.

Port of vlnce_tpu/data/device_bank.py. The store-wired DAgger loop moves
every trajectory twice: the collected frozen-encoder features come back to
the host into the trajectory store, then the train loop uploads them again
(the reference does the same through LMDB, dagger_trainer.py:341-372 and
539-567). Here collection and training share the card, so the bank keeps
every collected step there as ragged rows

    data[k]     : [S, F]  per-step feature rows (time-flattened; f16 is a
                  storage dtype, gathered as f32)
    prev/oracle : [S]     int32 action rows
    instruction : [E, L]  per episode (constant over an episode)

with (offsets, lengths) on the host as numpy arrays and on the card for the
gathers. At least one padding row (the trash row) holds the collate fill:
1.0 in every float data key, 0 in prev and oracle (`collate._pad_to`).

Batches are gathered on the card by `gather_core`, which returns exactly
the `collate_episodes` payload (obs [T*N, ...], prev [T*N, 1], masks
[T*N, 1], corrected [T, N], weights [T, N]) or the train step's time-major
layout, and their composition comes from the same `iterate_episode_keys`
stream as the store iterator's, so the losses are the store path's.

Across ranks each rank banks its own episodes on its own card (its
collection slice, or its `rank_slice` of a preloaded store), and the IL
step's all_reduce joins the ranks; the enqueued epoch runs on one process
only (`DaggerTrainer._fused_epoch_ok`). Left out of the JAX module, because
each exists only to bound XLA's compile cache or to place arrays on a
one-process mesh: `_gather_impl`'s jit, `_assemble_rows` (one `torch.cat`
does its work), the ROW_QUANTUM / EPISODE_QUANTUM padding (the trash row is
kept), `_pow2_chunks`, `_put` and `mesh`, and `align_collective_step`.
"""

from __future__ import annotations

import random
from typing import Callable, Dict, Iterator, List, Tuple

import numpy as np
import torch

from vlnce_torch.data.collate import LENGTH_QUANTUM, iterate_episode_keys
from vlnce_torch.envs.device_sim import upload
from vlnce_torch.utils.profiling import annotate


def gather_core(data: Dict[str, torch.Tensor], prev: torch.Tensor, oracle: torch.Tensor, instruction: torch.Tensor,
                offsets: torch.Tensor, lengths: torch.Tensor, trash: int, idx: torch.Tensor, coef: float, *, T_b: int,
                feat_shapes: Dict[str, tuple], instr_uuid: str, time_major: bool = False) -> Tuple:
    """One training batch of the episodes `idx` [N] from the bank's rows,
    gathered on their device: the collate_episodes payload, or with
    `time_major` the train step's [T, N, ...] layout (the same values).
    Nothing in it reads a value back, so a run of batches enqueues without
    waiting for the card."""
    N = idx.shape[0]
    device = idx.device
    off = offsets.index_select(0, idx)
    ln = lengths.index_select(0, idx)
    t = torch.arange(T_b, device=device)[:, None]
    valid = t < ln[None, :]
    flat = torch.where(valid, off[None, :] + t, trash).reshape(-1)
    lead = (T_b, N) if time_major else (T_b * N,)
    obs = {}
    for k, v in data.items():
        g = v.index_select(0, flat)
        if g.dtype == torch.float16:
            g = g.float()  # f16 was only the storage dtype
        obs[k] = g.reshape(lead + tuple(feat_shapes[k]))
    corrected = oracle.index_select(0, flat).reshape(T_b, N).long()
    prev_b = prev.index_select(0, flat).reshape(T_b, N).long()
    # inflection weights (data/collate.inflection_weights): coef at t=0 and
    # wherever the oracle action changes, 1 elsewhere, 0 on padding
    change = torch.cat([torch.ones(1, N, dtype=torch.bool, device=device), corrected[1:] != corrected[:-1]])
    weights = torch.where(change, coef, 1.0) * valid.float()
    masks = torch.ones(T_b, N, device=device)
    masks[0] = 0.0
    instr = instruction.index_select(0, idx)[None].expand((T_b, N) + tuple(instruction.shape[1:]))
    obs[instr_uuid] = instr.reshape(lead + tuple(instruction.shape[1:]))
    if time_major:
        return obs, prev_b, masks, corrected, weights
    return obs, prev_b.reshape(-1, 1), masks.reshape(-1, 1), corrected, weights


class DeviceTrajectoryBank:
    """Ragged per-step rows on the card, and the episode index.

    Row tensors may hold padding rows between episodes (offsets are
    absolute); `trash_index` names a padding row that holds the collate fill
    (1.0 in every float data key, 0 in prev and oracle)."""

    def __init__(self, data: Dict[str, torch.Tensor], prev: torch.Tensor, oracle: torch.Tensor,
                 instruction: torch.Tensor, offsets: np.ndarray, lengths: np.ndarray, feat_shapes: Dict[str, tuple],
                 trash_index: int, instr_uuid: str = "instruction"):
        self.data = data
        self.prev = prev
        self.oracle = oracle
        self.instruction = instruction
        self.offsets = np.asarray(offsets, np.int64)
        self.lengths = np.asarray(lengths, np.int64)
        self.feat_shapes = dict(feat_shapes)
        self.trash_index = int(trash_index)
        self.instr_uuid = instr_uuid
        index = upload({"offsets": self.offsets, "lengths": self.lengths}, prev.device)
        self._offsets_d, self._lengths_d = index["offsets"], index["lengths"]

    @property
    def device(self) -> torch.device:
        return self.prev.device

    def __len__(self) -> int:
        return int(self.offsets.shape[0])

    @property
    def num_steps(self) -> int:
        return int(self.lengths.sum())

    def nbytes(self) -> int:
        tensors = list(self.data.values()) + [self.prev, self.oracle, self.instruction]
        return int(sum(t.numel() * t.element_size() for t in tensors))

    # ------------------------------------------------------------ constructors
    @classmethod
    def from_rows(cls, row_chunks: List[Dict[str, torch.Tensor]], prev_chunks: List[torch.Tensor],
                  oracle_chunks: List[torch.Tensor], instr_chunks: List[torch.Tensor], lengths: List[int],
                  feat_shapes: Dict[str, tuple], instr_uuid: str = "instruction") -> "DeviceTrajectoryBank":
        """Assemble from per-chunk row blocks on the card (episode-major
        rows; padding rows at a chunk's tail are allowed, the offsets skip
        them) and one trash row, in one `torch.cat` per key."""
        keys = list(row_chunks[0])
        data = {k: torch.cat([c[k] for c in row_chunks] + [row_chunks[0][k].new_ones((1,) + row_chunks[0][k].shape[1:])])
                for k in keys}
        prev = torch.cat(list(prev_chunks) + [prev_chunks[0].new_zeros(1)])
        oracle = torch.cat(list(oracle_chunks) + [oracle_chunks[0].new_zeros(1)])
        lengths_arr = np.asarray(lengths, np.int64)
        offsets, base, li = [], 0, 0
        for chunk, instr in zip(row_chunks, instr_chunks):
            cursor = base
            for _ in range(instr.shape[0]):
                offsets.append(cursor)
                cursor += int(lengths_arr[li])
                li += 1
            base += int(chunk[keys[0]].shape[0])
        return cls(data, prev, oracle, torch.cat(list(instr_chunks)), np.asarray(offsets, np.int64), lengths_arr,
                   feat_shapes, trash_index=base, instr_uuid=instr_uuid)

    @classmethod
    def from_store(cls, reader, instr_uuid: str = "instruction", indices=None, device="cpu") -> "DeviceTrajectoryBank":
        """Upload a whole trajectory store (or the episodes `indices`) in one
        copy: preload_lmdb_features with the resident trainer."""
        host_rows: Dict[str, List[np.ndarray]] = {}
        prev_rows, oracle_rows, instrs, lengths = [], [], [], []
        feat_shapes: Dict[str, tuple] = {}
        for i in (range(len(reader)) if indices is None else indices):
            obs, prev, oracle = reader.get(i)
            T = len(prev)
            lengths.append(T)
            for k, v in obs.items():
                v = np.asarray(v)
                if k == instr_uuid:
                    instrs.append(v[0])
                    continue
                feat_shapes[k] = tuple(v.shape[1:])
                host_rows.setdefault(k, []).append(v.reshape(T, -1))
            prev_rows.append(np.asarray(prev, np.int32))
            oracle_rows.append(np.asarray(oracle, np.int32))
        n_rows = int(np.sum(lengths))
        arrays = {f"data.{k}": np.concatenate(rows + [np.ones((1,) + rows[0].shape[1:], rows[0].dtype)])
                  for k, rows in host_rows.items()}
        arrays["prev"] = np.concatenate(prev_rows + [np.zeros((1,), np.int32)])
        arrays["oracle"] = np.concatenate(oracle_rows + [np.zeros((1,), np.int32)])
        arrays["instruction"] = np.stack(instrs)
        on_dev = upload(arrays, device)
        data = {k: on_dev[f"data.{k}"] for k in host_rows}
        offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        return cls(data, on_dev["prev"], on_dev["oracle"], on_dev["instruction"], offsets, np.asarray(lengths),
                   feat_shapes, trash_index=n_rows, instr_uuid=instr_uuid)

    def extend(self, other: "DeviceTrajectoryBank") -> "DeviceTrajectoryBank":
        """Both banks' rows in one (DAgger aggregates its rounds). It copies
        both: for a moment the card holds twice the bank."""
        assert self.data.keys() == other.data.keys()
        s = int(self.prev.shape[0])  # my rows, padding included
        data = {k: torch.cat([self.data[k], other.data[k]]) for k in self.data}
        return DeviceTrajectoryBank(
            data, torch.cat([self.prev, other.prev]), torch.cat([self.oracle, other.oracle]),
            torch.cat([self.instruction, other.instruction]), np.concatenate([self.offsets, other.offsets + s]),
            np.concatenate([self.lengths, other.lengths]), self.feat_shapes, trash_index=self.trash_index,
            instr_uuid=self.instr_uuid,
        )

    # ---------------------------------------------------------------- gather
    def batch_T(self, episode_ids, length_quantum: int = LENGTH_QUANTUM) -> int:
        """The padded length of a batch of these episodes (collate's)."""
        T_b = int(self.lengths[np.asarray(episode_ids)].max())
        if length_quantum > 1:
            T_b = -(-T_b // length_quantum) * length_quantum
        return T_b

    def gather(self, idx: torch.Tensor, coef: float, T_b: int, time_major: bool = False) -> Tuple:
        """`gather_core` over this bank for the episode indices `idx` on its device."""
        return gather_core(self.data, self.prev, self.oracle, self.instruction, self._offsets_d, self._lengths_d,
                           self.trash_index, idx, coef, T_b=T_b, feat_shapes=self.feat_shapes,
                           instr_uuid=self.instr_uuid, time_major=time_major)

    def gather_batch(self, episode_ids: List[int], coef: float, length_quantum: int = LENGTH_QUANTUM,
                     time_major: bool = False) -> Tuple:
        """One training batch gathered on the card: the collate_episodes
        payload of these episodes (time_major: the train step's layout)."""
        idx = upload({"idx": np.asarray(episode_ids, np.int64)}, self.device)["idx"]
        return self.gather(idx, coef, self.batch_T(episode_ids, length_quantum), time_major)

    def enqueue_steps(self, step: Callable, idx: torch.Tensor, coef: float, T_b: int) -> torch.Tensor:
        """A run of K train steps over the [K, N] index matrix on the card:
        per step the time-major gather, then `step` (forward, backward,
        optimizer), all enqueued with no read-back. Returns the [K, 3]
        losses on the card. Each step is a `train.step` span holding a
        `train.gather`."""
        losses = []
        for k in range(idx.shape[0]):
            with annotate("train.step"):
                with annotate("train.gather"):
                    batch = self.gather(idx[k], coef, T_b, time_major=True)
                losses.append(torch.stack(step(*batch)))
        return torch.stack(losses)

    # --------------------------------------------------------------- archive
    def write_to_store(self, writer, fp16: bool = False, commit_every: int = 500) -> int:
        """Archive the bank into a trajectory store in the schema the host
        collection loop writes (one read-back of the rows)."""
        data_h = {k: v.cpu().numpy() for k, v in self.data.items()}
        prev_h, oracle_h = self.prev.cpu().numpy(), self.oracle.cpu().numpy()
        instr_h = self.instruction.cpu().numpy()
        for e in range(len(self)):
            lo, T = int(self.offsets[e]), int(self.lengths[e])
            obs: Dict[str, np.ndarray] = {self.instr_uuid: np.repeat(instr_h[e][None], T, axis=0)}
            for k, rows in data_h.items():
                arr = rows[lo : lo + T]
                if arr.dtype == np.float16 and not fp16:
                    arr = arr.astype(np.float32)
                obs[k] = arr.reshape((T,) + self.feat_shapes[k])
            writer.put([obs, prev_h[lo : lo + T].astype(np.int64), oracle_h[lo : lo + T].astype(np.int64)])
            if (e + 1) % commit_every == 0:
                writer.commit()
        writer.commit()
        return len(self)


class ResidentBatchIterator:
    """Batches of a DeviceTrajectoryBank in TrajectoryBatchIterator's episode
    order (the same `iterate_episode_keys` stream, one `random.Random(seed)`
    across the epochs), gathered on the card."""

    def __init__(self, bank: DeviceTrajectoryBank, batch_size: int, use_iw: bool = True,
                 inflection_weight_coef: float = 3.2, seed: int = 0, length_quantum: int = LENGTH_QUANTUM,
                 time_major: bool = False):
        self.bank = bank
        self.batch_size = batch_size
        self.preload_size = batch_size * 100
        self.coef = inflection_weight_coef if use_iw else 1.0
        self._rng = random.Random(seed)
        self.length_quantum = length_quantum
        self.time_major = time_major

    def __len__(self) -> int:
        return len(self.bank) // self.batch_size

    def _epoch_batches(self) -> Iterator[List[int]]:
        """One epoch of episode-id batches (drop_last, as the store
        iterator): the one source of batch composition for `__iter__` and
        `epoch_runs`, which advance the same rng."""
        batch: List[int] = []
        for k in iterate_episode_keys(len(self.bank), lambda i: int(self.bank.lengths[i]), self.batch_size, self._rng,
                                      self.preload_size):
            batch.append(k)
            if len(batch) == self.batch_size:
                yield batch
                batch = []

    def __iter__(self) -> Iterator[Tuple]:
        for batch in self._epoch_batches():
            yield self.bank.gather_batch(batch, self.coef, self.length_quantum, time_major=self.time_major)

    def _batch_T(self, batch: List[int]) -> int:
        return self.bank.batch_T(batch, self.length_quantum)

    def epoch_runs(self) -> Iterator[Tuple[int, np.ndarray]]:
        """The epoch's batches as (T_b, index matrix [K, N]) runs:
        consecutive batches of one padded length form a run, in the
        per-batch path's order."""
        with annotate("train.plan"):
            plan = [(self._batch_T(b), b) for b in self._epoch_batches()]
        i = 0
        while i < len(plan):
            j = i
            while j < len(plan) and plan[j][0] == plan[i][0]:
                j += 1
            yield plan[i][0], np.asarray([b for _, b in plan[i:j]], np.int64)
            i = j


def run_fused_epoch(riter: ResidentBatchIterator, step: Callable) -> List[Tuple[float, float, float]]:
    """One training epoch over the bank (CUDA.RESIDENT_EPOCH_SCAN): for each
    run of `epoch_runs`, the [K, N] index matrix is uploaded once, then all
    K gathers and train steps (`step`: `parallel/il_step.build_il_train_step`)
    are enqueued with no host synchronisation between them, and the [K, 3]
    losses are read back once per run. The JAX package runs each run as one
    `lax.scan` program; capturing the train step in a CUDA graph is not done
    here. Batch composition and order are the per-batch path's. Returns
    (loss, action_loss, aux_loss) per batch. Each run is a `train.run` span
    holding `train.run_upload`, the steps' spans and `train.readback`."""
    bank = riter.bank
    out: List[Tuple[float, float, float]] = []
    for T_b, rows in riter.epoch_runs():
        with annotate("train.run"):
            with annotate("train.run_upload"):
                idx = upload({"idx": rows}, bank.device)["idx"]
            losses = bank.enqueue_steps(step, idx, riter.coef, T_b)
            with annotate("train.readback"):
                out.extend(tuple(r) for r in losses.tolist())
    return out
