"""On-disk trajectory store (LMDB replacement).

The reference stores msgpack'd (obs-dict, prev_actions, oracle_actions)
episodes in LMDB under integer keys (reference dagger_trainer.py:145-151,
323-372). This is the port of vlnce_tpu/data/trajectory_store.py, an
append-only segment store with the same contract: integer keys 0..N-1, single
writer, many concurrent mmap readers, periodic commit. Layout:

    <dir>/data.bin    -- concatenated episode blobs
    <dir>/index.bin   -- int64 pairs (offset, length) per key

An episode `[obs_dict, prev_actions, oracle_actions]` is encoded in numpy's
own format (`np.savez` into memory, read back with `allow_pickle=False`), not
in msgpack as the JAX package does: the two packages' stores are equal in
content (keys, order, dtypes, shapes, values), not in bytes, and neither
reads the other's files.
"""

from __future__ import annotations

import io
import mmap
import os
import struct
from typing import Any, Dict, List

import numpy as np

_IDX_FMT = "<qq"  # offset, length
_IDX_SIZE = struct.calcsize(_IDX_FMT)
_OBS_PREFIX = "obs."


def pack_episode(obj: List[Any]) -> bytes:
    """[obs_dict of arrays, prev_actions, oracle_actions] -> bytes."""
    obs, prev_actions, oracle_actions = obj
    arrays = {f"{_OBS_PREFIX}{k}": np.asarray(v) for k, v in obs.items()}
    arrays["prev_actions"] = np.asarray(prev_actions)
    arrays["oracle_actions"] = np.asarray(oracle_actions)
    for name, a in arrays.items():
        if a.dtype == object:
            raise TypeError(f"cannot serialize {name}: object arrays are not stored")
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def unpack_episode(buf: bytes) -> List[Any]:
    with np.load(io.BytesIO(buf), allow_pickle=False) as z:
        obs: Dict[str, np.ndarray] = {k[len(_OBS_PREFIX):]: z[k] for k in z.files if k.startswith(_OBS_PREFIX)}
        return [obs, z["prev_actions"], z["oracle_actions"]]


class TrajectoryStoreWriter:
    """Single-writer appender with explicit commit (fsync) points."""

    def __init__(self, directory: str, drop_existing: bool = False):
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self._data_path = os.path.join(directory, "data.bin")
        self._index_path = os.path.join(directory, "index.bin")
        mode = "wb" if drop_existing or not os.path.exists(self._data_path) else "r+b"
        self._data_f = open(self._data_path, mode)
        self._index_f = open(self._index_path, mode)
        self._data_f.seek(0, os.SEEK_END)
        self._index_f.seek(0, os.SEEK_END)
        self._offset = self._data_f.tell()
        self._count = self._index_f.tell() // _IDX_SIZE

    def __len__(self) -> int:
        return self._count

    def put(self, obj: Any) -> int:
        """Append one episode; returns its integer key."""
        blob = pack_episode(obj)
        self._data_f.write(blob)
        self._index_f.write(struct.pack(_IDX_FMT, self._offset, len(blob)))
        self._offset += len(blob)
        key = self._count
        self._count += 1
        return key

    def commit(self) -> None:
        # data before index: a reader that sees an index entry finds its blob
        self._data_f.flush()
        os.fsync(self._data_f.fileno())
        self._index_f.flush()
        os.fsync(self._index_f.fileno())

    def close(self) -> None:
        self.commit()
        self._data_f.close()
        self._index_f.close()


class TrajectoryStoreReader:
    """mmap reader of what was committed when it opened; safe to open in many
    processes/threads, also while the writer goes on appending."""

    def __init__(self, directory: str):
        self.directory = directory
        self._data_path = os.path.join(directory, "data.bin")
        self._index_path = os.path.join(directory, "index.bin")
        with open(self._index_path, "rb") as f:
            raw = f.read()
        raw = raw[: len(raw) // _IDX_SIZE * _IDX_SIZE]
        index = np.frombuffer(raw, dtype=np.int64).reshape(-1, 2)
        self._data_f = open(self._data_path, "rb")
        # entries the writer has buffered past the data it has flushed are not there yet
        size = os.fstat(self._data_f.fileno()).st_size
        self._index = index[: int(np.searchsorted(index[:, 0] + index[:, 1], size, side="right"))]
        self._mm = mmap.mmap(self._data_f.fileno(), 0, access=mmap.ACCESS_READ) if self._index.size else None

    def __len__(self) -> int:
        return len(self._index)

    def get(self, key: int) -> Any:
        return unpack_episode(self.get_raw(key))

    def get_raw(self, key: int) -> bytes:
        offset, length = self._index[key]
        return self._mm[offset : offset + length]

    def close(self) -> None:
        if self._mm is not None:
            self._mm.close()
        self._data_f.close()


def store_exists(directory: str) -> bool:
    return os.path.exists(os.path.join(directory, "index.bin"))


def store_length(directory: str) -> int:
    path = os.path.join(directory, "index.bin")
    if not os.path.exists(path):
        return 0
    return os.path.getsize(path) // _IDX_SIZE
