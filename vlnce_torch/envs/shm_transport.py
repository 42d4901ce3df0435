"""Shared-memory observation transport (ctypes over the native ring; port of
vlnce_tpu/envs/shm_transport.py).

Moves bulk sensor data from env worker processes to the pool's parent
process through the C++ ring (vlnce_torch/native/obs_ring.cpp) instead of
pickled pipes. The pipe still carries control traffic, small sensors and
the step's `info` (the measures, the top-down map among them); sensors of
at least `min_bytes` ride the ring. The schema (sensor -> offset, bytes,
shape, dtype) is fixed after the first reset, as in the JAX package.

Unlike the JAX module, nothing falls back silently: `ObsRing` raises when the
library cannot be built or the segment cannot be opened (a /dev/shm too
small for the arena among the causes), and `VectorEnv` uses the pipes only
when asked to (`VLNCE_TORCH_SHM_OBS=0`) or when no sensor reaches
`min_bytes`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import numpy as np

from vlnce_torch import native

# segment names of the port's rings: a process that holds a ring of each
# package never collides with the JAX package's `/vlnce_ring_` names
NAME_PREFIX = "/vlnce_torch_ring_"


def native_available() -> bool:
    """Whether the ring library builds and loads here."""
    try:
        native.load()
    except (RuntimeError, OSError):
        return False
    return True


class ObsSchema:
    """Fixed layout of one slot: sensor -> (offset, nbytes, shape, dtype)."""

    def __init__(self, template: Dict[str, np.ndarray], min_bytes: int = 4096):
        self.fields: Dict[str, Tuple[int, int, tuple, np.dtype]] = {}
        offset = 0
        for k in sorted(template):
            v = np.asarray(template[k])
            if v.nbytes < min_bytes:
                continue  # small sensors stay on the pipe
            self.fields[k] = (offset, v.nbytes, v.shape, v.dtype)
            offset += (v.nbytes + 63) // 64 * 64  # 64-byte aligned fields
        self.slot_bytes = max(offset, 64)

    def to_dict(self) -> Dict:
        """What a worker needs to attach (`from_dict`)."""
        return {"fields": dict(self.fields), "slot_bytes": self.slot_bytes}

    @classmethod
    def from_dict(cls, state: Dict) -> "ObsSchema":
        schema = cls.__new__(cls)
        schema.fields = dict(state["fields"])
        schema.slot_bytes = int(state["slot_bytes"])
        return schema


class ObsRing:
    """One arena of `n_slots` slots: workers write their observations into
    their own slot and publish a sequence number; the parent waits for it and
    gathers. The creator (`create=True`) owns the segment and unlinks it on
    `close`."""

    def __init__(self, name: str, n_slots: int, schema: ObsSchema, create: bool):
        self.lib = native.load()
        self.name = name.encode()
        self.schema = schema
        self.n_slots = n_slots
        self.handle = self.lib.obs_ring_open(self.name, n_slots, schema.slot_bytes, 1 if create else 0)
        if not self.handle:
            arena = n_slots * (schema.slot_bytes + 8)
            raise OSError(
                f"cannot {'create' if create else 'attach'} the shared-memory observation ring {name} of "
                f"{arena} bytes ({n_slots} slots of {schema.slot_bytes}): /dev/shm may be too small for it "
                f"(set VLNCE_TORCH_SHM_OBS=0 to send observations through the pipes)"
            )
        self._owner = create

    # -- worker side ---------------------------------------------------------
    def write_obs(self, slot: int, obs: Dict[str, np.ndarray], sequence: int) -> Dict[str, np.ndarray]:
        """Write the ring's sensors into `slot` and publish `sequence`;
        returns the rest, for the pipe."""
        rest = {}
        for k, v in obs.items():
            if k in self.schema.fields:
                offset, nbytes, _shape, dtype = self.schema.fields[k]
                arr = np.ascontiguousarray(np.asarray(v, dtype=dtype))
                if arr.nbytes != nbytes:
                    raise ValueError(f"sensor {k}: {arr.nbytes} bytes where the ring's schema holds {nbytes}")
                self.lib.obs_ring_write_nopub(self.handle, slot, offset, arr.ctypes.data_as(ctypes.c_void_p), nbytes)
            else:
                rest[k] = v
        self.lib.obs_ring_publish(self.handle, slot, sequence)
        return rest

    # -- parent side ---------------------------------------------------------
    def wait(self, slots: List[int], sequence: int, max_spins: int = 2_000_000_000) -> None:
        arr = (ctypes.c_int64 * len(slots))(*slots)
        if self.lib.obs_ring_wait(self.handle, arr, len(slots), sequence, max_spins) != 0:
            raise TimeoutError(f"obs ring wait timed out (seq {sequence})")

    def gather(self, slots: List[int], out: Optional[Dict[str, np.ndarray]] = None) -> Dict[str, np.ndarray]:
        """Batched [len(slots), ...] arrays of every ring sensor."""
        n = len(slots)
        slot_arr = (ctypes.c_int64 * n)(*slots)
        result = out if out is not None else {}
        for k, (offset, nbytes, shape, dtype) in self.schema.fields.items():
            if k not in result:
                result[k] = np.empty((n,) + shape, dtype)
            dst = result[k]
            if not dst.flags["C_CONTIGUOUS"] or dst.nbytes != n * nbytes:
                raise ValueError(f"gather of {k}: the output must be C-contiguous with {n * nbytes} bytes")
            self.lib.obs_ring_gather(self.handle, slot_arr, n, offset, nbytes, dst.ctypes.data_as(ctypes.c_void_p))
        return result

    def close(self) -> None:
        if self.handle:
            self.lib.obs_ring_close(self.handle, self.name, 1 if self._owner else 0)
            self.handle = None
