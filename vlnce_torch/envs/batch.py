"""Host -> device observation batching.

Port of vlnce_tpu/envs/batch.py (the reference habitat batch_obs used at
base_il_trainer.py:25,284): per-env numpy observations are stacked on the
host into one contiguous array per sensor and copied to the device once per
sensor, from pinned memory when the device is CUDA so the copy is
asynchronous. The env axis can be zero-padded to a fixed size, so paused
envs keep their slot. `ObsSlots` is the staging area of the eval and
inference loops: one host buffer per sensor that lives for the whole loop.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch


def stack_obs(observations: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """List of per-env obs dicts -> dict of [N, ...] numpy arrays."""
    keys = observations[0].keys()
    return {k: np.stack([np.asarray(o[k]) for o in observations], axis=0) for k in keys}


def batch_obs(
    observations: List[Dict[str, np.ndarray]],
    device,
    pad_to: Optional[int] = None,
) -> Dict[str, torch.Tensor]:
    """Stack and move obs to `device`; optionally zero-pad the env axis to a
    fixed size."""
    stacked = stack_obs(observations)
    n = len(observations)
    if pad_to is not None and pad_to > n:
        for k, v in stacked.items():
            pad = np.zeros((pad_to - n,) + v.shape[1:], v.dtype)
            stacked[k] = np.concatenate([v, pad], axis=0)
    return to_device(stacked, device)


def to_device(arrays: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """numpy arrays -> tensors on `device` (through pinned memory for CUDA)."""
    device = torch.device(device)
    out = {}
    for k, v in arrays.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[k] = t
    return out



class ObsSlots:
    """The stacked observations of a fixed set of N envs, kept on the host in
    one buffer per sensor (pinned when the device is CUDA) for the life of a
    loop. `update(i, obs)` overwrites slot i after env i stepped or reset;
    `to_device()` uploads all sensors, one asynchronous copy each. The copies
    read the buffers while they run, so the caller must have synchronised
    with the device (the loops do, when they download the actions) before it
    calls `update` again."""

    def __init__(self, observations: List[Dict[str, np.ndarray]], device):
        self.device = torch.device(device)
        self._host = {k: torch.from_numpy(v) for k, v in stack_obs(observations).items()}
        if self.device.type == "cuda":
            self._host = {k: t.pin_memory() for k, t in self._host.items()}
        self._arrays = {k: t.numpy() for k, t in self._host.items()}

    def update(self, index: int, obs: Dict[str, np.ndarray]) -> None:
        for k, v in obs.items():
            self._arrays[k][index] = np.asarray(v)

    def to_device(self) -> Dict[str, torch.Tensor]:
        return {k: t.to(self.device, non_blocking=True) for k, t in self._host.items()}

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self._host.values())
