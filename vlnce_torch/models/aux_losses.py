"""Auxiliary-loss plumbing (port of vlnce_tpu/models/aux_losses.py).

The reference uses a mutable global singleton that modules push losses into
during forward (reference vlnce_baselines/common/aux_losses.py:1-44). As in
the JAX package, the port's nets *return* an aux dict of per-sample loss
terms alongside their outputs; this module provides the same masked
reduction the trainer applied, and the singleton as a shim for user code
written against the reference interface.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def reduce_aux_losses(aux: Dict[str, Tuple[torch.Tensor, float]], mask: torch.Tensor) -> torch.Tensor:
    """aux maps name -> (per_sample_loss [B'], alpha). Returns the sum of
    masked means, mirroring _AuxLosses.reduce (reference aux_losses.py:24-32).
    mask: [B'] with 1 for valid samples."""
    mask = mask.reshape(-1).float()
    total = torch.zeros((), dtype=torch.float32, device=mask.device)
    denom = mask.sum().clamp(min=1.0)
    for loss, alpha in aux.values():
        total = total + alpha * (loss.reshape(-1) * mask).sum() / denom
    return total


class AuxLosses:
    """API-compatible shim of the reference singleton (activate / deactivate
    / register_loss / reduce). The port's nets use returned aux dicts."""

    _losses: Dict[str, Tuple[torch.Tensor, float]] = {}
    _is_active: bool = False

    @classmethod
    def activate(cls) -> None:
        cls._is_active = True

    @classmethod
    def deactivate(cls) -> None:
        cls._is_active = False

    @classmethod
    def is_active(cls) -> bool:
        return cls._is_active

    @classmethod
    def clear(cls) -> None:
        cls._losses = {}

    @classmethod
    def register_loss(cls, name: str, loss, alpha: float = 1.0) -> None:
        cls._losses[name] = (loss, alpha)

    @classmethod
    def get_loss(cls, name: str):
        return cls._losses[name][0]

    @classmethod
    def reduce(cls, mask) -> torch.Tensor:
        return reduce_aux_losses(cls._losses, mask)
