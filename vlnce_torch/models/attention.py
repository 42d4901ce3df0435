"""Single-query cross-attention (port of vlnce_tpu/models/attention.py;
reference vlnce_baselines/models/utils.py:155-178 and the CMA _attn at
cma_policy.py:207-217).

These are tiny (one query, P <= 512 keys), so they stay plain tensor code.
"""

from __future__ import annotations

from typing import Optional

import torch


def scaled_dot_attn(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """q: [B, Dk]; k: [B, Dk, P]; v: [B, Dv, P] -> [B, Dv].

    The mask marks PAD positions and is additive: energy -= mask * 1e8,
    applied before the scale (CMA convention, reference
    cma_policy.py:212-215). The waypoint policy's multiplicative mask comes
    with its slice.
    """
    energy = torch.einsum("bd,bdp->bp", q, k)
    if mask is not None:
        energy = energy - mask.to(energy.dtype) * 1e8
    attn = torch.softmax(energy * scale, dim=-1)
    return torch.einsum("bp,bdp->bd", attn, v)
