"""Single-query cross-attention (port of vlnce_tpu/models/attention.py;
reference vlnce_baselines/models/utils.py:155-266 and the CMA _attn at
cma_policy.py:207-217).

These are tiny (one query, P <= 512 keys), so they stay plain tensor code.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def scaled_dot_attn(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, mask: Optional[torch.Tensor] = None,
    mask_mode: str = "additive",
) -> torch.Tensor:
    """q: [B, Dk]; k: [B, Dk, P]; v: [B, Dv, P] -> [B, Dv].

    mask_mode "additive": energy -= mask * 1e8, the mask marking PAD
    positions, applied before the scale (CMA convention, reference
    cma_policy.py:212-215). "multiplicative": energy *= mask (the waypoint
    DotProductAttention convention, reference models/utils.py:173-177).
    """
    energy = torch.einsum("bd,bdp->bp", q, k)
    if mask is not None:
        if mask_mode == "additive":
            energy = energy - mask.to(energy.dtype) * 1e8
        else:
            energy = energy * mask.to(energy.dtype)
    attn = torch.softmax(energy * scale, dim=-1)
    return torch.einsum("bp,bdp->bd", attn, v)


class MultiHeadDotProductAttention(nn.Module):
    """Single-query multi-head attention without residual (reference
    vlnce_baselines/models/utils.py:181-266): bias-free q/k/v/final
    projections, softmax of the multiplicatively masked energy scaled by
    1/sqrt(d_qk), then LayerNorm(eps=1e-6) with `normalize`. The JAX module's
    dropout is 0 in every config and has no counterpart here."""

    def __init__(self, d_q_in: int, d_k_in: int, d_v_in: int, d_qk: int, d_v: int, num_heads: int, d_out: int,
                 normalize: bool = True):
        super().__init__()
        self.d_qk, self.d_v, self.num_heads = d_qk, d_v, num_heads
        self.q_linear = nn.Linear(d_q_in, d_qk * num_heads, bias=False)
        self.k_linear = nn.Linear(d_k_in, d_qk * num_heads, bias=False)
        self.v_linear = nn.Linear(d_v_in, d_v * num_heads, bias=False)
        self.final_linear = nn.Linear(d_v * num_heads, d_out, bias=False)
        self.layer_norm = nn.LayerNorm(d_out, eps=1e-6) if normalize else None

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor] = None):
        """q: [B, d_q_in]; k: [B, d_k_in, P]; v: [B, d_v_in, P] -> [B, d_out]."""
        B, _, P = k.shape
        H = self.num_heads
        q_h = self.q_linear(q).reshape(B, H, self.d_qk)
        k_h = self.k_linear(k.transpose(1, 2)).reshape(B, P, H, self.d_qk)
        v_h = self.v_linear(v.transpose(1, 2)).reshape(B, P, H, self.d_v)
        energy = torch.einsum("bhd,bphd->bhp", q_h, k_h)
        if mask is not None:
            energy = energy * mask[:, None, :].to(energy.dtype)
        attn = torch.softmax(energy * (1.0 / self.d_qk**0.5), dim=-1)
        out = self.final_linear(torch.einsum("bhp,bphd->bhd", attn, v_h).reshape(B, H * self.d_v))
        return self.layer_norm(out) if self.layer_norm is not None else out
