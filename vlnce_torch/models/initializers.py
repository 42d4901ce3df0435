"""Parameter initializers with the JAX package's distributions.

Seeded weights in the port follow the flax initializers the JAX modules
declare, drawn from an explicit `torch.Generator`: lecun-normal (truncated
normal, variance 1/fan_in) for dense and conv kernels, zeros for biases,
orthogonal for recurrent and head weights, N(0, 1) for embedding tables.
Weights are stored in torch layout ([out, in, ...]); `fan_in` says which
axis flax would have counted.
"""

from __future__ import annotations

import math

import torch
from torch import nn

# std of a unit normal truncated to [-2, 2] (flax variance_scaling)
_TRUNC_STD = 0.87962566103423978


def variance_scaling_(w: torch.Tensor, scale: float, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    std = math.sqrt(scale / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def lecun_normal_(w: torch.Tensor, generator: torch.Generator, fan_in: int = None) -> torch.Tensor:
    """fan_in defaults to the torch-layout input size (in * kh * kw)."""
    return variance_scaling_(w, 1.0, fan_in or w[0].numel(), generator)


@torch.no_grad()
def init_default(module: nn.Module, generator: torch.Generator) -> None:
    """flax defaults for every dense/conv/norm/embedding under `module`, in
    module order: lecun-normal kernels, zero biases, unit norm scales,
    N(0, 1) embeddings."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            nn.init.normal_(m.weight, 0.0, 1.0, generator=generator)
