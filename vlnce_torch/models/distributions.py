"""Categorical action distribution (port of vlnce_tpu/models/distributions.py,
reference vlnce_baselines/models/utils.py:269-289 CustomFixedCategorical).

sample/mode return [..., 1]; log_prob takes [..., 1] and returns [..., 1].
Sampling draws from an explicit `torch.Generator` on the logits' device.
"""

from __future__ import annotations

from typing import Optional

import torch


class Categorical:
    def __init__(self, logits: torch.Tensor):
        self.logits = logits - torch.logsumexp(logits, dim=-1, keepdim=True)

    @property
    def probs(self) -> torch.Tensor:
        return torch.exp(self.logits)

    def sample(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        flat = self.probs.reshape(-1, self.logits.shape[-1])
        return torch.multinomial(flat, 1, generator=generator).reshape(self.logits.shape[:-1] + (1,))

    def mode(self) -> torch.Tensor:
        return torch.argmax(self.logits, dim=-1, keepdim=True)

    def log_prob(self, actions: torch.Tensor) -> torch.Tensor:
        return torch.gather(self.logits, -1, actions.long())

    def entropy(self) -> torch.Tensor:
        return -(self.probs * self.logits).sum(-1)

