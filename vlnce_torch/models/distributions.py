"""Action distributions (port of vlnce_tpu/models/distributions.py;
reference vlnce_baselines/models/utils.py:12-21, 24-152, 269-317).

- `Categorical` (CustomFixedCategorical): sample/mode return [..., 1];
  log_prob takes [..., 1] and returns [..., 1].
- `TruncatedNormal`: the two-sided truncated normal of the waypoint heads,
  parameterized by the untruncated (loc, scale), with the reference's
  analytic mean, variance and entropy and its normalized-density log_prob.
  It samples by inverse CDF (as the JAX package does, where the reference
  rejects): `icdf(u)` maps a probability u in [cdf(smin), cdf(smax)] to the
  value, and `sample` feeds it a uniform draw.

Sampling draws from an explicit `torch.Generator` on the parameters'
device.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

_LOG_SQRT_2PI = 0.5 * math.log(2 * math.pi)
_HALF_LOG_2PIE = 0.5 * math.log(2 * math.pi * math.e)


def _std_cdf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def _std_pdf(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(-0.5 * x * x) / math.sqrt(2 * math.pi)


def _std_icdf(u: torch.Tensor) -> torch.Tensor:
    return math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)


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

    def icdf(self, u: torch.Tensor) -> torch.Tensor:
        """The action whose cumulative probability first exceeds u [...] in
        [0, 1): a draw from uniforms made beforehand, with no call that
        reads a value back (multinomial checks its input on the host, which
        a CUDA graph's capture refuses). Returns [..., 1] int64."""
        cdf = torch.cumsum(self.probs, dim=-1)
        below = (cdf < u[..., None]).sum(dim=-1, keepdim=True)
        return below.clamp(max=self.logits.shape[-1] - 1)

    def log_prob(self, actions: torch.Tensor) -> torch.Tensor:
        return torch.gather(self.logits, -1, actions.long())

    def entropy(self) -> torch.Tensor:
        return -(self.probs * self.logits).sum(-1)


class TruncatedNormal:
    """Normal(loc, scale) truncated to [smin, smax]."""

    def __init__(self, loc: torch.Tensor, scale: torch.Tensor, smin: float, smax: float):
        assert smin < smax and math.isfinite(smin) and math.isfinite(smax)
        self._loc = loc
        self._scale = scale
        self._smin = smin
        self._smax = smax
        self._alpha = (smin - loc) / scale
        self._beta = (smax - loc) / scale
        self._alpha_cdf = _std_cdf(self._alpha)
        self._beta_cdf = _std_cdf(self._beta)
        self._Z = self._beta_cdf - self._alpha_cdf  # truncated mass

    @property
    def mean(self) -> torch.Tensor:
        return self._loc - self._scale * (_std_pdf(self._beta) - _std_pdf(self._alpha)) / self._Z

    @property
    def variance(self) -> torch.Tensor:
        a_pdf, b_pdf = _std_pdf(self._alpha), _std_pdf(self._beta)
        t1 = (self._beta * b_pdf - self._alpha * a_pdf) / self._Z
        t2 = ((b_pdf - a_pdf) / self._Z) ** 2
        return (self._scale**2) * (1.0 - t1 - t2)

    def mode(self) -> torch.Tensor:
        return self._loc

    def icdf(self, u: torch.Tensor) -> torch.Tensor:
        """The value at probability u of the untruncated normal, u drawn in
        [cdf(smin), cdf(smax)], clipped to [smin, smax]."""
        return torch.clamp(self._loc + self._scale * _std_icdf(u), self._smin, self._smax)

    def draw(self, u01: torch.Tensor) -> torch.Tensor:
        """The truncated distribution's value at a uniform u01 in [0, 1),
        shaped as loc: u01 mapped into [cdf(smin), cdf(smax)], then `icdf`."""
        return self.icdf(self._alpha_cdf + u01 * self._Z)

    def sample(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.draw(torch.rand(self._loc.shape, generator=generator, device=self._loc.device, dtype=self._loc.dtype))

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        z = (value - self._loc) / self._scale
        return -0.5 * z * z - torch.log(self._scale) - _LOG_SQRT_2PI - torch.log(self._Z)

    def entropy(self) -> torch.Tensor:
        a_pdf, b_pdf = _std_pdf(self._alpha), _std_pdf(self._beta)
        return _HALF_LOG_2PIE + torch.log(self._scale * self._Z) + (self._alpha * a_pdf - self._beta * b_pdf) / (2.0 * self._Z)


def temperature_tanh(x: torch.Tensor, temperature: float = 1.0) -> torch.Tensor:
    """reference vlnce_baselines/models/utils.py:12-21."""
    assert temperature != 0.0
    return torch.tanh(x / temperature)


def batched_index_select(x: torch.Tensor, dim: int, index: torch.Tensor) -> torch.Tensor:
    """Per-row index_select along `dim`, squeezing the selected dim
    (reference vlnce_baselines/models/utils.py:292-317). index: [B]."""
    shape = list(x.shape)
    shape[dim] = 1
    idx = index.reshape([x.shape[0]] + [1] * (x.dim() - 1)).long().expand(shape)
    return torch.gather(x, dim, idx).squeeze(dim)
