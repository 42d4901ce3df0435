"""The policy's weights, made by the benchmark from the seed on the device:
one normal draw for every tensor of `reference.cma.param_spec`, then each
element scaled and shifted by its tensor's kind, in a few large calls.
The program loads them by name; the reference reads the same tensors."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

# kind: (scale, shift, absolute value); "w" and "head" scale by 1 / sqrt(fan_in)
_KINDS = {
    "w": (1.0, 0.0, False),
    "head": (1.0, 0.0, False),
    "bias": (0.02, 0.0, False),
    "scale": (0.1, 1.0, False),
    "shift": (0.1, 0.0, False),
    "var": (0.2, 1.0, True),
    "emb": (1.0, 0.0, False),
    "head_bias": (0.0, 0.0, False),
}


def make(spec: List[Tuple[str, Tuple[int, ...], str, int]], seed: int, device, stop_bias: float = 0.0,
         gains: Dict[str, float] = None) -> Dict[str, torch.Tensor]:
    """{name: f32 tensor} as views of one buffer on `device`. `gains`
    multiplies the spread of the named tensors. `stop_bias` is subtracted
    from action 0's bias (STOP): large enough, no row ever stops, and every
    episode runs to its step cap."""
    gains = gains or {}
    counts = [int(torch.Size(shape).numel()) for _, shape, _, _ in spec]
    per = []
    for name, _, kind, fan in spec:
        scale, shift, absolute = _KINDS[kind]
        if kind in ("w", "head"):
            scale = scale / fan**0.5
        scale *= float(gains.get(name, 1.0))
        per.append((scale, shift, float(absolute)))
    per_t = torch.tensor(per, dtype=torch.float32, device=device)
    reps = torch.tensor(counts, device=device)
    g = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(counts), generator=g, device=device)
    scale, shift, absolute = (torch.repeat_interleave(per_t[:, i], reps) for i in range(3))
    flat = torch.where(absolute > 0, flat.abs(), flat) * scale + shift
    out, lo = {}, 0
    for (name, shape, _, _), n in zip(spec, counts):
        out[name] = flat[lo : lo + n].view(shape)
        lo += n
    if stop_bias:
        out["action_distribution.linear.bias"][0] -= stop_bias
    return out
