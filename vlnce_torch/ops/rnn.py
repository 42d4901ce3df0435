"""Masked GRU over a sequence: the CUDA kernel (csrc/gru_sequence.cu) and its
plain PyTorch version.

Replaces vlnce_tpu/ops/pallas_rnn.py:gru_sequence. Semantics are those of
the masked GRU in RNNStateEncoder: torch gate order (r, z, n), and the hidden
state is reset by `h *= mask` before each step. `RNNStateEncoder` runs its
GRU through `gru_sequence` in both modes (a single act step is T=1).
Forward only: the JAX kernel has no gradient either.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from vlnce_torch.ops import _build


def gru_sequence_plain(xi, masks, h0, w_hh, b_hh):
    """xi [T, B, 3H] input projections (+ b_ih); masks [T, B, 1]; h0 [B, H];
    w_hh [3H, H] (torch layout); b_hh [3H]. Returns outs [T, B, H] in f32;
    the final state is outs[-1]."""
    xi, masks, h, w_hh, b_hh = (t.float() for t in (xi, masks, h0, w_hh, b_hh))
    H = h.shape[1]
    outs = []
    for t in range(xi.shape[0]):
        h = h * masks[t]
        hh = h @ w_hh.T + b_hh
        r = torch.sigmoid(xi[t, :, :H] + hh[:, :H])
        z = torch.sigmoid(xi[t, :, H : 2 * H] + hh[:, H : 2 * H])
        n = torch.tanh(xi[t, :, 2 * H :] + r * hh[:, 2 * H :])
        h = (1.0 - z) * n + z * h
        outs.append(h)
    return torch.stack(outs)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("gru_sequence").gru_sequence_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def gru_sequence(xi, masks, h0, w_hh, b_hh):
    """`gru_sequence_plain` for tensors on the CPU; on CUDA tensors one launch
    of the kernel for the whole sequence. Every input must be f32 and
    contiguous, on one device."""
    if xi.device.type == "cpu":
        return gru_sequence_plain(xi, masks, h0, w_hh, b_hh)
    T, B, threeH = xi.shape
    H = threeH // 3
    expected = {"xi": (T, B, 3 * H), "masks": (T, B, 1), "h0": (B, H), "w_hh": (3 * H, H), "b_hh": (3 * H,)}
    for name, t in zip(expected, (xi, masks, h0, w_hh, b_hh)):
        if t.device != xi.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"gru_sequence: {name} must be a contiguous float32 tensor on {xi.device}")
        if tuple(t.shape) != expected[name]:
            raise ValueError(f"gru_sequence: {name} has shape {tuple(t.shape)}, expected {expected[name]}")
    if H % 4 or 16 * H > 48 * 1024:
        raise ValueError(f"gru_sequence: the kernel takes H a multiple of 4 up to 3072, got H={H}")
    out = torch.empty((T, B, H), dtype=torch.float32, device=xi.device)
    if T * B == 0:
        return out
    with torch.cuda.device(xi.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _kernel()(
            xi.data_ptr(), masks.data_ptr(), h0.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
            out.data_ptr(), T, B, H, stream,
        )
    _build.check("gru_sequence", status)
    gru_sequence.launches += 1
    return out


gru_sequence.launches = 0
