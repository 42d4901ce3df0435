"""Masked GRU over a sequence: the CUDA kernel (csrc/gru_sequence.cu) and its
plain PyTorch version.

Replaces vlnce_tpu/ops/pallas_rnn.py:gru_sequence. Semantics are those of
the masked GRU in RNNStateEncoder: torch gate order (r, z, n), and the hidden
state is reset by `h *= mask` before each step. `RNNStateEncoder` runs its
GRU through `gru_sequence` in both modes (a single act step is T=1).
Forward only: the JAX kernel has no gradient either. The kernel partitions
the hidden units over the SMs and keeps each block's rows of w_hh in shared
memory for all T steps (see the note at the head of the source).
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
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


_SMEM_PER_BLOCK = 227 * 1024  # sm_90: a block's most, as dynamic shared memory
# 12 rows of w_hh and 4 rows of h, H floats each, and the barrier must fit
_MAX_H = (_SMEM_PER_BLOCK - 16) // (16 * 4) // 4 * 4
_CUDA_ERROR_INVALID_VALUE = 1


def gru_sequence(xi, masks, h0, w_hh, b_hh):
    """`gru_sequence_plain` for tensors on the CPU; on CUDA tensors one launch
    of the kernel for the whole sequence (an ordinary launch for T = 1, a
    cooperative one with a grid-wide barrier per step for T > 1). Every
    input must be f32 on one device; h0 may be a strided view whose rows are
    contiguous (`states[:, 0]` of a [B, L, H] state), the rest contiguous."""
    if xi.device.type == "cpu":
        return gru_sequence_plain(xi, masks, h0, w_hh, b_hh)
    T, B, threeH = xi.shape
    H = threeH // 3
    expected = {"xi": (T, B, 3 * H), "masks": (T, B, 1), "h0": (B, H), "w_hh": (3 * H, H), "b_hh": (3 * H,)}
    for name, t in zip(expected, (xi, masks, h0, w_hh, b_hh)):
        if t.device != xi.device or t.dtype != torch.float32:
            raise ValueError(f"gru_sequence: {name} must be a float32 tensor on {xi.device}")
        if tuple(t.shape) != expected[name]:
            raise ValueError(f"gru_sequence: {name} has shape {tuple(t.shape)}, expected {expected[name]}")
        if not (t.is_contiguous() or (name == "h0" and t.stride(1) == 1)):
            raise ValueError(f"gru_sequence: {name} must be contiguous" + (" along its rows" if name == "h0" else ""))
    if H % 4 or H > _MAX_H:
        raise ValueError(f"gru_sequence: the kernel takes H a multiple of 4 up to {_MAX_H}, got H={H}")
    out = torch.empty((T, B, H), dtype=torch.float32, device=xi.device)
    if T * B == 0:
        return out
    if w_hh.data_ptr() % 16:
        raise ValueError("gru_sequence: w_hh must be 16-byte aligned for the bulk copies")
    status = _build.call_on_stream(
        _kernel(), xi.device, xi.data_ptr(), masks.data_ptr(), h0.data_ptr(), h0.stride(0), w_hh.data_ptr(),
        b_hh.data_ptr(), out.data_ptr(), T, B, H,
    )
    if status == _CUDA_ERROR_INVALID_VALUE:
        raise ValueError(f"gru_sequence: T={T}, B={B}, H={H} does not fit the card: with T > 1 every block must be resident at once")
    _build.check("gru_sequence", status)
    gru_sequence.launches += 1
    return out


gru_sequence.launches = 0
