"""Masked GRU over a sequence: the CUDA kernel (csrc/gru_sequence.cu) and its
plain PyTorch version.

Replaces vlnce_tpu/ops/pallas_rnn.py:gru_sequence. Semantics are those of
the masked GRU in RNNStateEncoder: torch gate order (r, z, n), and the hidden
state is reset by `h *= mask` before each step. `RNNStateEncoder` runs its
GRU through `gru_sequence` in both modes (a single act step is T=1). The
kernel partitions the hidden units over the SMs and keeps each block's rows
of w_hh in shared memory for all T steps (see the note at the head of the
source).

The JAX kernel has no gradient: the JAX trainer differentiates a `lax.scan`.
The port trains through the kernel, so on CUDA tensors `gru_sequence` is a
`torch.autograd.Function` whose backward is a second hand-written kernel of
the same source (`gru_sequence_backward`), with its plain PyTorch version
`gru_sequence_backward_plain` beside it. On CPU tensors `gru_sequence` is
the plain loop under ordinary autograd.
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


def gru_sequence_backward_plain(d_out, xi, masks, h0, w_hh, b_hh, out):
    """The gradient of `gru_sequence_plain` by its explicit formula, walking
    t = T-1 .. 0 with a carried dh (no call to autograd). d_out [T, B, H] is
    the gradient of `out`, the forward's output. Returns (d_xi [T, B, 3H],
    d_h0 [B, H], d_w_hh [3H, H], d_b_hh [3H]); masks get no gradient."""
    d_out, xi, masks, h0, w_hh, b_hh, out = (t.float() for t in (d_out, xi, masks, h0, w_hh, b_hh, out))
    T, _, H = out.shape
    dh = torch.zeros_like(h0)
    d_xi = torch.empty_like(xi)
    d_w_hh, d_b_hh = torch.zeros_like(w_hh), torch.zeros_like(b_hh)
    for t in range(T - 1, -1, -1):
        dh = dh + d_out[t]
        h_prev = (h0 if t == 0 else out[t - 1]) * masks[t]
        hh = h_prev @ w_hh.T + b_hh
        r = torch.sigmoid(xi[t, :, :H] + hh[:, :H])
        z = torch.sigmoid(xi[t, :, H : 2 * H] + hh[:, H : 2 * H])
        n = torch.tanh(xi[t, :, 2 * H :] + r * hh[:, 2 * H :])
        da_n = dh * (1.0 - z) * (1.0 - n * n)
        da_r = da_n * hh[:, 2 * H :] * r * (1.0 - r)
        da_z = dh * (h_prev - n) * z * (1.0 - z)
        d_xi[t] = torch.cat([da_r, da_z, da_n], dim=1)
        d_gh = torch.cat([da_r, da_z, da_n * r], dim=1)
        d_w_hh += d_gh.T @ h_prev
        d_b_hh += d_gh.sum(0)
        dh = (dh * z + d_gh @ w_hh) * masks[t]
    return d_xi, dh, d_w_hh, d_b_hh


_POINTER, _INT = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("gru_sequence").gru_sequence_f32
    fn.argtypes = [_POINTER] * 3 + [ctypes.c_longlong] + [_POINTER] * 3 + [_INT] * 3 + [_POINTER]
    fn.restype = _INT
    return fn


@functools.lru_cache(maxsize=None)
def _backward_kernel():
    fn = _build.load("gru_sequence").gru_sequence_backward_f32
    fn.argtypes = [_POINTER] * 4 + [ctypes.c_longlong] + [_POINTER] * 7 + [_INT] * 3 + [_POINTER]
    fn.restype = _INT
    return fn


_SMEM_PER_BLOCK = 227 * 1024  # sm_90: a block's most, as dynamic shared memory
# 12 rows of w_hh and 4 rows of h, H floats each, and the barrier must fit
_MAX_H = (_SMEM_PER_BLOCK - 16) // (16 * 4) // 4 * 4
_CUDA_ERROR_INVALID_VALUE = 1


_BLOCK_UNITS = 4  # the fewest hidden units a block owns (kBlockUnits of the source)


def _check(fn_name, xi, tensors):
    """Raise on what the kernels do not take. `tensors` maps a name to
    (tensor, expected shape); h0 may have rows that are contiguous but
    apart."""
    for name, (t, shape) in tensors.items():
        if t.device != xi.device or t.dtype != torch.float32:
            raise ValueError(f"{fn_name}: {name} must be a float32 tensor on {xi.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{fn_name}: {name} has shape {tuple(t.shape)}, expected {shape}")
        if not (t.is_contiguous() or (name == "h0" and t.stride(1) == 1)):
            raise ValueError(f"{fn_name}: {name} must be contiguous" + (" along its rows" if name == "h0" else ""))
    H = tensors["h0"][1][1]
    if H % 4 or H > _MAX_H:
        raise ValueError(f"{fn_name}: the kernel takes H a multiple of 4 up to {_MAX_H}, got H={H}")


def _raise_on(fn_name, status, T, B, H):
    if status == _CUDA_ERROR_INVALID_VALUE:
        raise ValueError(f"{fn_name}: T={T}, B={B}, H={H} does not fit the card: with T > 1 every block must be resident at once")
    _build.check(fn_name, status)


def _forward_launch(xi, masks, h0, w_hh, b_hh):
    T, B, threeH = xi.shape
    H = threeH // 3
    _check("gru_sequence", xi, {"xi": (xi, (T, B, 3 * H)), "masks": (masks, (T, B, 1)), "h0": (h0, (B, H)),
                                "w_hh": (w_hh, (3 * H, H)), "b_hh": (b_hh, (3 * H,))})
    out = torch.empty((T, B, H), dtype=torch.float32, device=xi.device)
    if T * B == 0:
        return out
    if w_hh.data_ptr() % 16:
        raise ValueError("gru_sequence: w_hh must be 16-byte aligned for the bulk copies")
    status = _build.call_on_stream(
        _kernel(), xi.device, xi.data_ptr(), masks.data_ptr(), h0.data_ptr(), h0.stride(0), w_hh.data_ptr(),
        b_hh.data_ptr(), out.data_ptr(), T, B, H,
    )
    _raise_on("gru_sequence", status, T, B, H)
    gru_sequence.launches += 1
    return out


def _backward_launch(d_out, xi, masks, h0, w_hh, b_hh, out, d_xi, d_h0, d_gh, scratch):
    """The backward kernel's launches alone, into buffers the caller owns:
    d_xi and d_gh like xi, d_h0 [B, H], scratch [2, H / 4, B, H] (every
    block's part of dh_prev, two planes; the most blocks the launcher takes
    is H / 4). Checks nothing but the launch's status."""
    T, B, threeH = xi.shape
    H = threeH // 3
    status = _build.call_on_stream(
        _backward_kernel(), xi.device, d_out.data_ptr(), xi.data_ptr(), masks.data_ptr(), h0.data_ptr(), h0.stride(0),
        w_hh.data_ptr(), b_hh.data_ptr(), out.data_ptr(), d_xi.data_ptr(), d_h0.data_ptr(), d_gh.data_ptr(),
        scratch.data_ptr(), T, B, H,
    )
    _raise_on("gru_sequence_backward", status, T, B, H)
    gru_sequence_backward.launches += 1


def gru_sequence_backward(d_out, xi, masks, h0, w_hh, b_hh, out):
    """`gru_sequence_backward_plain` for tensors on the CPU; on CUDA tensors
    the backward kernel: one launch walks t = T-1 .. 0 (ordinary for T = 1,
    cooperative with a grid-wide barrier per step for T > 1), recomputes the
    gates from `out`, and writes d_xi and d_gh, the gradient of `h_prev @
    w_hh.T + b_hh` at every step; a small second launch sums d_h0. Both
    recurrent products (`h_prev @ w_hh.T` and `d_gh[t] @ w_hh`) are computed
    in the kernel. The weight gradient lies outside the recurrence: here
    `d_w_hh = d_gh^T @ h_prev` is one `torch.matmul` over all T * B rows and
    `d_b_hh` one sum, as the JAX package leaves such products to XLA. d_out
    is made contiguous if it is not; the rest as `gru_sequence` takes them."""
    if xi.device.type == "cpu":
        return gru_sequence_backward_plain(d_out, xi, masks, h0, w_hh, b_hh, out)
    T, B, threeH = xi.shape
    H = threeH // 3
    d_out = d_out.contiguous()
    _check("gru_sequence_backward", xi, {
        "d_out": (d_out, (T, B, H)), "xi": (xi, (T, B, 3 * H)), "masks": (masks, (T, B, 1)), "h0": (h0, (B, H)),
        "w_hh": (w_hh, (3 * H, H)), "b_hh": (b_hh, (3 * H,)), "out": (out, (T, B, H)),
    })
    d_xi, d_gh = torch.empty_like(xi), torch.empty_like(xi)
    d_h0 = torch.empty((B, H), dtype=torch.float32, device=xi.device)
    if T * B == 0:
        return d_xi, d_h0.zero_(), torch.zeros_like(w_hh), torch.zeros_like(b_hh)
    if w_hh.data_ptr() % 16:
        raise ValueError("gru_sequence_backward: w_hh must be 16-byte aligned for the bulk copies")
    scratch = torch.empty((2, H // _BLOCK_UNITS, B, H), dtype=torch.float32, device=xi.device)
    _backward_launch(d_out, xi, masks, h0, w_hh, b_hh, out, d_xi, d_h0, d_gh, scratch)
    h_prev = torch.cat([h0[None], out[:-1]]) * masks
    d_w_hh = d_gh.reshape(T * B, 3 * H).T @ h_prev.reshape(T * B, H)
    return d_xi, d_h0, d_w_hh, d_gh.sum(dim=(0, 1))


gru_sequence_backward.launches = 0


class _GRUSequence(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, xi, masks, h0, w_hh, b_hh):
        out = _forward_launch(xi, masks, h0, w_hh, b_hh)
        ctx.save_for_backward(xi, masks, h0, w_hh, b_hh, out)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_out):
        d_xi, d_h0, d_w_hh, d_b_hh = gru_sequence_backward(d_out, *ctx.saved_tensors)
        return d_xi, None, d_h0, d_w_hh, d_b_hh


def gru_sequence(xi, masks, h0, w_hh, b_hh):
    """`gru_sequence_plain` for tensors on the CPU; on CUDA tensors one launch
    of the kernel for the whole sequence (an ordinary launch for T = 1, a
    cooperative one with a grid-wide barrier per step for T > 1), and, where
    an input requires grad, `gru_sequence_backward` as its gradient. Every
    input must be f32 on one device; h0 may be a strided view whose rows are
    contiguous (`states[:, 0]` of a [B, L, H] state), the rest contiguous."""
    if xi.device.type == "cpu":
        return gru_sequence_plain(xi, masks, h0, w_hh, b_hh)
    return _GRUSequence.apply(xi, masks, h0, w_hh, b_hh)


gru_sequence.launches = 0
