"""Masked GRU over a sequence: the CUDA kernels (csrc/gru_sequence.cu) and
their plain PyTorch versions.

Replaces vlnce_tpu/ops/pallas_rnn.py:gru_sequence. Semantics are those of
the masked GRU in RNNStateEncoder: torch gate order (r, z, n), and the hidden
state is reset by `h *= mask` before each step. `RNNStateEncoder` runs its
GRU through `gru_sequence` in both modes (a single act step is T=1). The
forward kernel partitions the hidden units over the SMs and keeps each
block's rows of w_hh in shared memory for all T steps (see the note at the
head of the source).

The JAX kernel has no gradient: the JAX trainer differentiates a `lax.scan`.
The port trains through the kernel, so on CUDA tensors `gru_sequence` is a
`torch.autograd.Function` where an input requires grad: its forward also
stores the gates r, z, n and hh_n of every step (the reserve) where the
backward's cluster route takes the shape, and its backward is
`gru_sequence_backward`, whose recurrence runs in one thread-block cluster
with w_hh spread over the blocks' shared memory and reads the gates instead
of recomputing them (other shapes: a grid-wide route that recomputes them),
followed by one launch of `gru_weight_gradient` for d_w_hh and d_b_hh. The
plain PyTorch versions sit beside each kernel. On CPU tensors `gru_sequence`
is the plain loop under ordinary autograd.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from vlnce_torch.ops import _build


def gru_sequence_plain(xi, masks, h0, w_hh, b_hh, return_gates=False):
    """xi [T, B, 3H] input projections (+ b_ih); masks [T, B, 1]; h0 [B, H];
    w_hh [3H, H] (torch layout); b_hh [3H]. Returns outs [T, B, H] in f32;
    the final state is outs[-1]. With `return_gates`, (outs, gates): gates
    [T, B, 4H] holds r, z, n and hh_n = h_prev . w_hh_n^T + b_hh_n of every
    step, what the kernel's training forward stores for the backward."""
    xi, masks, h, w_hh, b_hh = (t.float() for t in (xi, masks, h0, w_hh, b_hh))
    H = h.shape[1]
    outs, gates = [], []
    for t in range(xi.shape[0]):
        h = h * masks[t]
        hh = h @ w_hh.T + b_hh
        r = torch.sigmoid(xi[t, :, :H] + hh[:, :H])
        z = torch.sigmoid(xi[t, :, H : 2 * H] + hh[:, H : 2 * H])
        n = torch.tanh(xi[t, :, 2 * H :] + r * hh[:, 2 * H :])
        h = (1.0 - z) * n + z * h
        outs.append(h)
        if return_gates:
            gates.append(torch.cat([r, z, n, hh[:, 2 * H :]], dim=1))
    if return_gates:
        return torch.stack(outs), torch.stack(gates)
    return torch.stack(outs)


def gru_sequence_backward_plain(d_out, xi, masks, h0, w_hh, b_hh, out, gates=None):
    """The gradient of `gru_sequence_plain` by its explicit formula, walking
    t = T-1 .. 0 with a carried dh (no call to autograd). d_out [T, B, H] is
    the gradient of `out`, the forward's output. With `gates` [T, B, 4H] (r,
    z, n, hh_n of every step, as `gru_sequence_plain(..., return_gates=True)`
    gives them) the gates are read, not recomputed from `out`. Returns (d_xi
    [T, B, 3H], d_h0 [B, H], d_w_hh [3H, H], d_b_hh [3H]); masks get no
    gradient."""
    d_out, xi, masks, h0, w_hh, b_hh, out = (t.float() for t in (d_out, xi, masks, h0, w_hh, b_hh, out))
    T, _, H = out.shape
    dh = torch.zeros_like(h0)
    d_xi = torch.empty_like(xi)
    d_w_hh, d_b_hh = torch.zeros_like(w_hh), torch.zeros_like(b_hh)
    for t in range(T - 1, -1, -1):
        dh = dh + d_out[t]
        h_prev = (h0 if t == 0 else out[t - 1]) * masks[t]
        if gates is None:
            hh = h_prev @ w_hh.T + b_hh
            r = torch.sigmoid(xi[t, :, :H] + hh[:, :H])
            z = torch.sigmoid(xi[t, :, H : 2 * H] + hh[:, H : 2 * H])
            hh_n = hh[:, 2 * H :]
            n = torch.tanh(xi[t, :, 2 * H :] + r * hh_n)
        else:
            r, z, n, hh_n = gates[t].float().split(H, dim=1)
        da_n = dh * (1.0 - z) * (1.0 - n * n)
        da_r = da_n * hh_n * r * (1.0 - r)
        da_z = dh * (h_prev - n) * z * (1.0 - z)
        d_xi[t] = torch.cat([da_r, da_z, da_n], dim=1)
        d_gh = torch.cat([da_r, da_z, da_n * r], dim=1)
        d_w_hh += d_gh.T @ h_prev
        d_b_hh += d_gh.sum(0)
        dh = (dh * z + d_gh @ w_hh) * masks[t]
    return d_xi, dh, d_w_hh, d_b_hh


def gru_weight_gradient_plain(d_gh, masks, h0, out):
    """d_w_hh [3H, H] = the sum over t, b of d_gh[t, b]^T . h_prev[t, b] with
    h_prev = (h0 at t = 0, out[t - 1] after) * masks[t], and d_b_hh [3H] =
    the sum of d_gh [T, B, 3H]: the weight gradient over all steps at once."""
    d_gh, masks, h0, out = (t.float() for t in (d_gh, masks, h0, out))
    H = out.shape[2]
    h_prev = torch.cat([h0[None], out[:-1]]) * masks
    return d_gh.reshape(-1, 3 * H).T @ h_prev.reshape(-1, H), d_gh.sum(dim=(0, 1))


_POINTER, _INT = ctypes.c_void_p, ctypes.c_int
_LONG = ctypes.c_longlong
_ARGTYPES = {  # the C entries of csrc/gru_sequence.cu; every one ends with the stream
    "gru_sequence_f32": [_POINTER] * 3 + [_LONG] + [_POINTER] * 4 + [_INT] * 3 + [_POINTER],
    "gru_sequence_backward_f32": [_POINTER] * 4 + [_LONG] + [_POINTER] * 7 + [_INT] * 3 + [_POINTER],
    "gru_sequence_backward_cluster_f32": [_POINTER] * 4 + [_LONG] + [_POINTER] * 5 + [_INT] * 4 + [_POINTER],
    "gru_weight_gradient_f32": [_POINTER] * 3 + [_LONG] + [_POINTER] * 3 + [_INT] * 3 + [_POINTER],
    "gru_sequence_backward_cluster_plan": [_INT, _INT, ctypes.POINTER(_INT), ctypes.POINTER(_INT)],
}


@functools.lru_cache(maxsize=None)
def _entry(name):
    fn = getattr(_build.load("gru_sequence"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = _INT
    return fn


_SMEM_PER_BLOCK = 227 * 1024  # sm_90: a block's most, as dynamic shared memory
# 12 rows of w_hh and 4 rows of h, H floats each, and the barrier must fit
_MAX_H = (_SMEM_PER_BLOCK - 16) // (16 * 4) // 4 * 4
_CUDA_ERROR_INVALID_VALUE = 1


_BLOCK_UNITS = 4  # the fewest hidden units a block of the grid route owns (kBlockUnits of the source)


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


def _aligned(fn_name, **tensors):
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{fn_name}: {name} must be 16-byte aligned")


def _forward_launch(xi, masks, h0, w_hh, b_hh, reserve=False):
    """The forward kernel's launch: out, and with `reserve` (out, gates [T,
    B, 4H]), the gates stored by the same launch."""
    T, B, threeH = xi.shape
    H = threeH // 3
    _check("gru_sequence", xi, {"xi": (xi, (T, B, 3 * H)), "masks": (masks, (T, B, 1)), "h0": (h0, (B, H)),
                                "w_hh": (w_hh, (3 * H, H)), "b_hh": (b_hh, (3 * H,))})
    out = torch.empty((T, B, H), dtype=torch.float32, device=xi.device)
    gates = torch.empty((T, B, 4 * H), dtype=torch.float32, device=xi.device) if reserve else None
    if T * B > 0:
        _aligned("gru_sequence", w_hh=w_hh)
        status = _build.call_on_stream(
            _entry("gru_sequence_f32"), xi.device, xi.data_ptr(), masks.data_ptr(), h0.data_ptr(), h0.stride(0),
            w_hh.data_ptr(), b_hh.data_ptr(), out.data_ptr(), gates.data_ptr() if reserve else None, T, B, H,
        )
        _raise_on("gru_sequence", status, T, B, H)
        gru_sequence.launches += 1
    return (out, gates) if reserve else out


@functools.lru_cache(maxsize=None)
def backward_cluster_plan(device_index, B, H):
    """(cluster size, most clusters the card runs at once) of the backward's
    cluster route at B rows of H units on card `device_index`: the smallest
    cluster whose blocks hold their slice of w_hh in shared memory. The size
    is 0 where the route does not take B and H (B above 8; H / 4 no power of
    two from 8 to 256; no cluster fits); `gru_sequence_backward` then takes
    the grid route."""
    cluster, active = _INT(0), _INT(0)
    with torch.cuda.device(device_index):
        status = _entry("gru_sequence_backward_cluster_plan")(B, H, ctypes.byref(cluster), ctypes.byref(active))
    _build.check("gru_sequence_backward_cluster_plan", status)
    return cluster.value, active.value


def _backward_launch(d_out, xi, masks, h0, w_hh, b_hh, out, d_xi, d_h0, d_gh, scratch):
    """The grid route's launches alone, into buffers the caller owns: d_xi
    and d_gh like xi, d_h0 [B, H], scratch [2, H / 4, B, H] (every block's
    part of dh_prev, two planes; the most blocks the launcher takes is H /
    4). Checks nothing but the launch's status."""
    T, B, threeH = xi.shape
    H = threeH // 3
    status = _build.call_on_stream(
        _entry("gru_sequence_backward_f32"), xi.device, d_out.data_ptr(), xi.data_ptr(), masks.data_ptr(),
        h0.data_ptr(), h0.stride(0), w_hh.data_ptr(), b_hh.data_ptr(), out.data_ptr(), d_xi.data_ptr(),
        d_h0.data_ptr(), d_gh.data_ptr(), scratch.data_ptr(), T, B, H,
    )
    _raise_on("gru_sequence_backward", status, T, B, H)
    gru_sequence_backward.launches += 1


def _cluster_launch(d_out, gates, masks, h0, w_hh, out, d_xi, d_h0, d_gh, cluster):
    """The cluster route's launch alone (one cluster of `cluster` blocks, as
    `backward_cluster_plan` gave it), into buffers the caller owns: d_xi and
    d_gh [T, B, 3H], d_h0 [B, H]. Checks nothing but the launch's status."""
    T, B, H = out.shape
    status = _build.call_on_stream(
        _entry("gru_sequence_backward_cluster_f32"), out.device, d_out.data_ptr(), gates.data_ptr(),
        masks.data_ptr(), h0.data_ptr(), h0.stride(0), w_hh.data_ptr(), out.data_ptr(), d_xi.data_ptr(),
        d_h0.data_ptr(), d_gh.data_ptr(), T, B, H, cluster,
    )
    _raise_on("gru_sequence_backward", status, T, B, H)
    gru_sequence_backward.launches += 1
    gru_sequence_backward.cluster_launches += 1


def gru_sequence_backward(d_out, xi, masks, h0, w_hh, b_hh, out, gates=None):
    """`gru_sequence_backward_plain` for tensors on the CPU; on CUDA tensors
    the backward kernel, by one of two routes chosen by shape, then
    `gru_weight_gradient` for d_w_hh and d_b_hh:

    - the cluster route, where `gates` (the training forward's reserve [T,
      B, 4H]) is given and `backward_cluster_plan` has a cluster for B and H
      (B=5, H=512 takes 16 blocks): one launch walks t = T-1 .. 0 with w_hh
      spread over the cluster's shared memory, reads the gates, forms
      `d_gh[t] @ w_hh` as each block's part for every column and sums the
      parts of its own columns through distributed shared memory after one
      cluster barrier per step; it writes d_xi, d_gh and d_h0;
    - the grid route otherwise: one launch (ordinary for T = 1, cooperative
      with a grid-wide barrier per step for T > 1) recomputes the gates from
      `out` and writes d_xi and d_gh, and a small second launch sums d_h0.

    d_out is made contiguous if it is not; the rest as `gru_sequence` takes
    them."""
    if xi.device.type == "cpu":
        return gru_sequence_backward_plain(d_out, xi, masks, h0, w_hh, b_hh, out, gates)
    T, B, threeH = xi.shape
    H = threeH // 3
    d_out = d_out.contiguous()
    tensors = {
        "d_out": (d_out, (T, B, H)), "xi": (xi, (T, B, 3 * H)), "masks": (masks, (T, B, 1)), "h0": (h0, (B, H)),
        "w_hh": (w_hh, (3 * H, H)), "b_hh": (b_hh, (3 * H,)), "out": (out, (T, B, H)),
    }
    if gates is not None:
        tensors["gates"] = (gates, (T, B, 4 * H))
    _check("gru_sequence_backward", xi, tensors)
    d_xi, d_gh = torch.empty_like(xi), torch.empty_like(xi)
    d_h0 = torch.empty((B, H), dtype=torch.float32, device=xi.device)
    if T * B == 0:
        return d_xi, d_h0.zero_(), torch.zeros_like(w_hh), torch.zeros_like(b_hh)
    _aligned("gru_sequence_backward", w_hh=w_hh)
    cluster = backward_cluster_plan(xi.device.index, B, H)[0] if gates is not None else 0
    if cluster:
        _cluster_launch(d_out, gates, masks, h0, w_hh, out, d_xi, d_h0, d_gh, cluster)
    else:
        scratch = torch.empty((2, H // _BLOCK_UNITS, B, H), dtype=torch.float32, device=xi.device)
        _backward_launch(d_out, xi, masks, h0, w_hh, b_hh, out, d_xi, d_h0, d_gh, scratch)
    return (d_xi, d_h0, *gru_weight_gradient(d_gh, masks, h0, out))


gru_sequence_backward.launches = 0
gru_sequence_backward.cluster_launches = 0  # those of the launches above that took the cluster route


def _weight_gradient_launch(d_gh, masks, h0, out, d_w_hh, d_b_hh):
    """The weight-gradient kernel's launch alone, into d_w_hh [3H, H] and
    d_b_hh [3H] that the caller owns. Checks nothing but the launch's
    status."""
    T, B, H = out.shape
    status = _build.call_on_stream(
        _entry("gru_weight_gradient_f32"), out.device, d_gh.data_ptr(), masks.data_ptr(), h0.data_ptr(),
        h0.stride(0), out.data_ptr(), d_w_hh.data_ptr(), d_b_hh.data_ptr(), T, B, H,
    )
    _raise_on("gru_weight_gradient", status, T, B, H)
    gru_weight_gradient.launches += 1


def gru_weight_gradient(d_gh, masks, h0, out):
    """`gru_weight_gradient_plain` for tensors on the CPU; on CUDA tensors
    one launch of a hand-written kernel: 64 x 64 tiles of d_w_hh spread over
    the SMs, each summing the outer products of d_gh's and h_prev's rows over
    all T * B rows in f32 (h_prev formed on the way from h0, which may be
    strided, out and masks), the blocks of the first column tile also summing
    d_b_hh. d_gh [T, B, 3H] and out [T, B, H] contiguous and 16-byte
    aligned."""
    if d_gh.device.type == "cpu":
        return gru_weight_gradient_plain(d_gh, masks, h0, out)
    T, B, H = out.shape
    _check("gru_weight_gradient", d_gh, {"d_gh": (d_gh, (T, B, 3 * H)), "masks": (masks, (T, B, 1)),
                                         "h0": (h0, (B, H)), "out": (out, (T, B, H))})
    d_w_hh = torch.empty((3 * H, H), dtype=torch.float32, device=d_gh.device)
    d_b_hh = torch.empty((3 * H,), dtype=torch.float32, device=d_gh.device)
    if T * B == 0:
        return d_w_hh.zero_(), d_b_hh.zero_()
    _aligned("gru_weight_gradient", d_gh=d_gh, out=out)
    _weight_gradient_launch(d_gh, masks, h0, out, d_w_hh, d_b_hh)
    return d_w_hh, d_b_hh


gru_weight_gradient.launches = 0


class _GRUSequence(torch.autograd.Function):
    """The forward kernel, storing the gates where the backward's cluster
    route takes the shape, with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, xi, masks, h0, w_hh, b_hh):
        _, B, threeH = xi.shape
        if backward_cluster_plan(xi.device.index, B, threeH // 3)[0]:
            out, gates = _forward_launch(xi, masks, h0, w_hh, b_hh, reserve=True)
        else:  # the grid route recomputes the gates: nothing would read them
            out, gates = _forward_launch(xi, masks, h0, w_hh, b_hh), None
        ctx.save_for_backward(xi, masks, h0, w_hh, b_hh, out, gates)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_out):
        *saved, gates = ctx.saved_tensors
        d_xi, d_h0, d_w_hh, d_b_hh = gru_sequence_backward(d_out, *saved, gates=gates)
        return d_xi, None, d_h0, d_w_hh, d_b_hh


def gru_sequence(xi, masks, h0, w_hh, b_hh):
    """`gru_sequence_plain` for tensors on the CPU; on CUDA tensors one launch
    of the kernel for the whole sequence (an ordinary launch for T = 1, a
    cooperative one with a grid-wide barrier per step for T > 1). Where grad
    is enabled and an input requires it, `gru_sequence_backward` is its
    gradient, and that launch also stores the gates for it where its cluster
    route takes B and H. Every input must be f32 on
    one device; h0 may be a strided view whose rows are contiguous
    (`states[:, 0]` of a [B, L, H] state), the rest contiguous."""
    if xi.device.type == "cpu":
        return gru_sequence_plain(xi, masks, h0, w_hh, b_hh)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xi, h0, w_hh, b_hh)):
        return _GRUSequence.apply(xi, masks, h0, w_hh, b_hh)
    return _forward_launch(xi, masks, h0, w_hh, b_hh)


gru_sequence.launches = 0
