"""Fused bilinear resize + normalize on NHWC images: the CUDA kernel
(csrc/resize_normalize.cu) and its plain PyTorch version.

Replaces vlnce_tpu/ops/pallas_preprocess.py:fused_resize_normalize. For each
channel: out = (R_h . img . R_w^T) * scale_c + bias_c, with the 2-tap
interpolation matrices of `bilinear_matrix` (half-pixel centers, clamped,
identity when the size is unchanged; torch bilinear with align_corners=False
and no antialias). `scale` folds 1/255 for u8 input (unless
scale_values=False) and optionally the ImageNet mean/std. Besides the JAX
output types (bf16, f32), out_dtype=torch.uint8 rounds half to even and clips
to [0, 255], which is the integer resize of `obs_transforms.resize_bilinear`;
it takes u8 input only.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from vlnce_torch.ops import _build

_IN_TYPES = {torch.uint8: 0, torch.float32: 1}
_OUT_TYPES = {torch.uint8: 0, torch.float32: 1, torch.bfloat16: 2}


def bilinear_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] interpolation weights (half-pixel centers), computed in
    double and stored in f32 as the JAX package's `_bilinear_matrix` does."""
    if in_size == out_size:
        return np.eye(out_size, dtype=np.float32)
    R = np.zeros((out_size, in_size), np.float32)
    scale = in_size / out_size
    for o in range(out_size):
        src = (o + 0.5) * scale - 0.5
        src = min(max(src, 0.0), in_size - 1)
        lo = int(np.floor(src))
        hi = min(lo + 1, in_size - 1)
        w = src - lo
        R[o, lo] += 1.0 - w
        R[o, hi] += w
    return R


def bilinear_taps(in_size: int, out_size: int):
    """The non-zero entries of `bilinear_matrix(in_size, out_size)`, row by
    row: int32 arrays `lo`, `hi` and f32 arrays `w_lo`, `w_hi` of length
    out_size with R[o, lo[o]] = w_lo[o] and, where hi[o] != lo[o],
    R[o, hi[o]] = w_hi[o]. Where the clamp makes hi == lo the two weights add
    into w_lo and w_hi is 0, so `w_lo * x[lo] + w_hi * x[hi]` is the row's
    product in every case; the identity has w_lo = 1, w_hi = 0."""
    o = np.arange(out_size, dtype=np.float64)
    if in_size == out_size:
        lo = hi = o.astype(np.int32)
        return lo, hi, np.ones(out_size, np.float32), np.zeros(out_size, np.float32)
    src = np.clip((o + 0.5) * (in_size / out_size) - 0.5, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int32)
    hi = np.minimum(lo + 1, in_size - 1).astype(np.int32)
    w = src - lo
    w_lo, w_hi = (1.0 - w).astype(np.float32), w.astype(np.float32)
    same = hi == lo
    w_lo[same] += w_hi[same]
    w_hi[same] = 0.0
    return lo, hi, w_lo, w_hi


@functools.lru_cache(maxsize=None)
def channel_affine(in_dtype, channels: int, normalize: bool, scale_values: bool):
    """Per-channel (scale, bias) as f32 numpy arrays, cached per argument
    tuple (treat them as read-only)."""
    value_scale = 1.0 / 255.0 if in_dtype == torch.uint8 and scale_values else 1.0
    if normalize:
        mean = np.array([0.485, 0.456, 0.406][:channels], np.float32)
        std = np.array([0.229, 0.224, 0.225][:channels], np.float32)
        return (value_scale / std).astype(np.float32), (-mean / std).astype(np.float32)
    return np.full((channels,), value_scale, np.float32), np.zeros((channels,), np.float32)


@functools.lru_cache(maxsize=None)
def _matrix_on(device, in_size: int, out_size: int) -> torch.Tensor:
    """`bilinear_matrix` as a tensor on `device`, uploaded once per size pair."""
    return torch.from_numpy(bilinear_matrix(in_size, out_size)).to(device)


@functools.lru_cache(maxsize=None)
def _affine_on(device, in_dtype, channels: int, normalize: bool, scale_values: bool):
    return tuple(torch.from_numpy(a).to(device) for a in channel_affine(in_dtype, channels, normalize, scale_values))


def _check_u8_out(in_dtype, out_dtype) -> None:
    if out_dtype == torch.uint8 and in_dtype != torch.uint8:
        raise ValueError(f"fused_resize_normalize: u8 output takes u8 input only, got {in_dtype}")


def _to_out_dtype(y: torch.Tensor, out_dtype) -> torch.Tensor:
    if out_dtype == torch.uint8:
        return torch.clamp(torch.round(y), 0, 255).to(torch.uint8)
    return y.to(out_dtype)


def fused_resize_normalize_plain(
    images: torch.Tensor,
    out_hw: Tuple[int, int],
    normalize: bool = False,
    out_dtype=torch.bfloat16,
    scale_values: bool = True,
) -> torch.Tensor:
    """images [B, H, W, C] u8 or f32 -> [B, out_h, out_w, C] out_dtype."""
    _check_u8_out(images.dtype, out_dtype)
    B, H, W, C = images.shape
    dev = images.device
    y = torch.einsum("oh,bhwc->bowc", _matrix_on(dev, H, int(out_hw[0])), images.float())
    y = torch.einsum("pw,bowc->bopc", _matrix_on(dev, W, int(out_hw[1])), y)
    scale, bias = _affine_on(dev, images.dtype, C, bool(normalize), bool(scale_values))
    return _to_out_dtype(y * scale + bias, out_dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("resize_normalize").resize_normalize
    fn.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6
        + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _taps_on(device, in_size: int, out_size: int):
    """`bilinear_taps` as two tensors on `device`, uploaded once per size
    pair: indices [2, out] int32 (lo, hi) and weights [2, out] f32."""
    lo, hi, w_lo, w_hi = bilinear_taps(in_size, out_size)
    return torch.from_numpy(np.stack([lo, hi])).to(device), torch.from_numpy(np.stack([w_lo, w_hi])).to(device)


@functools.lru_cache(maxsize=None)
def _affine_on_host(in_dtype, channels: int, normalize: bool, scale_values: bool):
    """The affine arrays and their host addresses: the C entry reads them
    into a launch argument, so nothing is uploaded. The cache keeps the
    arrays, and so the addresses, alive."""
    scale, bias = channel_affine(in_dtype, channels, normalize, scale_values)
    return scale, bias, scale.ctypes.data, bias.ctypes.data


_THREADS = 256  # kThreads of csrc/resize_normalize.cu
_ROWS_PER_TILE = 8  # one output row per warp
_SMEM_PER_SM = 227 * 1024  # what the blocks of an sm_90 SM can share, and a block's most
_SMEM_PER_BLOCK_RESERVED = 1024  # what the system keeps of it for each resident block


@functools.lru_cache(maxsize=None)
def kernel_tiling(H: int, W: int, C: int, oh: int, ow: int, in_itemsize: int, out_itemsize: int):
    """How the kernel cuts [H, W, C] -> [oh, ow, C] into tiles of R output
    rows: (R, stage_bytes, smem_bytes, blocks_per_sm). A tile's source rows
    run from its first row's lo tap to its last row's hi tap; stage_bytes
    holds the longest such span. R is the largest up to 8 with which two
    blocks share an SM, else the largest that fits one block at all."""
    lo, hi, _, _ = bilinear_taps(H, oh)

    def sizes(R):
        starts = np.arange(0, oh, R)
        span = int((hi[np.minimum(starts + R, oh) - 1] - lo[starts] + 1).max())
        stage = -(-span * W * C * in_itemsize // 16) * 16
        out_tile = -(-R * ow * C * out_itemsize // 16) * 16 + 16
        return stage, 16 + 16 * ow + 2 * stage + out_tile

    for limit in (_SMEM_PER_SM // 2 - _SMEM_PER_BLOCK_RESERVED, _SMEM_PER_SM):
        for R in range(min(_ROWS_PER_TILE, oh), 0, -1):
            stage, smem = sizes(R)
            if smem <= limit:
                per_sm = min(_SMEM_PER_SM // (smem + _SMEM_PER_BLOCK_RESERVED), 2048 // _THREADS)
                return R, stage, smem, max(per_sm, 1)
    raise ValueError(
        f"fused_resize_normalize: two source rows of {W} x {C} x {in_itemsize} bytes and an output row "
        f"of {ow} do not fit the kernel's shared memory twice over"
    )


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def fused_resize_normalize(
    images: torch.Tensor,
    out_hw: Tuple[int, int],
    normalize: bool = False,
    out_dtype=torch.bfloat16,
    scale_values: bool = True,
) -> torch.Tensor:
    """`fused_resize_normalize_plain` for a tensor on the CPU; on a CUDA
    tensor one launch of the kernel. images: contiguous [B, H, W, C], u8 or
    f32, C <= 4; out_dtype: bf16, f32, or u8 for u8 images. After the first
    call for a shape on a device nothing is copied from the host: the tap
    tables are cached there."""
    if images.device.type == "cpu":
        return fused_resize_normalize_plain(images, out_hw, normalize, out_dtype, scale_values)
    if images.dim() != 4 or not 1 <= images.shape[-1] <= 4:
        raise ValueError(f"fused_resize_normalize: images must be [B, H, W, C<=4], got {tuple(images.shape)}")
    if images.dtype not in _IN_TYPES or out_dtype not in _OUT_TYPES:
        raise ValueError(f"fused_resize_normalize: takes u8/f32 in and u8/f32/bf16 out, got {images.dtype} -> {out_dtype}")
    _check_u8_out(images.dtype, out_dtype)
    if not images.is_contiguous():
        raise ValueError("fused_resize_normalize: images must be contiguous (NHWC)")
    B, H, W, C = images.shape
    oh, ow = int(out_hw[0]), int(out_hw[1])
    out = torch.empty((B, oh, ow, C), dtype=out_dtype, device=images.device)
    if out.numel() == 0:
        return out
    if H < 1 or W < 1:
        raise ValueError(f"fused_resize_normalize: cannot resize empty {H}x{W} frames to {oh}x{ow}")
    R, stage_bytes, smem_bytes, per_sm = kernel_tiling(H, W, C, oh, ow, images.element_size(), out.element_size())
    tiles = B * -(-oh // R)
    bulk = images.data_ptr() % 16 == 0 and (W * C * images.element_size()) % 16 == 0
    y_idx, y_w = _taps_on(images.device, H, oh)
    x_idx, x_w = _taps_on(images.device, W, ow)
    _, _, scale_ptr, bias_ptr = _affine_on_host(images.dtype, C, bool(normalize), bool(scale_values))
    status = _build.call_on_stream(
        _kernel(), images.device, images.data_ptr(), out.data_ptr(), _IN_TYPES[images.dtype], _OUT_TYPES[out_dtype],
        scale_ptr, bias_ptr, y_idx.data_ptr(), y_w.data_ptr(), x_idx.data_ptr(), x_w.data_ptr(), B, H, W, C, oh, ow,
        R, stage_bytes, smem_bytes, int(bulk), min(tiles, per_sm * _sm_count(images.device)),
    )
    _build.check("resize_normalize", status)
    fused_resize_normalize.launches += 1
    return out


fused_resize_normalize.launches = 0


def preprocess_rgbd(
    rgb: Optional[torch.Tensor],
    depth: Optional[torch.Tensor],
    rgb_hw: Tuple[int, int],
    depth_hw: Tuple[int, int],
    normalize_rgb: bool = False,
    out_dtype=torch.bfloat16,
):
    """The standard VLN-CE obs preprocessing pair."""
    out = {}
    if rgb is not None:
        out["rgb"] = fused_resize_normalize(rgb, rgb_hw, normalize_rgb, out_dtype)
    if depth is not None:
        out["depth"] = fused_resize_normalize(depth, depth_hw, False, out_dtype)
    return out
