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


def channel_affine(in_dtype, channels: int, normalize: bool, scale_values: bool):
    """Per-channel (scale, bias) as f32 numpy arrays."""
    value_scale = 1.0 / 255.0 if in_dtype == torch.uint8 and scale_values else 1.0
    if normalize:
        mean = np.array([0.485, 0.456, 0.406][:channels], np.float32)
        std = np.array([0.229, 0.224, 0.225][:channels], np.float32)
        return (value_scale / std).astype(np.float32), (-mean / std).astype(np.float32)
    return np.full((channels,), value_scale, np.float32), np.zeros((channels,), np.float32)


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
    rh = torch.from_numpy(bilinear_matrix(H, out_hw[0])).to(dev)
    rw = torch.from_numpy(bilinear_matrix(W, out_hw[1])).to(dev)
    y = torch.einsum("oh,bhwc->bowc", rh, images.float())
    y = torch.einsum("pw,bowc->bopc", rw, y)
    scale, bias = channel_affine(images.dtype, C, normalize, scale_values)
    y = y * torch.from_numpy(scale).to(dev) + torch.from_numpy(bias).to(dev)
    return _to_out_dtype(y, out_dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("resize_normalize").resize_normalize
    fn.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
        + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def fused_resize_normalize(
    images: torch.Tensor,
    out_hw: Tuple[int, int],
    normalize: bool = False,
    out_dtype=torch.bfloat16,
    scale_values: bool = True,
) -> torch.Tensor:
    """`fused_resize_normalize_plain` for a tensor on the CPU; on a CUDA
    tensor one launch of the kernel. images: contiguous [B, H, W, C], u8 or
    f32, C <= 4; out_dtype: bf16, f32, or u8 for u8 images."""
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
    scale, bias = channel_affine(images.dtype, C, normalize, scale_values)
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _kernel()(
            images.data_ptr(), out.data_ptr(), _IN_TYPES[images.dtype], _OUT_TYPES[out_dtype],
            scale.ctypes.data, bias.ctypes.data, B, H, W, C, oh, ow, stream,
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
