"""Fused resize + normalize (kernel B2) of the PyTorch port against the JAX
package.

On CPU tensors the port's `fused_resize_normalize` runs its plain PyTorch
version; the JAX side runs the Pallas kernel in interpret mode, as
tests/test_pallas_preprocess.py does. Tolerances: atol 1e-5 on [0, 1]-scaled
values and 1e-3 with scale_values=False (values up to 255; f32 summation
order), bf16 within one bf16 ulp of the value.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vlnce_tpu.ops import obs_transforms as jax_ot
from vlnce_tpu.ops.pallas_preprocess import _bilinear_matrix, fused_resize_normalize as jax_frn
from vlnce_torch.ops import obs_transforms as ot
from vlnce_torch.ops.preprocess import (
    bilinear_matrix,
    bilinear_taps,
    channel_affine,
    fused_resize_normalize,
    fused_resize_normalize_plain,
    kernel_tiling,
)

# (name, input shape, input dtype, out_hw, normalize, out dtype, scale_values)
CASES = [
    ("downscale", (2, 64, 64, 3), np.uint8, (48, 48), False, "float32", True),
    ("identity", (1, 32, 32, 3), np.uint8, (32, 32), False, "float32", True),
    ("normalize", (1, 32, 32, 3), np.uint8, (32, 32), True, "float32", True),
    ("float_depth", (2, 64, 64, 1), np.float32, (32, 32), False, "float32", True),
    ("bf16_out", (2, 40, 40, 3), np.uint8, (24, 24), True, "bfloat16", True),
    ("rxr_ratio_rgb", (2, 48, 64, 3), np.uint8, (32, 42), False, "float32", False),
    ("rxr_ratio_depth", (2, 48, 64, 1), np.float32, (32, 42), False, "float32", False),
]


def _image(shape, dtype, seed):
    rng = np.random.RandomState(seed)
    if dtype == np.uint8:
        return rng.randint(0, 256, shape).astype(np.uint8)
    return rng.rand(*shape).astype(np.float32)


def test_bilinear_matrix_matches_jax():
    for n_in, n_out in ((480, 256), (640, 341), (64, 48), (32, 32), (8, 20)):
        np.testing.assert_array_equal(bilinear_matrix(n_in, n_out), _bilinear_matrix(n_in, n_out))


# the act step's two axes, identity, an upscale, and sizes whose first and
# last outputs clamp at the edges (down to a single source or output pixel)
TAP_SIZES = [(480, 256), (640, 341), (32, 32), (32, 48), (8, 20), (3, 7), (7, 3), (1, 5), (5, 1), (2, 2)]


@pytest.mark.parametrize("n_in,n_out", TAP_SIZES, ids=[f"{a}to{b}" for a, b in TAP_SIZES])
def test_bilinear_taps_are_the_jax_matrix(n_in, n_out):
    """The table the kernel reads holds exactly the non-zero entries of the
    JAX package's interpolation matrix, entry for entry."""
    lo, hi, w_lo, w_hi = bilinear_taps(n_in, n_out)
    assert lo.dtype == hi.dtype == np.int32 and w_lo.dtype == w_hi.dtype == np.float32
    assert lo.min() >= 0 and hi.max() <= n_in - 1 and np.all(np.diff(lo) >= 0) and np.all(np.diff(hi) >= 0)
    dense = np.zeros((n_out, n_in), np.float32)
    rows = np.arange(n_out)
    dense[rows, lo] = w_lo
    two = hi != lo
    dense[rows[two], hi[two]] = w_hi[two]
    assert np.all(w_hi[~two] == 0.0)
    np.testing.assert_array_equal(dense, _bilinear_matrix(n_in, n_out))
    if n_in == n_out:
        np.testing.assert_array_equal(lo, rows)
        assert np.all(w_lo == 1.0) and np.all(w_hi == 0.0)


def _two_tap(x, out_hw, normalize, scale_values):
    """The kernel's arithmetic in numpy: y then x through the tap tables,
    then the affine, in f32."""
    x32 = x.astype(np.float32)
    lo, hi, w_lo, w_hi = bilinear_taps(x.shape[1], out_hw[0])
    y = w_lo[None, :, None, None] * x32[:, lo] + w_hi[None, :, None, None] * x32[:, hi]
    lo, hi, w_lo, w_hi = bilinear_taps(x.shape[2], out_hw[1])
    y = w_lo[None, None, :, None] * y[:, :, lo] + w_hi[None, None, :, None] * y[:, :, hi]
    scale, bias = channel_affine(torch.from_numpy(x).dtype, x.shape[3], normalize, scale_values)
    return y * scale + bias


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_two_tap_tables_match_plain(case):
    name, shape, dtype, hw, normalize, _, scale_values = case
    x = _image(shape, dtype, len(name))
    ref = fused_resize_normalize_plain(torch.from_numpy(x), hw, normalize=normalize, out_dtype=torch.float32,
                                       scale_values=scale_values)
    np.testing.assert_allclose(_two_tap(x, hw, normalize, scale_values), ref.numpy(), atol=1e-5 if scale_values else 1e-3)


def test_kernel_tiling_covers_every_tile():
    """The tiling the wrapper hands the kernel: a stage holds the source rows
    of any tile, two stages and the staged output fit the block's shared
    memory, and what cannot fit raises."""
    for H, W, C, oh, ow, in_size, out_size in [(480, 640, 3, 256, 341, 1, 1), (480, 640, 1, 256, 341, 4, 4),
                                               (37, 53, 4, 64, 75, 1, 2), (2000, 1500, 4, 100, 600, 4, 4)]:
        R, stage, smem, per_sm = kernel_tiling(H, W, C, oh, ow, in_size, out_size)
        lo, hi, _, _ = bilinear_taps(H, oh)
        assert 1 <= R <= 8 and stage % 16 == 0 and per_sm >= 1 and per_sm * smem <= 227 * 1024
        for r0 in range(0, oh, R):
            assert (hi[min(r0 + R, oh) - 1] - lo[r0] + 1) * W * C * in_size <= stage
        assert smem >= 16 + 16 * ow + 2 * stage + R * ow * C * out_size + 16
    assert kernel_tiling(480, 640, 3, 256, 341, 1, 1)[0] == 8  # the act shape: one output row per warp
    with pytest.raises(ValueError, match="shared memory"):
        kernel_tiling(8, 16384, 4, 4, 8, 4, 4)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_matches_pallas(case):
    name, shape, dtype, hw, normalize, out_dtype, scale_values = case
    x = _image(shape, dtype, len(name))
    ref = jax_frn(jnp.asarray(x), hw, normalize=normalize, out_dtype=getattr(jnp, out_dtype),
                  interpret=True, scale_values=scale_values)
    out = fused_resize_normalize(torch.from_numpy(x), hw, normalize=normalize,
                                 out_dtype=getattr(torch, out_dtype), scale_values=scale_values)
    assert out.dtype == getattr(torch, out_dtype) and tuple(out.shape) == (shape[0],) + hw + (shape[3],)
    ref = np.asarray(ref.astype(jnp.float32))
    out = out.float().numpy()
    if out_dtype == "bfloat16":
        ulp = np.abs(ref) * 2.0**-7  # one bf16 ulp is at most |v| * 2^-7
        assert np.all(np.abs(out - ref) <= ulp + 1e-6)
    else:
        np.testing.assert_allclose(out, ref, atol=1e-5 if scale_values else 1e-3)


def test_u8_out_rounds_half_to_even():
    # 1x2 -> 1x4: the edges clamp, the middle outputs are 1.25 and 1.75
    x = torch.tensor([[[[1], [2]]]], dtype=torch.uint8)
    np.testing.assert_array_equal(
        fused_resize_normalize(x, (1, 4), out_dtype=torch.uint8, scale_values=False).flatten().numpy(), [1, 1, 2, 2]
    )
    # 1x2 -> 1x1 is the mean of the two pixels: exact ties 0.5, 2.5 and 1.5
    ties = torch.tensor([[0, 1], [2, 3], [1, 2]], dtype=torch.uint8).reshape(3, 1, 2, 1)
    out = fused_resize_normalize(ties, (1, 1), out_dtype=torch.uint8, scale_values=False)
    np.testing.assert_array_equal(out.flatten().numpy(), [0, 2, 2])


def test_resize_bilinear_u8_matches_jax():
    """The integer resize (round half to even, clip) equals the JAX one, up
    to +-1 on at most 0.01% of pixels where summation order flips a tie."""
    x = _image((4, 96, 128, 3), np.uint8, 7)
    ref = np.asarray(jax_ot.resize_bilinear(jnp.asarray(x), (64, 85)))
    out = ot.resize_bilinear(torch.from_numpy(x), (64, 85))
    assert out.dtype == torch.uint8
    diff = np.abs(out.numpy().astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-4


def test_resize_bilinear_keeps_leading_axes():
    x = torch.from_numpy(_image((2, 3, 16, 24, 1), np.float32, 3))
    out = ot.resize_bilinear(x, (8, 12))
    assert tuple(out.shape) == (2, 3, 8, 12, 1) and out.dtype == torch.float32
    flat = fused_resize_normalize_plain(x.reshape(6, 16, 24, 1), (8, 12), out_dtype=torch.float32, scale_values=False)
    np.testing.assert_array_equal(out.reshape(6, 8, 12, 1).numpy(), flat.numpy())

