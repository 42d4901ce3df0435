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
from vlnce_torch.ops.preprocess import bilinear_matrix, fused_resize_normalize, fused_resize_normalize_plain

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

