"""The port's CUDA kernels against their plain PyTorch versions, and the
wrappers' input checks.

Imports neither JAX nor the JAX package, so the tests marked `cuda` run on a
machine with a card and no JAX:

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda -q

Here, without a card, they skip. The input checks run anywhere: they raise
before any kernel is built, on tensors of PyTorch's "meta" device.
"""

import numpy as np
import pytest
import torch

from vlnce_torch.ops.preprocess import fused_resize_normalize, fused_resize_normalize_plain
from vlnce_torch.ops.rnn import gru_sequence, gru_sequence_plain


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    return torch.device("cuda", 0)


def _gru_inputs(T, B, H, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    xi = torch.randn(T, B, 3 * H, generator=g)
    masks = torch.ones(T, B, 1)
    masks[T // 2, 1::2] = 0.0
    h0 = torch.randn(B, H, generator=g)
    w_hh = torch.randn(3 * H, H, generator=g) * H**-0.5
    b_hh = torch.randn(3 * H, generator=g) * 0.1
    return [t.to(device) for t in (xi, masks, h0, w_hh, b_hh)]


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H", [(1, 32, 512), (16, 4, 512), (5, 3, 64)])
def test_gru_kernel_matches_plain(T, B, H):
    args = _gru_inputs(T, B, H, _card())
    out = gru_sequence(*args)
    ref = gru_sequence_plain(*args)
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16, torch.uint8])
def test_resize_kernel_matches_plain(out_dtype):
    # the RxR frame size: enough u8 values (1M) that the 0.01% share of
    # summation-order tie flips is a count, not a fraction of one value
    g = torch.Generator().manual_seed(1)
    x = torch.randint(0, 256, (4, 480, 640, 3), generator=g, dtype=torch.uint8).to(_card())
    kw = dict(normalize=out_dtype == torch.bfloat16, out_dtype=out_dtype, scale_values=out_dtype != torch.uint8)
    out = fused_resize_normalize(x, (256, 341), **kw).float()
    ref = fused_resize_normalize_plain(x, (256, 341), **kw).float()
    torch.cuda.synchronize()
    diff = (out - ref).abs()
    if out_dtype == torch.uint8:
        assert float(diff.max()) <= 1 and float((diff > 0).float().mean()) <= 1e-4
    elif out_dtype == torch.bfloat16:
        assert bool((diff <= ref.abs() * 2.0**-7 + 1e-6).all())
    else:
        assert float(diff.max()) <= 1e-5


def test_gru_wrapper_rejects_bad_inputs():
    xi, masks, h0, w_hh, b_hh = _gru_inputs(2, 3, 8, "meta")
    with pytest.raises(ValueError, match="float32"):
        gru_sequence(xi.half(), masks, h0, w_hh, b_hh)
    with pytest.raises(ValueError, match="contiguous"):
        gru_sequence(xi, masks, h0, w_hh.t().contiguous().t(), b_hh)
    with pytest.raises(ValueError, match="shape"):
        gru_sequence(xi, masks, h0[:2], w_hh, b_hh)
    xi, masks, h0, w_hh, b_hh = _gru_inputs(2, 3, 6, "meta")
    with pytest.raises(ValueError, match="multiple of 4"):
        gru_sequence(xi, masks, h0, w_hh, b_hh)


def test_resize_wrapper_rejects_bad_inputs():
    x = torch.empty(2, 16, 16, 3, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="u8/f32"):
        fused_resize_normalize(x.to(torch.int32), (8, 8))
    with pytest.raises(ValueError, match="contiguous"):
        fused_resize_normalize(x.transpose(1, 2), (8, 8))
    with pytest.raises(ValueError, match="u8 input only"):
        fused_resize_normalize(x.float(), (8, 8), out_dtype=torch.uint8)
    with pytest.raises(ValueError, match="C<=4"):
        fused_resize_normalize(torch.empty(2, 16, 16, 5, device="meta"), (8, 8))
