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
from vlnce_torch.ops.rnn import gru_sequence, gru_sequence_backward, gru_sequence_backward_plain, gru_sequence_plain


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    return torch.device("cuda", 0)


def _gru_inputs(T, B, H, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    xi = torch.randn(T, B, 3 * H, generator=g)
    masks = torch.ones(T, B, 1)
    masks[T // 2, 1::2] = 0.0  # resets in the middle of the sequence
    h0 = torch.randn(B, H, generator=g)
    w_hh = torch.randn(3 * H, H, generator=g) * H**-0.5
    b_hh = torch.randn(3 * H, generator=g) * 0.1
    return [t.to(device) for t in (xi, masks, h0, w_hh, b_hh)]


@pytest.mark.cuda
@pytest.mark.parametrize("H", [64, 128, 512])
@pytest.mark.parametrize("B", [1, 3, 32, 40])
@pytest.mark.parametrize("T", [1, 2, 16])
def test_gru_kernel_matches_plain(T, B, H):
    """Non-zero h0 handed over as `states[:, 0]` of a [B, 2, H] state (rows
    2H apart); atol 1e-4: the kernel sums each dot product in another order."""
    xi, masks, h0, w_hh, b_hh = _gru_inputs(T, B, H, _card())
    h0 = torch.stack([h0, torch.full_like(h0, float("nan"))], dim=1)[:, 0]
    assert not h0.is_contiguous() or B == 1
    out = gru_sequence(xi, masks, h0, w_hh, b_hh)
    ref = gru_sequence_plain(xi, masks, h0, w_hh, b_hh)
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), atol=1e-4)


def _strided(h0):
    """h0 as `states[:, 0]` of a [B, 2, H] recurrent state: rows 2H apart."""
    return torch.stack([h0, torch.full_like(h0, float("nan"))], dim=1)[:, 0]


def _assert_gradients_close(got, ref):
    """d_xi, d_h0 and d_b_hh within atol 1e-5 scaled by the reference's
    largest value where that exceeds 1 (they are of order 1); d_w_hh, a sum
    over T * B rows, within 1e-5 of its own scale."""
    for name, a, b in zip(("d_xi", "d_h0", "d_w_hh", "d_b_hh"), got, ref):
        assert a.shape == b.shape, name
        scale = max(1.0, float(b.abs().max()))
        err = float((a - b).abs().max())
        assert err <= 1e-5 * scale, f"{name}: max abs err {err:.3e} at scale {scale:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("H", [64, 512])
@pytest.mark.parametrize("B", [1, 4, 5, 8, 32])
@pytest.mark.parametrize("T", [1, 2, 16, 48])
def test_gru_backward_kernel_matches_plain(T, B, H):
    """The backward kernel against the explicit formula, with resets in the
    middle, a strided h0 and a d_out that is a transposed view."""
    dev = _card()
    xi, masks, h0, w_hh, b_hh = _gru_inputs(T, B, H, dev)
    h0 = _strided(h0)
    out = gru_sequence_plain(xi, masks, h0, w_hh, b_hh)
    g = torch.Generator().manual_seed(T * 100 + B)
    d_out = torch.randn(B, T, H, generator=g).to(dev).transpose(0, 1)
    assert not d_out.is_contiguous() or T == 1 or B == 1
    got = gru_sequence_backward(d_out, xi, masks, h0, w_hh, b_hh, out)
    ref = gru_sequence_backward_plain(d_out, xi, masks, h0, w_hh, b_hh, out)
    torch.cuda.synchronize()
    assert tuple(got[1].shape) == (B, H)
    _assert_gradients_close(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H", [(1, 8, 512), (16, 5, 512), (32, 5, 512), (6, 3, 64)])
def test_gru_sequence_autograd_matches_plain_loop(T, B, H):
    """`gru_sequence` on the card (both kernels) against autograd through
    the plain loop, in f32 at atol 1e-5 (relative to scale above 1), for a
    loss that weighs every output, through a strided h0."""
    dev = _card()
    g = torch.Generator().manual_seed(5)
    weight = torch.randn(T, B, H, generator=g).to(dev)
    grads = []
    for fn in (gru_sequence, gru_sequence_plain):
        xi, masks, h0, w_hh, b_hh = _gru_inputs(T, B, H, dev)
        states = torch.stack([h0, torch.zeros_like(h0)], dim=1).requires_grad_()
        leaves = [xi.requires_grad_(), states, w_hh.requires_grad_(), b_hh.requires_grad_()]
        out = fn(xi, masks, states[:, 0], w_hh, b_hh)
        (out * weight).sum().backward()
        grads.append([xi.grad, states.grad[:, 0], w_hh.grad, b_hh.grad])
        assert float(states.grad[:, 1].abs().max()) == 0.0
    torch.cuda.synchronize()
    _assert_gradients_close(*grads)


@pytest.mark.cuda
def test_gru_backward_counts_launches_and_leaves_no_grad_for_masks():
    dev = _card()
    xi, masks, h0, w_hh, b_hh = _gru_inputs(4, 5, 64, dev)
    masks.requires_grad_()
    before = gru_sequence.launches, gru_sequence_backward.launches
    out = gru_sequence(xi.requires_grad_(), masks, h0, w_hh, b_hh)
    out.sum().backward()
    assert (gru_sequence.launches, gru_sequence_backward.launches) == (before[0] + 1, before[1] + 1)
    assert masks.grad is None and xi.grad is not None


@pytest.mark.cuda
def test_gru_backward_step_is_graph_capturable():
    """T = 1 is ordinary launches: the act step's backward can be captured."""
    dev = _card()
    xi, masks, h0, w_hh, b_hh = _gru_inputs(1, 8, 512, dev)
    out = gru_sequence_plain(xi, masks, h0, w_hh, b_hh)
    d_out = torch.ones_like(out)
    want = gru_sequence_backward(d_out, xi, masks, h0, w_hh, b_hh, out)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = gru_sequence_backward(d_out, xi, masks, h0, w_hh, b_hh, out)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _assert_resize_close(out, ref, out_dtype, scale_values):
    """u8 within 1 on at most 0.01% of values (summation order can flip a .5
    tie), bf16 within one bf16 ulp, f32 1e-5 on [0, 1]-scaled values and 1e-3
    on raw [0, 255] values."""
    diff = (out.float() - ref.float()).abs()
    if out_dtype == torch.uint8:
        assert float(diff.max()) <= 1 and float((diff > 0).float().mean()) <= 1e-4
    elif out_dtype == torch.bfloat16:
        assert bool((diff <= ref.float().abs() * 2.0**-7 + 1e-6).all())
    else:
        assert float(diff.max()) <= (1e-5 if scale_values else 1e-3)


def _images(shape, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.uint8:
        return torch.randint(0, 256, shape, generator=g, dtype=torch.uint8)
    return torch.rand(shape, generator=g)


TYPE_PAIRS = [(torch.uint8, torch.uint8), (torch.uint8, torch.float32), (torch.uint8, torch.bfloat16),
              (torch.float32, torch.float32), (torch.float32, torch.bfloat16)]


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 3, 4])
@pytest.mark.parametrize("in_dtype,out_dtype", TYPE_PAIRS, ids=lambda d: str(d).split(".")[-1])
def test_resize_kernel_matches_plain(in_dtype, out_dtype, C):
    # the RxR frame size: enough u8 values (1M) that the 0.01% share of
    # summation-order tie flips is a count, not a fraction of one value
    x = _images((4, 480, 640, C), in_dtype, 1).to(_card())
    kw = dict(normalize=out_dtype == torch.bfloat16 and C <= 3, out_dtype=out_dtype, scale_values=out_dtype != torch.uint8)
    out = fused_resize_normalize(x, (256, 341), **kw)
    ref = fused_resize_normalize_plain(x, (256, 341), **kw)
    torch.cuda.synchronize()
    _assert_resize_close(out, ref, out_dtype, kw["scale_values"])


# (name, input shape, input dtype, out_hw, out dtype); u8 output only where
# the 0.01% share of tie flips is a count of values, not a fraction of one
RESIZE_SHAPES = [
    ("act_rgb", (32, 480, 640, 3), torch.uint8, (256, 341), torch.uint8),
    ("act_depth", (32, 480, 640, 1), torch.float32, (256, 341), torch.float32),
    ("upscale", (2, 32, 32, 3), torch.uint8, (48, 48), torch.float32),
    ("identity", (2, 224, 224, 3), torch.uint8, (224, 224), torch.float32),
    ("odd_width_u8", (3, 37, 53, 3), torch.uint8, (20, 31), torch.bfloat16),  # rows of 159 bytes
    ("odd_width_f32", (3, 45, 61, 1), torch.float32, (64, 75), torch.float32),  # rows of 244 bytes
    ("single_image", (1, 480, 640, 4), torch.uint8, (256, 341), torch.uint8),
    ("odd_width_u8_out", (4, 250, 333, 3), torch.uint8, (133, 177), torch.uint8),  # rows of 999 bytes
    ("one_output_row", (2, 64, 64, 3), torch.float32, (1, 7), torch.float32),
    ("steep_downscale", (2, 200, 300, 1), torch.float32, (13, 17), torch.float32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", RESIZE_SHAPES, ids=[c[0] for c in RESIZE_SHAPES])
def test_resize_kernel_shapes(case):
    _, shape, in_dtype, hw, out_dtype = case
    x = _images(shape, in_dtype, 2).to(_card())
    kw = dict(normalize=False, out_dtype=out_dtype, scale_values=False)
    out = fused_resize_normalize(x, hw, **kw)
    ref = fused_resize_normalize_plain(x, hw, **kw)
    torch.cuda.synchronize()
    assert out.dtype == out_dtype and tuple(out.shape) == (shape[0],) + hw + (shape[3],)
    if case[0] == "identity":
        assert torch.equal(out, x.float())
    _assert_resize_close(out, ref, out_dtype, False)


@pytest.mark.cuda
def test_resize_kernel_unaligned_base():
    """A view that starts 4 bytes into its storage: no 16-byte copies."""
    flat = _images((2 * 96 * 128 + 1,), torch.float32, 3).to(_card())
    x = flat[1:].reshape(2, 96, 128, 1)
    assert x.data_ptr() % 16 == 4
    out = fused_resize_normalize(x, (64, 85), out_dtype=torch.float32)
    ref = fused_resize_normalize_plain(x, (64, 85), out_dtype=torch.float32)
    torch.cuda.synchronize()
    _assert_resize_close(out, ref, torch.float32, True)


@pytest.mark.cuda
def test_wrappers_are_graph_capturable():
    """Both wrappers launch on the capture stream, allocate with torch only
    and copy nothing from the host once a shape has been seen."""
    dev = _card()
    args = _gru_inputs(1, 32, 512, dev)
    x = _images((4, 480, 640, 3), torch.uint8, 4).to(dev)
    kw = dict(out_dtype=torch.uint8, scale_values=False)
    want = gru_sequence(*args), fused_resize_normalize(x, (256, 341), **kw)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = gru_sequence(*args), fused_resize_normalize(x, (256, 341), **kw)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_gru_wrapper_rejects_bad_inputs():
    xi, masks, h0, w_hh, b_hh = _gru_inputs(2, 3, 8, "meta")
    with pytest.raises(ValueError, match="float32"):
        gru_sequence(xi.half(), masks, h0, w_hh, b_hh)
    with pytest.raises(ValueError, match="contiguous"):
        gru_sequence(xi, masks, h0, w_hh.t().contiguous().t(), b_hh)
    with pytest.raises(ValueError, match="shape"):
        gru_sequence(xi, masks, h0[:2], w_hh, b_hh)
    with pytest.raises(ValueError, match="contiguous along its rows"):
        gru_sequence(xi, masks, h0.t().contiguous().t(), w_hh, b_hh)
    xi, masks, h0, w_hh, b_hh = _gru_inputs(2, 3, 6, "meta")
    with pytest.raises(ValueError, match="multiple of 4"):
        gru_sequence(xi, masks, h0, w_hh, b_hh)
    xi, masks, h0, w_hh, b_hh = (torch.empty(s, device="meta") for s in [(1, 1, 3 * 4096), (1, 1, 1), (1, 4096), (3 * 4096, 4096), (3 * 4096,)])
    with pytest.raises(ValueError, match="multiple of 4 up to"):
        gru_sequence(xi, masks, h0, w_hh, b_hh)


def test_gru_backward_wrapper_rejects_bad_inputs():
    xi, masks, h0, w_hh, b_hh = _gru_inputs(2, 3, 8, "meta")
    out = torch.empty(2, 3, 8, device="meta")
    with pytest.raises(ValueError, match="d_out has shape"):
        gru_sequence_backward(out[:1], xi, masks, h0, w_hh, b_hh, out)
    with pytest.raises(ValueError, match="float32"):
        gru_sequence_backward(out.double(), xi, masks, h0, w_hh, b_hh, out)
    with pytest.raises(ValueError, match="out must be contiguous"):
        gru_sequence_backward(out, xi, masks, h0, w_hh, b_hh, torch.empty(3, 2, 8, device="meta").transpose(0, 1))
    with pytest.raises(ValueError, match="contiguous along its rows"):
        gru_sequence_backward(out, xi, masks, h0.t().contiguous().t(), w_hh, b_hh, out)
    xi, masks, h0, w_hh, b_hh = _gru_inputs(2, 3, 6, "meta")
    with pytest.raises(ValueError, match="multiple of 4"):
        gru_sequence_backward(torch.empty(2, 3, 6, device="meta"), xi, masks, h0, w_hh, b_hh, torch.empty(2, 3, 6, device="meta"))


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
    with pytest.raises(ValueError, match="shared memory"):  # two stages of two f32 rows of 16384 x 4
        fused_resize_normalize(torch.empty(1, 8, 16384, 4, device="meta"), (4, 8))
