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
from vlnce_torch.ops.rnn import (_forward_launch, backward_cluster_plan, gru_sequence, gru_sequence_backward,
                                 gru_sequence_backward_plain, gru_sequence_plain, gru_weight_gradient,
                                 gru_weight_gradient_plain)


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
@pytest.mark.parametrize("H", [64, 128, 256, 512])
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
@pytest.mark.parametrize("H", [64, 256, 512])
@pytest.mark.parametrize("B", [1, 4, 5, 8, 32])
@pytest.mark.parametrize("T", [1, 2, 16, 32, 48])
def test_gru_backward_kernel_matches_plain(T, B, H):
    """The grid route (no gates given: they are recomputed) against the
    explicit formula, with resets in the middle, a strided h0 and a d_out
    that is a transposed view."""
    dev = _card()
    xi, masks, h0, w_hh, b_hh = _gru_inputs(T, B, H, dev)
    h0 = _strided(h0)
    out = gru_sequence_plain(xi, masks, h0, w_hh, b_hh)
    g = torch.Generator().manual_seed(T * 100 + B)
    d_out = torch.randn(B, T, H, generator=g).to(dev).transpose(0, 1)
    assert not d_out.is_contiguous() or T == 1 or B == 1
    cluster_before = gru_sequence_backward.cluster_launches
    got = gru_sequence_backward(d_out, xi, masks, h0, w_hh, b_hh, out)
    ref = gru_sequence_backward_plain(d_out, xi, masks, h0, w_hh, b_hh, out)
    torch.cuda.synchronize()
    assert tuple(got[1].shape) == (B, H) and gru_sequence_backward.cluster_launches == cluster_before
    _assert_gradients_close(got, ref)


def _expected_cluster(B, H):
    """The cluster the route should take on an H100: H=64 fits one block;
    H=256 (the waypoint configs) spreads w_hh over 4 blocks of 64 units, with
    room for the planes of all 8 rows the route takes; H=512 spreads it over
    16 blocks, whose shared memory holds the two planes of up to 7 rows."""
    return {64: 1, 256: 4}.get(H, 16 if B <= 7 else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("H", [64, 256, 512])
@pytest.mark.parametrize("B", [1, 4, 5, 8])
@pytest.mark.parametrize("T", [1, 2, 16, 32, 48])
def test_gru_backward_cluster_route_matches_plain(T, B, H):
    """With the gates given, the cluster route where the plan has a cluster
    (else the grid route), against the explicit formula reading the same
    gates: resets in the middle, a strided h0, a transposed d_out."""
    dev = _card()
    xi, masks, h0, w_hh, b_hh = _gru_inputs(T, B, H, dev, seed=1)
    h0 = _strided(h0)
    out, gates = gru_sequence_plain(xi, masks, h0, w_hh, b_hh, return_gates=True)
    g = torch.Generator().manual_seed(T * 100 + B + 7)
    d_out = torch.randn(B, T, H, generator=g).to(dev).transpose(0, 1)
    cluster, active = backward_cluster_plan(dev.index, B, H)
    assert cluster == _expected_cluster(B, H) and (active >= 1) == (cluster > 0)
    before = gru_sequence_backward.cluster_launches
    got = gru_sequence_backward(d_out, xi, masks, h0, w_hh, b_hh, out, gates=gates)
    ref = gru_sequence_backward_plain(d_out, xi, masks, h0, w_hh, b_hh, out, gates=gates)
    torch.cuda.synchronize()
    assert gru_sequence_backward.cluster_launches == before + (cluster > 0)
    _assert_gradients_close(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H", [(1, 32, 512), (1, 8, 512), (16, 5, 512), (32, 5, 512), (48, 5, 512), (2, 3, 64),
                                   (16, 4, 128)])
def test_gru_forward_reserve_matches_plain_gates(T, B, H):
    """The training forward's reserve (r, z, n, hh_n) against the plain
    forward's gates at the forward's tolerance; storing it leaves out
    bit-equal."""
    dev = _card()
    xi, masks, h0, w_hh, b_hh = _gru_inputs(T, B, H, dev, seed=2)
    h0 = _strided(h0)
    out, gates = _forward_launch(xi, masks, h0, w_hh, b_hh, reserve=True)
    plain_out, plain_gates = gru_sequence_plain(xi, masks, h0, w_hh, b_hh, return_gates=True)
    bare = _forward_launch(xi, masks, h0, w_hh, b_hh)
    torch.cuda.synchronize()
    assert torch.equal(out, bare)
    np.testing.assert_allclose(out.cpu().numpy(), plain_out.cpu().numpy(), atol=1e-4)
    np.testing.assert_allclose(gates.cpu().numpy(), plain_gates.cpu().numpy(), atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("h0_rows", ["strided", "unaligned"])
@pytest.mark.parametrize("T,B,H", [(32, 5, 512), (48, 5, 512), (1, 8, 512), (3, 7, 100), (5, 3, 64), (16, 1, 256),
                                   (16, 4, 256)])
def test_gru_weight_gradient_kernel_matches_plain(T, B, H, h0_rows):
    """The weight-gradient launch against d_gh^T @ h_prev: H=100 leaves
    ragged tiles (3H and H no multiple of 64), an unaligned h0 has rows
    H + 1 floats apart from an odd offset, so no float4 loads of it."""
    dev = _card()
    g = torch.Generator().manual_seed(T + B + H)
    d_gh = torch.randn(T, B, 3 * H, generator=g).to(dev)
    masks = (torch.rand(T, B, 1, generator=g) > 0.2).float().to(dev)
    out = torch.randn(T, B, H, generator=g).to(dev)
    rows = torch.randn(B, H + 1, generator=g).to(dev)
    h0 = rows[:, 1:] if h0_rows == "unaligned" else _strided(rows[:, :H].contiguous())
    got = gru_weight_gradient(d_gh, masks, h0, out)
    ref = gru_weight_gradient_plain(d_gh, masks, h0, out)
    torch.cuda.synchronize()
    for name, a, b in zip(("d_w_hh", "d_b_hh"), got, ref):
        scale = max(1.0, float(b.abs().max()))
        assert float((a - b).abs().max()) <= 1e-5 * scale, name


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H", [(1, 8, 512), (16, 5, 512), (32, 5, 512), (6, 3, 64), (48, 5, 512), (1, 5, 512)])
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
@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("T,B", [(1, 2), (1, 4), (16, 1), (16, 2), (16, 4)])
def test_gru_waypoint_state_slices_match_plain(T, B, layer):
    """The waypoint policy's two GRUs at H=256 read their h0 as `states[:,
    0]` and `states[:, 1]` of one [B, 2, H] state (rows 2H apart, the second
    H floats in): at the act step's T=1 and the PPO minibatch's T=16, the
    output and, through the training forward's gates and the cluster route,
    the gradient flowing back into the strided view match autograd through
    the plain loop; the other GRU's slice gets no gradient."""
    dev = _card()
    H = 256
    g = torch.Generator().manual_seed(11 + T + B)
    weight = torch.randn(T, B, H, generator=g).to(dev)
    outs, grads = [], []
    for fn in (gru_sequence, gru_sequence_plain):
        xi, masks, h0, w_hh, b_hh = _gru_inputs(T, B, H, dev, seed=4)
        states = torch.randn(B, 2, H, generator=torch.Generator().manual_seed(B)).to(dev).requires_grad_()
        leaves = [xi.requires_grad_(), w_hh.requires_grad_(), b_hh.requires_grad_()]
        before = gru_sequence_backward.cluster_launches
        out = fn(xi, masks, states[:, layer], w_hh, b_hh)
        (out * weight).sum().backward()
        assert gru_sequence_backward.cluster_launches == before + (fn is gru_sequence)
        outs.append(out.detach())
        grads.append([leaves[0].grad, states.grad[:, layer], leaves[1].grad, leaves[2].grad])
        assert float(states.grad[:, 1 - layer].abs().max()) == 0.0
    torch.cuda.synchronize()
    np.testing.assert_allclose(outs[0].cpu().numpy(), outs[1].cpu().numpy(), atol=1e-5 if T == 1 else 1e-4)
    _assert_gradients_close(*grads)


@pytest.mark.cuda
def test_gru_backward_counts_launches_and_leaves_no_grad_for_masks():
    dev = _card()
    xi, masks, h0, w_hh, b_hh = _gru_inputs(4, 5, 64, dev)
    masks.requires_grad_()
    counters = lambda: (gru_sequence.launches, gru_sequence_backward.launches, gru_sequence_backward.cluster_launches,
                        gru_weight_gradient.launches)  # noqa: E731
    before = counters()
    out = gru_sequence(xi.requires_grad_(), masks, h0, w_hh, b_hh)
    out.sum().backward()
    assert counters() == tuple(n + 1 for n in before)  # the training forward's gates took the cluster route
    assert masks.grad is None and xi.grad is not None
    with torch.no_grad():
        gru_sequence(xi, masks, h0, w_hh, b_hh)
    assert counters() == (before[0] + 2,) + tuple(n + 1 for n in before[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("B", [5, 8])
def test_gru_training_forward_stores_gates_only_for_the_cluster_route(B):
    """At H=512 the cluster route takes B=5, not B=8: the training forward
    saves the gates for the one and nothing for the other, whose backward
    recomputes them on the grid route."""
    dev = _card()
    xi, masks, h0, w_hh, b_hh = _gru_inputs(3, B, 512, dev)
    cluster = backward_cluster_plan(dev.index, B, 512)[0]
    assert (cluster > 0) == (B == 5)
    out = gru_sequence(xi.requires_grad_(), masks, h0, w_hh, b_hh)
    gates = out.grad_fn.saved_tensors[-1]
    assert (gates is None) == (cluster == 0)
    before = gru_sequence_backward.cluster_launches
    out.sum().backward()
    assert gru_sequence_backward.cluster_launches == before + (cluster > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 2, 3])
@pytest.mark.parametrize("T", [1, 57, 250])
def test_gru_recollect_shapes_match_plain(T, B):
    """The recollect trainer's batch (IL.batch_size 3 and below) up to the
    YAMLs' max_traj_len of 250 at H=512: the training forward storing the
    gates, the cluster-route backward reading them, and the weight gradient,
    each against its plain version (resets at T/3, a strided h0, a
    transposed d_out), at the tolerances of the shorter shapes."""
    H = 512
    dev = _card()
    cluster, active = backward_cluster_plan(dev.index, B, H)
    assert cluster == _expected_cluster(B, H) and active >= 1
    xi, masks, h0, w_hh, b_hh = _gru_inputs(T, B, H, dev, seed=3)
    masks[T // 3] = 0.0
    h0 = _strided(h0)
    out, gates = _forward_launch(xi, masks, h0, w_hh, b_hh, reserve=True)
    plain_out, plain_gates = gru_sequence_plain(xi, masks, h0, w_hh, b_hh, return_gates=True)
    g = torch.Generator().manual_seed(T * 10 + B)
    d_out = torch.randn(B, T, H, generator=g).to(dev).transpose(0, 1)
    before = gru_sequence_backward.cluster_launches
    got = gru_sequence_backward(d_out, xi, masks, h0, w_hh, b_hh, plain_out, gates=plain_gates)
    ref = gru_sequence_backward_plain(d_out, xi, masks, h0, w_hh, b_hh, plain_out, gates=plain_gates)
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.cpu().numpy(), plain_out.cpu().numpy(), atol=1e-4)
    np.testing.assert_allclose(gates.cpu().numpy(), plain_gates.cpu().numpy(), atol=1e-4)
    assert gru_sequence_backward.cluster_launches == before + 1
    _assert_gradients_close(got, ref)


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


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 32])
def test_gru_backward_cluster_route_is_graph_capturable(T):
    """The cluster launch and the weight gradient's launch capture into a
    CUDA graph once the plan has been asked for."""
    dev = _card()
    xi, masks, h0, w_hh, b_hh = _gru_inputs(T, 5, 512, dev)
    out, gates = gru_sequence_plain(xi, masks, h0, w_hh, b_hh, return_gates=True)
    d_out = torch.ones_like(out)
    want = gru_sequence_backward(d_out, xi, masks, h0, w_hh, b_hh, out, gates=gates)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = gru_sequence_backward(d_out, xi, masks, h0, w_hh, b_hh, out, gates=gates)
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
@pytest.mark.parametrize("sensor", ["rgb", "depth"])
def test_resize_kernel_on_a_training_batch(sensor):
    """One recollect train step's collated frames at once (T=40 x N=3 = 120
    frames of 480x640), as ResizeShortestEdge(256) runs them: u8 RGB to u8,
    f32 depth to f32; the padded steps are frames of ones."""
    shape, dtype, out_dtype = ((120, 480, 640, 3), torch.uint8, torch.uint8) if sensor == "rgb" else \
        ((120, 480, 640, 1), torch.float32, torch.float32)
    x = _images(shape, dtype, 4).to(_card())
    x[-9:] = 1
    kw = dict(normalize=False, out_dtype=out_dtype, scale_values=False)
    out = fused_resize_normalize(x, (256, 341), **kw)
    ref = fused_resize_normalize_plain(x, (256, 341), **kw)
    torch.cuda.synchronize()
    assert tuple(out.shape) == (120, 256, 341, shape[3])
    _assert_resize_close(out, ref, out_dtype, False)
    assert float((out[-9:].float() - 1.0).abs().max()) <= 1e-6


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
    with pytest.raises(ValueError, match="gates has shape"):
        gru_sequence_backward(out, xi, masks, h0, w_hh, b_hh, out, gates=torch.empty(2, 3, 3 * 8, device="meta"))
    xi, masks, h0, w_hh, b_hh = _gru_inputs(2, 3, 6, "meta")
    with pytest.raises(ValueError, match="multiple of 4"):
        gru_sequence_backward(torch.empty(2, 3, 6, device="meta"), xi, masks, h0, w_hh, b_hh, torch.empty(2, 3, 6, device="meta"))


def test_gru_weight_gradient_wrapper_rejects_bad_inputs():
    _, masks, h0, _, _ = _gru_inputs(2, 3, 8, "meta")
    d_gh, out = torch.empty(2, 3, 24, device="meta"), torch.empty(2, 3, 8, device="meta")
    with pytest.raises(ValueError, match="d_gh has shape"):
        gru_weight_gradient(d_gh[:, :, :16], masks, h0, out)
    with pytest.raises(ValueError, match="float32"):
        gru_weight_gradient(d_gh, masks.double(), h0, out)
    with pytest.raises(ValueError, match="d_gh must be contiguous"):
        gru_weight_gradient(torch.empty(3, 2, 24, device="meta").transpose(0, 1), masks, h0, out)
    with pytest.raises(ValueError, match="contiguous along its rows"):
        gru_weight_gradient(d_gh, masks, h0.t().contiguous().t(), out)


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
