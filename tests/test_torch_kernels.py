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


def _field_batch(scenes, goals_per_scene, seed, host=None):
    """Occupancy [R, n, n] of `scenes` (padded to the largest, blocked),
    and cells [F, 3]: `goals_per_scene` goal cells on each, some blocked
    (snapped as the host snaps them). Returns (occupancy, cells, the host
    fields [F, n, n] padded with +inf): `host(scene, cell)`, by default the
    port's Dijkstra (tests/test_torch_goal_field.py holds these cases' fields
    to the JAX package's, on a machine with JAX)."""
    from vlnce_torch.envs.device_sim import _pad_grid

    host = host or (lambda scene, cell: scene._dijkstra(cell))
    rng = np.random.RandomState(seed)
    n = max(s.n for s in scenes)
    cells, want = [], []
    for row, scene in enumerate(scenes):
        for _ in range(goals_per_scene):
            cell = tuple(int(v) for v in rng.randint(0, scene.n, 2))
            cells.append((row, *scene.snap_goal_cell(*cell)))
            want.append(_pad_grid(host(scene, cell), n, np.inf))
    occ = torch.from_numpy(np.stack([_pad_grid(s.occupancy, n, True) for s in scenes]))
    return occ, torch.tensor(cells, dtype=torch.int32), np.stack(want)


def _procedural_case():
    from vlnce_torch.envs.gridworld import get_scene

    return [get_scene(f"synth_scene_{k}") for k in range(11)], 2, 1


def _lattice_case(world, seed):
    def case():
        from vlnce_torch.envs.scene_import import scene_from_graph
        from vlnce_torch.utils.nav_graph import synthetic_lattice_graph

        return [scene_from_graph(f"lattice_{int(world)}", synthetic_lattice_graph(world_size=world))], 3, seed

    return case


# label: () -> (scenes, goals per scene, seed). The kernel's routes: shared
# memory under the default 48 KB (n = 64), shared memory above it, which needs
# the kernel's attribute call (n = 80, and n = 160 at the top), device memory
# (n = 176).
GOAL_FIELD_CARD_CASES = {
    "n=64 F=22": _procedural_case,
    "n=80": _lattice_case(20.0, 4),
    "n=160": _lattice_case(40.0, 5),
    "n=176": _lattice_case(44.0, 2),
}


@pytest.mark.cuda
def test_goal_field_build_is_graph_capturable_and_never_syncs():
    """The kernel launches on the capture stream, at n = 64 and at n = 80,
    where the first launch of the process at that size (this test runs
    before the others at n >= 80) grants the block its shared memory inside
    the capture; a chunk's whole field build (`scene_batch` after the
    upload) runs under the sync check."""
    from vlnce_torch.envs import device_sim as ds
    from vlnce_torch.ops.goal_field import goal_distance_fields

    dev = _card()
    for case, warm in (("n=80", False), ("n=64 F=22", True)):
        scenes, per_scene, seed = GOAL_FIELD_CARD_CASES[case]()
        occ, cells, want = _field_batch(scenes, per_scene, seed)
        occ, cells = occ.to(dev), cells.to(dev)
        if warm:
            goal_distance_fields(occ, cells, 0.25)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = goal_distance_fields(occ, cells, 0.25)
        graph.replay()
        torch.cuda.synchronize()
        assert np.array_equal(got.cpu().numpy(), want), case

    class Goal:
        def __init__(self, p):
            self.position = p

    class Ep:
        def __init__(self, scene_id, start, goals):
            self.scene_id, self.start_position, self.info = scene_id, start, {}
            self.goals = [Goal(g) for g in goals]

    eps = [Ep(f"synth_scene_{k % 3}", [1.5, 0.0, 1.5], [[13.5, 0.0, 13.5], [7.0, 0.0, 1.0]]) for k in range(6)]
    on_dev = ds.upload(ds.scene_inputs(eps), dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        scenes, _ = ds.scene_batch(on_dev)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    cpu = ds.build_scene_batch(eps)
    assert torch.equal(scenes.goal_field.cpu(), cpu.goal_field) and torch.equal(scenes.d0.cpu(), cpu.d0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GOAL_FIELD_CARD_CASES))
def test_goal_field_kernel_equals_plain_and_host(case):
    """22 fields on procedural 64 x 64 scenes, and on rasterised lattices
    of 80, 160 (shared memory above 48 KB) and 176 (device memory) cells a
    side, bit for bit; one launch, its fields counted."""
    from vlnce_torch.ops.goal_field import goal_distance_fields, goal_distance_fields_plain, shared_bytes

    dev = _card()
    scenes, per_scene, seed = GOAL_FIELD_CARD_CASES[case]()
    occ, cells, want = _field_batch(scenes, per_scene, seed)
    n = occ.shape[-1]
    assert n == int(case.split()[0][2:]) and (shared_bytes(n) == 0) == (n == 176)
    launches, fields = goal_distance_fields.launches, goal_distance_fields.fields
    got = goal_distance_fields(occ.to(dev), cells.to(dev), 0.25)
    torch.cuda.synchronize()
    assert (goal_distance_fields.launches - launches, goal_distance_fields.fields - fields) == (1, cells.shape[0])
    plain = goal_distance_fields_plain(occ, cells, 0.25).numpy()
    assert np.array_equal(plain, want) and np.array_equal(got.cpu().numpy(), want)


@pytest.mark.cuda
def test_ddppo_bank_goal_fields_equal_the_host_dijkstra():
    """The DD-PPO episode bank on the card (`rl/device_rollout.
    build_episode_queue`: one kernel launch for the split's distinct goals):
    each episode's field, the minimum over its goals, and its d0 equal the
    host Dijkstra's bit for bit, and the CPU route's (the plain
    relaxation)."""
    from vlnce_torch.config import get_config
    from vlnce_torch.envs.device_sim import _pad_grid
    from vlnce_torch.envs.gridworld import get_scene
    from vlnce_torch.ops.goal_field import goal_distance_fields
    from vlnce_torch.rl.device_rollout import build_episode_queue
    from vlnce_torch.tasks.datasets import make_dataset

    dev = _card()
    cfg = get_config("vlnce_torch/config/experiments/r2r_waypoint/1-wpn-cc.yaml", [
        "TASK_CONFIG.DATASET.TYPE", "Synthetic-VLN-v0", "TASK_CONFIG.DATASET.NUM_EPISODES", 48,
        "TASK_CONFIG.DATASET.NUM_SCENES", 6])
    eps = list(make_dataset(cfg.TASK_CONFIG.DATASET.TYPE, cfg.TASK_CONFIG.DATASET).episodes)
    eps[1].goals = list(eps[1].goals) + [eps[7].goals[0]]  # two goals: the minimum of their fields
    launches = goal_distance_fields.launches
    bank = build_episode_queue([eps], dev)
    torch.cuda.synchronize()
    assert goal_distance_fields.launches - launches == 1
    cpu = build_episode_queue([eps], "cpu")
    n = bank.goal_field.shape[-1]
    want, d0 = [], []
    for ep in eps:
        scene = get_scene(ep.scene_id)
        f = None
        for goal in ep.goals:
            h = scene._dijkstra(scene.world_to_cell(float(goal.position[0]), float(goal.position[-1])))
            f = h if f is None else np.minimum(f, h)
        si, sj = scene.world_to_cell(float(ep.start_position[0]), float(ep.start_position[-1]))
        d0.append(np.float32(max(float(f[si, sj]), 1e-6)))
        want.append(_pad_grid(f.astype(np.float32), n, np.inf))
    assert np.array_equal(bank.goal_field[0].cpu().numpy(), np.stack(want))
    assert np.array_equal(bank.d0[0].cpu().numpy(), np.asarray(d0, np.float32))
    assert torch.equal(bank.goal_field.cpu(), cpu.goal_field) and torch.equal(bank.d0.cpu(), cpu.d0)


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


# ---------------------------------------------------------------------------
# the closed loops on the card: one env step captured in a CUDA graph
# ---------------------------------------------------------------------------

_R2R_SMALL = [
    "MODEL.RGB_ENCODER.cnn_type", "TorchVisionResNet18", "MODEL.DEPTH_ENCODER.backbone", "resnet18",
    "MODEL.STATE_ENCODER.hidden_size", 64, "MODEL.INSTRUCTION_ENCODER.hidden_size", 32,
    "MODEL.INSTRUCTION_ENCODER.vocab_size", 64, "TASK_CONFIG.DATASET.TYPE", "Synthetic-VLN-v0",
    "TASK_CONFIG.DATASET.NUM_EPISODES", 6, "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", 12,
    "TASK_CONFIG.SIMULATOR.RGB_SENSOR.HEIGHT", 32, "TASK_CONFIG.SIMULATOR.RGB_SENSOR.WIDTH", 32,
    "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.HEIGHT", 32, "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.WIDTH", 32,
    "CUDA.PRECISION.compute_dtype", "float32", "NUM_ENVIRONMENTS", 3,
]


def _scan_case(dev, extra=()):
    """The small R2R CMA policy on `dev` with its head scaled so that the
    greedy action follows the observation, its config and 6 episodes."""
    from vlnce_torch.config import get_config
    from vlnce_torch.envs.spaces import action_space_from_config, observation_space_from_config
    from vlnce_torch.models.cma_policy import CMAPolicy
    from vlnce_torch.tasks.datasets import make_dataset

    cfg = get_config("vlnce_torch/config/experiments/r2r_baselines/cma_pm_da_aug_tune.yaml",
                     _R2R_SMALL + ["CUDA.DEVICE", str(dev), *extra])
    policy = CMAPolicy.from_config(cfg, observation_space_from_config(cfg.TASK_CONFIG), action_space_from_config(cfg.TASK_CONFIG))
    with torch.no_grad():
        policy.action_distribution.linear.weight.mul_(300.0)
        policy.action_distribution.linear.bias.copy_(torch.tensor([-0.5, 1.0, 0.5, 0.5]))
    return cfg, policy, list(make_dataset(cfg.TASK_CONFIG.DATASET.TYPE, cfg.TASK_CONFIG.DATASET).episodes)


@pytest.mark.cuda
@pytest.mark.parametrize("sample", [False, True])
def test_scan_segment_graph_matches_eager(sample):
    """The scan step replayed from its CUDA graph against the same step run
    eagerly (both through the kernels, TF32 off): greedy and sampled actions
    bit-equal (the uniforms are drawn per segment from one seeded generator
    outside the graph), states within 1e-5; one read-back per segment; two
    segments draw different uniforms."""
    from vlnce_torch.trainers.scan_eval import run_scan_rollouts

    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cfg, policy, episodes = _scan_case(dev, ["EVAL.SAMPLE", sample, "EVAL.SCAN_BATCH", 4, "EVAL.SCAN_SEGMENT", 5])
    runs = {}
    for eager in (False, True):
        stats = {}
        gen = torch.Generator(device=dev).manual_seed(7)
        runs[eager] = (run_scan_rollouts(policy, [], cfg, episodes, gen, stats=stats, eager=eager), stats)
    (graph_actions, g_stats), (eager_actions, e_stats) = runs[False], runs[True]
    assert g_stats["graph"] and not e_stats["graph"]
    assert g_stats["capture_launches"] == {"gru_sequence": 2, "fused_resize_normalize": 0}
    assert g_stats["readbacks"] == g_stats["segments"] == e_stats["segments"] >= 2
    assert [a.tolist() for a in graph_actions] == [a.tolist() for a in eager_actions]
    assert len({len(a) for a in graph_actions}) > 1 or any(len(a) > 1 for a in graph_actions)
    segment = next(s for k, s in policy.__dict__["_scan_segment_cache"].items() if k[0] == "eval" and not k[-1])
    first = segment.draws.clone()
    segment.run(torch.Generator(device=dev).manual_seed(8))
    assert sample == (not torch.equal(first, segment.draws))  # a sampled segment draws anew; a greedy one draws nothing


@pytest.mark.cuda
def test_dagger_segment_graph_matches_eager():
    """On-device collection at beta 0.5: the graph and the eager step give
    the same payloads from the same generator seed."""
    from vlnce_torch.trainers.device_dagger import collect_episodes_on_device

    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cfg, policy, episodes = _scan_case(dev, ["CUDA.DAGGER_SEGMENT", 4])
    out = {}
    for eager in (False, True):
        stats = {}
        out[eager] = collect_episodes_on_device(policy, [], cfg, episodes, 0.5, torch.Generator(device=dev).manual_seed(3),
                                                stats=stats, eager=eager)
        assert stats["graph"] == (not eager) and stats["readbacks"] == stats["segments"]
    assert len(out[False]) == len(out[True]) == 6
    for (obs, prev, oracle), (e_obs, e_prev, e_oracle) in zip(out[False], out[True]):
        np.testing.assert_array_equal(prev, e_prev)
        np.testing.assert_array_equal(oracle, e_oracle)
        for k in obs:
            np.testing.assert_allclose(obs[k], e_obs[k], rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.cuda
def test_device_sim_on_the_card_matches_the_cpu():
    """The renderer, the dynamics and the expert on the card against the same
    functions on the CPU (f32 both): frames within 1e-5 (RGB off by at most 1
    on under 0.5% of the pixels), poses within 1e-5, the expert equal."""
    import math

    from vlnce_torch.envs import device_sim as ds
    from vlnce_torch.envs.gridworld import get_scene

    dev = _card()
    scene_ids = [f"synth_scene_{k % 3}" for k in range(6)]
    rng = np.random.RandomState(4)
    poses = []
    for sid in scene_ids:
        occ = get_scene(sid).occupancy
        while True:
            x, z = rng.uniform(0.3, 15.7, 2)
            if not occ[int(x / 0.25), int(z / 0.25)]:
                poses.append([x, 0.0, z, rng.uniform(0, 2 * math.pi)])
                break
    poses = torch.from_numpy(np.asarray(poses, np.float32))
    grids = {k: torch.from_numpy(np.stack([getattr(get_scene(s), k) for s in scene_ids]))
             for k in ("occupancy", "wall_colors", "floor_color", "ceil_color")}
    specs = [ds.CameraSpec("rgb", 96, 128, 90.0, 0.0, "rgb"), ds.CameraSpec("depth", 96, 128, 90.0, 0.0, "depth")]
    tilt = torch.linspace(-0.5, 0.5, 6)
    out = {}
    for d in ("cpu", dev):
        g = {k: v.to(d) for k, v in grids.items()}
        p = poses.to(d)
        frames = ds.render_arrays(g["occupancy"], g["wall_colors"], g["floor_color"], g["ceil_color"], p[:, :3], p[:, 3], specs,
                                  tilt=tilt.to(d))
        actions = torch.tensor([1, 2, 3, 1, 1, 0], dtype=torch.int32, device=d)
        pos, heading = ds.step_discrete(g["occupancy"], p[:, :3], p[:, 3], actions, 0.25, math.radians(15.0), True)
        field = torch.from_numpy(np.stack([get_scene(s).distance_field((52, 52)).astype(np.float32) for s in scene_ids])).to(d)
        expert = ds.expert_action(g["occupancy"], field, torch.full((6, 2), 13.125, device=d), pos, heading, 0.5, math.radians(15.0))
        out[str(d)] = {k: v.cpu() for k, v in {**frames, "pos": pos, "heading": heading, "expert": expert}.items()}
    cpu, card = out["cpu"], out[str(dev)]
    np.testing.assert_allclose(card["depth"].numpy(), cpu["depth"].numpy(), rtol=0, atol=1e-5)
    diff = (card["rgb"].int() - cpu["rgb"].int()).abs()
    assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) < 0.005
    np.testing.assert_allclose(card["pos"].numpy(), cpu["pos"].numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(card["heading"].numpy(), cpu["heading"].numpy(), rtol=0, atol=1e-5)
    assert torch.equal(card["expert"], cpu["expert"])


# ---------------------------------------------------------------------------
# the device-resident training paths: DD-PPO's rollout and recollection's
# render, one step captured in a CUDA graph
# ---------------------------------------------------------------------------


def _rollout_case(dev, extra=()):
    """The synthetic waypoint config at 32x32 frames on `dev` in f32 (2
    slots, 4 steps, episodes of at most 3 waypoints; `extra` overrides),
    its policy with the stop head spread so that some steps STOP, and the
    obs transforms."""
    from vlnce_torch.config import get_config
    from vlnce_torch.config.default import add_pano_sensors_to_config
    from vlnce_torch.envs import spaces
    from vlnce_torch.models.waypoint_policy import WaypointPolicy
    from vlnce_torch.ops.obs_transforms import get_active_obs_transforms

    cfg = add_pano_sensors_to_config(get_config("vlnce_torch/config/experiments/synthetic/smoke_waypoint.yaml", [
        "CUDA.DEVICE", str(dev), "CUDA.PRECISION.compute_dtype", "float32", "NUM_ENVIRONMENTS", 2, "RL.PPO.num_steps", 4,
        "RL.PPO.num_mini_batch", 2, "TASK_CONFIG.DATASET.NUM_EPISODES", 6, "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", 3, *extra]))
    img = (32, 32)
    space = spaces.Dict({
        "rgb": spaces.Box(0, 255, (12,) + img + (3,), np.uint8), "depth": spaces.Box(0.0, 1.0, (12,) + img + (1,), np.float32),
        "rgb_history": spaces.Box(0, 255, img + (3,), np.uint8), "depth_history": spaces.Box(0.0, 1.0, img + (1,), np.float32),
        "instruction": spaces.Box(0, 2**31 - 1, (200,), np.int32), "angle_features": spaces.Box(-1.0, 1.0, (12, 4), np.float32),
    })
    policy = WaypointPolicy.from_config(cfg, space)
    with torch.no_grad():
        policy.net.stop_linear.weight.mul_(20.0)
        policy.net.stop_linear.bias.fill_(-1.0)
    return cfg, policy, get_active_obs_transforms(cfg)


@pytest.mark.cuda
def test_rollout_graph_matches_eager():
    """DD-PPO's rollout replayed from its two CUDA graphs (the step, the
    bootstrap) against the same steps run eagerly, both through B1's kernel
    (TF32 off): the same sampled actions from one generator seed, values,
    returns and advantages within 1e-5, over two rollouts; then a rollout's
    replays and update_device_scan's minibatch loop under
    set_sync_debug_mode("error")."""
    from vlnce_torch.rl.device_rollout import DeviceRolloutCollector
    from vlnce_torch.rl.ppo import WDDPPO

    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cfg, policy, transforms = _rollout_case(dev)
    runs = {}
    for eager in (False, True):
        c = DeviceRolloutCollector(policy, transforms, cfg, 2, eager=eager)
        c.initial_carry_and_obs()
        gen = torch.Generator(device=dev).manual_seed(5)
        runs[eager] = [{k: (v.clone() if not isinstance(v, dict) else {a: b.clone() for a, b in v.items()})
                        for k, v in c.collect_device(np.zeros((2, 1), np.float32), {}, gen)[0].items()} for _ in range(2)]
        assert (c._step.graph is None) == eager and c.readbacks == c.rollouts == 2 and c.replays == 8
        if not eager:
            graphed = c
            assert c.capture_launches["step"] == c.capture_launches["bootstrap"] == {"gru_sequence": 2,
                                                                                     "fused_resize_normalize": 0}
    panos = []
    for g, e in zip(runs[False], runs[True]):
        for k in g["actions"]:
            np.testing.assert_allclose(g["actions"][k].cpu().numpy(), e["actions"][k].cpu().numpy(), rtol=0, atol=1e-5, err_msg=k)
        assert torch.equal(g["actions"]["pano"], e["actions"]["pano"]) and torch.equal(g["masks"], e["masks"])
        for k in ("value_preds", "old_log_probs", "rewards", "returns", "advantages"):
            np.testing.assert_allclose(g[k].cpu().numpy(), e[k].cpu().numpy(), rtol=0, atol=1e-5, err_msg=k)
        panos.append(g["actions"]["pano"].cpu())
    assert len(torch.cat(panos).unique()) > 1

    agent = WDDPPO(policy, cfg.RL.PPO)
    T, rows, clip = agent._minibatch_plan(graphed._buffers, np.random.RandomState(0), 0)
    idx = torch.from_numpy(rows).to(dev)
    graphed.load_rollout()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        graphed.run_rollout(torch.Generator(device=dev).manual_seed(6))
        stats = agent.minibatch_loop(graphed._buffers, idx, clip, T)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(stats).all())


def _wpn_update_case(dev, exp, decay):
    """r2r_waypoint/<exp>.yaml at its widths (GN-ResNet50 depth, H=256, bf16
    encoders) with 32x32 frames, untrained token embeddings, 2 slots, T=4,
    2 x 2 minibatches of one env; `decay` switches linear LR and clip decay
    on over 12 updates. Returns (config, policy, a second policy with the
    same weights, the obs transforms)."""
    from vlnce_torch.config import get_config
    from vlnce_torch.config.default import add_pano_sensors_to_config
    from vlnce_torch.envs import spaces
    from vlnce_torch.models.waypoint_policy import WaypointPolicy
    from vlnce_torch.ops.obs_transforms import get_active_obs_transforms

    opts = ["CUDA.DEVICE", str(dev), "TASK_CONFIG.DATASET.TYPE", "Synthetic-VLN-v0", "TASK_CONFIG.DATASET.NUM_EPISODES", 6,
            "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", 3, "NUM_ENVIRONMENTS", 2, "RL.PPO.num_steps", 4,
            "RL.PPO.num_mini_batch", 2, "RL.PPO.ppo_epoch", 2, "RL.NUM_UPDATES", 12,
            "RL.PPO.use_linear_lr_decay", decay, "RL.PPO.use_linear_clip_decay", decay,
            "MODEL.INSTRUCTION_ENCODER.vocab_size", 64, "MODEL.INSTRUCTION_ENCODER.use_pretrained_embeddings", False,
            *(x for sensor in ("RGB", "DEPTH") for side in ("HEIGHT", "WIDTH")
              for x in (f"TASK_CONFIG.SIMULATOR.{sensor}_SENSOR.{side}", 32))]
    cfg = add_pano_sensors_to_config(get_config(f"vlnce_torch/config/experiments/r2r_waypoint/{exp}.yaml", opts))
    img = (32, 32)
    space = spaces.Dict({
        "rgb": spaces.Box(0, 255, (12,) + img + (3,), np.uint8), "depth": spaces.Box(0.0, 1.0, (12,) + img + (1,), np.float32),
        "rgb_history": spaces.Box(0, 255, img + (3,), np.uint8), "depth_history": spaces.Box(0.0, 1.0, img + (1,), np.float32),
        "instruction": spaces.Box(0, 2**31 - 1, (200,), np.int32), "angle_features": spaces.Box(-1.0, 1.0, (12, 4), np.float32),
    })
    policy, twin = WaypointPolicy.from_config(cfg, space), WaypointPolicy.from_config(cfg, space)
    with torch.no_grad():
        policy.net.stop_linear.weight.mul_(20.0)
        policy.net.stop_linear.bias.fill_(-1.0)
    twin.load_state_dict(policy.state_dict())
    return cfg, policy, twin, get_active_obs_transforms(cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("decay", [False, True], ids=["constant", "decay"])
@pytest.mark.parametrize("exp", ["1-wpn-cc", "3-wpn-dd"])
def test_ppo_step_graph_matches_eager(exp, decay, monkeypatch):
    """update_device_scan's captured minibatch step against the same steps
    run eagerly (`WDDPPO(..., eager=True)`), two agents on two copies of one
    policy over one rollout batch and the same minibatch permutations, TF32
    off: after every update each step's six stats, every parameter and
    every Adam moment within 1e-6 and each step count equal, with linear LR
    and clip decay off and on. They are equal bit for bit where cuDNN picks
    the same engines: it picks the weight gradient's engine of the 1x1
    convolution `net.inst_attn_k` by the tensors' alignment too, and the
    graph's pool places them apart from the eager allocations (at 3-wpn-dd
    with decay, its exp_avg differed by 4e-15 after the capture). The first update runs eagerly (no Adam state),
    the second captures at its first step (B1 2 forward, 2 backward, 2
    weight gradients in the graph) and replays, the third replays: one
    capture. An update with a StepClock stays eager; a replayed update's
    minibatch loop passes under set_sync_debug_mode("error"); after
    `optimizer.state.clear()` the next update is eager and the one after
    captures again, and after `optimizer.load_state_dict(...)` (a state
    saved earlier) the next update captures again. cuDNN is held to its
    deterministic algorithms here: its default weight gradient of the 1x1
    convolution `net.inst_attn_k` differs between two eager passes of one
    step (by 5e-13 at a scale of 6e-6), which no capture causes."""
    import copy

    from vlnce_torch.parallel.optim import trainable_parameters
    from vlnce_torch.rl.device_rollout import DeviceRolloutCollector
    from vlnce_torch.rl.ppo import WDDPPO
    from vlnce_torch.utils.profiling import StepClock

    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cfg, policy, twin, transforms = _wpn_update_case(dev, exp, decay)
    collector = DeviceRolloutCollector(policy, transforms, cfg, 2)
    collector.initial_carry_and_obs()
    batch = collector.collect_device(np.zeros((2, 1), np.float32), {}, torch.Generator(device=dev).manual_seed(3))[0]
    ppo = cfg.RL.PPO
    coefs = dict(offset_regularize_coef=ppo.offset_regularize_coef, pano_entropy_coef=ppo.pano_entropy_coef,
                 offset_entropy_coef=ppo.offset_entropy_coef, distance_entropy_coef=ppo.distance_entropy_coef,
                 num_updates=int(cfg.RL.NUM_UPDATES))
    graphed, eager = WDDPPO(policy, ppo, **coefs), WDDPPO(twin, ppo, eager=True, **coefs)
    K = ppo.ppo_epoch * ppo.num_mini_batch
    assert graphed.optimizer.param_groups[0]["capturable"] and torch.is_tensor(graphed.optimizer.param_groups[0]["lr"])
    logs = {id(graphed): [], id(eager): []}
    checked = []

    def recording(agent):
        loop = agent.minibatch_loop

        def run(*args, **kwargs):
            if checked:
                torch.cuda.set_sync_debug_mode("error")
            try:
                out = loop(*args, **kwargs)
                logs[id(agent)].append(out.clone())
            finally:
                torch.cuda.set_sync_debug_mode("default")
            return out

        agent.minibatch_loop = run

    recording(graphed)
    recording(eager)

    def near(a, b):
        return torch.equal(a, b) or float((a - b).abs().max()) <= 1e-6
    updates = [0]

    def update(clock=False, sync_checked=False):
        u = updates[0]
        checked[:] = [True] if sync_checked else []
        for agent in (graphed, eager):
            agent.update_device_scan(batch, np.random.RandomState(100 + u), update_idx=u,
                                     clock=StepClock(dev) if clock else None)
        checked.clear()
        updates[0] += 1
        assert near(logs[id(graphed)][-1], logs[id(eager)][-1]), f"update {u}: the steps' stats differ"
        assert bool(torch.isfinite(logs[id(graphed)][-1]).all())
        for (name, p), q in zip(policy.named_parameters(), twin.parameters()):
            assert near(p, q), f"update {u}: {name} differs"
        params = trainable_parameters(graphed.optimizer)
        assert len(graphed.optimizer.state) == len(params) > 40
        names = {p: name for name, p in policy.named_parameters()}
        for p, q in zip(params, trainable_parameters(eager.optimizer)):
            a, b = graphed.optimizer.state[p], eager.optimizer.state[q]
            assert torch.equal(a["step"], b["step"]), f"update {u}: Adam's step count of {names[p]}"
            for k in ("exp_avg", "exp_avg_sq"):
                assert near(a[k], b[k]), f"update {u}: Adam's {k} of {names[p]}"

    update()
    assert graphed.captures == graphed.replayed_steps == 0
    saved = copy.deepcopy(graphed.optimizer.state_dict()), copy.deepcopy(eager.optimizer.state_dict())
    update()
    assert graphed.captures == 1 and graphed.replayed_steps == K
    assert graphed.capture_launches == {"gru_sequence": 2, "gru_sequence_backward": 2, "gru_weight_gradient": 2,
                                        "fused_resize_normalize": 0}, graphed.capture_launches
    update()
    assert graphed.captures == 1 and graphed.replayed_steps == 2 * K
    update(clock=True)
    assert graphed.captures == 1 and graphed.replayed_steps == 2 * K
    update(sync_checked=True)
    assert graphed.captures == 1 and graphed.replayed_steps == 3 * K
    for agent in (graphed, eager):
        agent.optimizer.state.clear()
    update()
    assert graphed.captures == 1 and graphed.replayed_steps == 3 * K
    update()
    assert graphed.captures == 2 and graphed.replayed_steps == 4 * K
    for agent, state in zip((graphed, eager), saved):
        agent.optimizer.load_state_dict(state)
    update()
    assert graphed.captures == 3 and graphed.replayed_steps == 5 * K and len(graphed._graphs) == 2
    assert eager.captures == eager.replayed_steps == 0
    assert graphed.minibatch_steps == graphed.optimizer_steps == eager.optimizer_steps == updates[0] * K
    rate = float(graphed.optimizer.param_groups[0]["lr"])
    assert rate == float(eager.optimizer.param_groups[0]["lr"])
    assert rate < 0.9 * ppo.lr if decay else rate == pytest.approx(ppo.lr, rel=1e-6)


@pytest.mark.cuda
def test_rollout_graphs_per_grid_size_match_eager(tmp_path, monkeypatch):
    """DD-PPO's rollout over the synthetic split's four scenes imported as
    lattice exports of three grid sizes, from per-rollout queues
    (CUDA.EPISODE_BANK_MAX 2), one slot, T=2, episodes of at most 2 steps:
    each queue pads to its own largest grid, so the first rollout (scenes
    0, 1, 2) and the later ones (scene 3 among them) run on two pairs of
    graphs, captured per size; the graphed rollouts against the same run
    eagerly, as test_rollout_graph_matches_eager holds them."""
    from vlnce_torch.envs import device_sim, gridworld
    from vlnce_torch.envs.scene_import import ImportedScene, save_scene_geometry, scene_from_graph
    from vlnce_torch.rl.device_rollout import DeviceRolloutCollector
    from vlnce_torch.utils.nav_graph import LatticeGraph

    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    monkeypatch.setattr(gridworld, "_SCENE_PROVIDERS", list(gridworld._SCENE_PROVIDERS))
    monkeypatch.setattr(gridworld, "_REGISTERED_SCENES", dict(gridworld._REGISTERED_SCENES))
    monkeypatch.setattr(device_sim, "_NEAREST_FREE_CACHE", {})  # the procedural scenes' maps, by the same ids
    for k, size in enumerate((20.0, 24.0, 20.0, 28.0)):
        stem = f"synth_scene_{k}"
        save_scene_geometry(str(tmp_path / f"{stem}.npz"), scene_from_graph(stem, LatticeGraph(-2.0, -2.0, size, size, 1.0)))
    cfg, policy, transforms = _rollout_case(dev, [
        "NUM_ENVIRONMENTS", 1, "RL.PPO.num_steps", 2, "TASK_CONFIG.DATASET.NUM_EPISODES", 8,
        "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", 2, "CUDA.EPISODE_BANK_MAX", 2,
        "TASK_CONFIG.SIMULATOR.GEOMETRY_DIR", str(tmp_path)])
    runs = {}
    for eager in (False, True):
        c = DeviceRolloutCollector(policy, transforms, cfg, 1, eager=eager)
        c.initial_carry_and_obs()
        gen = torch.Generator(device=dev).manual_seed(5)
        runs[eager] = [{k: (v.clone() if not isinstance(v, dict) else {a: b.clone() for a, b in v.items()})
                        for k, v in c.collect_device(np.zeros((1, 1), np.float32), {}, gen)[0].items()} for _ in range(3)]
        assert c._bank_episodes is None and c.builds == len(c._graphs) == 2 and c.replays == 6
        assert all((step.graph is None) == eager and (boot.graph is None) == eager for _, step, boot in c._graphs.values())
    for k in range(4):
        scene = gridworld.get_scene(f"synthetic/synth_scene_{k}.glb")
        assert isinstance(scene, ImportedScene) and scene.origin != (0.0, 0.0)
    for g, e in zip(runs[False], runs[True]):
        for k in g["actions"]:
            np.testing.assert_allclose(g["actions"][k].cpu().numpy(), e["actions"][k].cpu().numpy(), rtol=0, atol=1e-5, err_msg=k)
        assert torch.equal(g["actions"]["pano"], e["actions"]["pano"]) and torch.equal(g["masks"], e["masks"])
        for k in ("value_preds", "old_log_probs", "rewards", "returns", "advantages"):
            np.testing.assert_allclose(g[k].cpu().numpy(), e[k].cpu().numpy(), rtol=0, atol=1e-5, err_msg=k)


_RXR_SMALL = [
    "MODEL.RGB_ENCODER.cnn_type", "TorchVisionResNet18", "MODEL.DEPTH_ENCODER.backbone", "resnet18",
    "MODEL.STATE_ENCODER.hidden_size", 64, "MODEL.INSTRUCTION_ENCODER.hidden_size", 32,
    "RL.POLICY.OBS_TRANSFORMS.RESIZE_SHORTEST_EDGE.SIZE", 32,
    "RL.POLICY.OBS_TRANSFORMS.CENTER_CROPPER_PER_SENSOR.SENSOR_CROPS", [["rgb", [32, 32]], ["depth", [32, 32]]],
    "TASK_CONFIG.SIMULATOR.RGB_SENSOR.HEIGHT", 48, "TASK_CONFIG.SIMULATOR.RGB_SENSOR.WIDTH", 64,
    "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.HEIGHT", 48, "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.WIDTH", 64,
    "TASK_CONFIG.TASK.RXR_INSTRUCTION_SENSOR.feature_dim", 32, "TASK_CONFIG.TASK.RXR_INSTRUCTION_SENSOR.max_text_len", 16,
    "TASK_CONFIG.DATASET.TYPE", "Synthetic-VLN-v0", "TASK_CONFIG.DATASET.NUM_EPISODES", 4,
    "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", 12, "CUDA.PRECISION.compute_dtype", "float32",
]


@pytest.mark.cuda
def test_resident_render_graph_matches_eager(tmp_path):
    """Recollection's resident render (the RxR transforms, B2 twice, inside
    the captured step) against the same steps run eagerly through the
    kernels: the batch equal (f32 within 1e-6), a second batch of the same
    shape through the cached graph."""
    from vlnce_torch.config import get_config
    from vlnce_torch.data.recollection import TeacherRecollectionDataset
    from vlnce_torch.ops.obs_transforms import get_active_obs_transforms
    from vlnce_torch.tasks.datasets import make_dataset
    from vlnce_torch.trainers.device_recollect import render_gt_batch_resident

    dev = _card()
    cfg = get_config("vlnce_torch/config/experiments/rxr_baselines/rxr_cma_en.yaml", _RXR_SMALL + [
        "CUDA.DEVICE", str(dev), "IL.RECOLLECT_TRAINER.trajectories_file", str(tmp_path / "trajectories.json.gz"),
        "IL.RECOLLECT_TRAINER.gt_file", str(tmp_path / "missing_{split}_{role}.json.gz")])
    dataset = TeacherRecollectionDataset.__new__(TeacherRecollectionDataset)
    dataset.config = cfg
    trajectories = dataset.collect_dataset()
    episodes = list(make_dataset(cfg.TASK_CONFIG.DATASET.TYPE, cfg.TASK_CONFIG.DATASET).episodes)
    transforms = get_active_obs_transforms(cfg)
    cache = {}
    for group in (episodes[:2], episodes[2:]):
        got = render_gt_batch_resident(cfg, group, trajectories, 1.0, "rxr_instruction", transforms=transforms, cache=cache)
        ref = render_gt_batch_resident(cfg, group, trajectories, 1.0, "rxr_instruction", transforms=transforms, eager=True)
        for k, v in got[0].items():
            assert v.device.type == "cuda" and v.dtype == ref[0][k].dtype, k
            np.testing.assert_allclose(v.float().cpu().numpy(), ref[0][k].float().cpu().numpy(), rtol=0, atol=1e-6, err_msg=k)
        for a, b in zip(got[1:], ref[1:]):
            np.testing.assert_array_equal(a, b)
    steps = [s.step for s in cache.values()]
    assert steps and all(s.graph is not None and s.capture_launches == {"gru_sequence": 0, "fused_resize_normalize": 2}
                         for s in steps)


# ---------------------------------------------------------------------------
# the trajectory bank on the card and the feature-bank route
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_resident_collection_packs_the_store_payloads_on_the_card():
    """collect_episodes_resident on the card (graph) against the same
    collection run eagerly and against the store-wired payloads of the same
    draws: the bank's rows equal (f16 features within 1e-5 of each other,
    the rows of the store payload exactly), and its gathers on the card
    equal the same bank's gathers on the CPU."""
    from vlnce_torch.data.device_bank import DeviceTrajectoryBank
    from vlnce_torch.trainers.device_dagger import collect_episodes_on_device, collect_episodes_resident

    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cfg, policy, episodes = _scan_case(dev, ["CUDA.DAGGER_SEGMENT", 4])
    banks = {}
    for eager in (False, True):
        stats = {}
        banks[eager] = collect_episodes_resident(policy, [], cfg, episodes, 0.5, torch.Generator(device=dev).manual_seed(3),
                                                 stats=stats, eager=eager)
        assert stats["graph"] == (not eager) and stats["chunk_readbacks"] == 0 and stats["readbacks"] == stats["segments"]
    wired = collect_episodes_on_device(policy, [], cfg, episodes, 0.5, torch.Generator(device=dev).manual_seed(3))
    bank, eager_bank = banks[False], banks[True]
    np.testing.assert_array_equal(bank.lengths, eager_bank.lengths)
    assert bank.device.type == "cuda" and len(bank) == len(wired) == 6
    for e, (obs, prev, oracle) in enumerate(wired):
        lo, T = int(bank.offsets[e]), int(bank.lengths[e])
        np.testing.assert_array_equal(bank.prev[lo : lo + T].cpu().numpy(), prev)
        np.testing.assert_array_equal(bank.oracle[lo : lo + T].cpu().numpy(), oracle)
        for k, shape in bank.feat_shapes.items():
            rows = bank.data[k][lo : lo + T].float().cpu().numpy().reshape((T,) + shape)
            np.testing.assert_array_equal(rows, obs[k].astype(np.float32), err_msg=k)
            np.testing.assert_allclose(rows, eager_bank.data[k][lo : lo + T].float().cpu().numpy().reshape(rows.shape),
                                       rtol=0, atol=1e-5, err_msg=k)
    host = DeviceTrajectoryBank({k: v.cpu() for k, v in bank.data.items()}, bank.prev.cpu(), bank.oracle.cpu(),
                                bank.instruction.cpu(), bank.offsets, bank.lengths, bank.feat_shapes, bank.trash_index)
    for ids in ([0, 3], [5, 1, 2]):
        for time_major in (False, True):
            got, want = bank.gather_batch(ids, 3.2, time_major=time_major), host.gather_batch(ids, 3.2, time_major=time_major)
            for k in got[0]:
                assert torch.equal(got[0][k].cpu(), want[0][k]), k
            for a, b in zip(got[1:], want[1:]):
                assert a.device.type == "cuda" and torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_enqueued_epoch_waits_for_the_card_only_at_its_read_backs():
    """run_fused_epoch over a bank on the card with the enqueue under
    set_sync_debug_mode("error"): one read-back per run, and the losses and
    parameters of the per-batch path from the same start (TF32 off): losses
    within 1e-5; parameters within 1e-5 of their scale where Adam's second
    moment is above 1e-12, and within 2 x lr x steps elsewhere (a gradient
    that is zero by the formula, such as the attention keys' bias, is noise
    on the card, and Adam scales noise to steps of lr), as
    tests/test_torch_ppo.py holds them."""
    from vlnce_torch.data.device_bank import DeviceTrajectoryBank, ResidentBatchIterator, run_fused_epoch
    from vlnce_torch.parallel.il_step import build_il_train_step
    from vlnce_torch.parallel.optim import masked_adam
    from vlnce_torch.trainers.device_dagger import collect_episodes_resident

    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cfg, policy, episodes = _scan_case(dev, ["CUDA.DAGGER_SEGMENT", 4])
    bank = collect_episodes_resident(policy, [], cfg, episodes, 1.0)
    start = {k: v.clone() for k, v in policy.state_dict().items()}
    results = {}
    for mode in ("per_batch", "enqueued"):
        policy.load_state_dict(start)
        optimizer = masked_adam(1e-3, policy, cfg.MODEL)
        step = build_il_train_step(policy, optimizer)
        riter = ResidentBatchIterator(bank, batch_size=2, seed=5, time_major=True)
        if mode == "per_batch":
            losses = [torch.stack(step(*batch)).tolist() for batch in riter]
        else:
            enqueue, runs = DeviceTrajectoryBank.enqueue_steps, []

            def checked(self, step, idx, *args):
                runs.append(idx.shape[0])
                torch.cuda.set_sync_debug_mode("error")
                try:
                    return enqueue(self, step, idx, *args)
                finally:
                    torch.cuda.set_sync_debug_mode(0)

            DeviceTrajectoryBank.enqueue_steps = checked
            try:
                losses = run_fused_epoch(riter, step)
            finally:
                DeviceTrajectoryBank.enqueue_steps = enqueue
            assert sum(runs) == len(losses) == 3 and len(runs) >= 1
        moments = {name: optimizer.state[p]["exp_avg_sq"] for name, p in policy.named_parameters() if p in optimizer.state}
        results[mode] = (np.asarray(losses), {k: v.clone() for k, v in policy.state_dict().items()}, moments)
    np.testing.assert_allclose(results["enqueued"][0], results["per_batch"][0], rtol=1e-5)
    moments = results["per_batch"][2]
    assert moments
    for k, v in results["enqueued"][1].items():
        ref = results["per_batch"][1][k]
        if k not in moments:  # frozen: untouched
            assert torch.equal(v, ref) and torch.equal(v, start[k]), k
            continue
        diff = (v - ref).abs()
        real = moments[k] > 1e-12
        assert float((diff * real).max()) <= 1e-5 + 1e-5 * float(ref.abs().max()), k
        assert float(diff.max()) <= 2 * 1e-3 * 3, k
    policy.load_state_dict(start)


@pytest.mark.cuda
def test_feature_bank_route_graph_matches_eager(tmp_path):
    """Banks of the episodes' scenes written by encode_scene_bank on the
    card, then the scan eval and the DAgger collection with
    CUDA.FEATURE_BANK_DIR: the lookup inside the captured step gives the
    eager step's actions and payloads; the lookup on the card equals the
    CPU's."""
    from vlnce_torch.data import feature_bank
    from vlnce_torch.envs.device_sim import camera_specs_from_config
    from vlnce_torch.envs.gridworld import get_scene
    from vlnce_torch.trainers.device_dagger import collect_episodes_on_device
    from vlnce_torch.trainers.scan_eval import run_scan_rollouts

    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    bank_opts = ["CUDA.FEATURE_BANK_DIR", str(tmp_path), "CUDA.FEATURE_BANK_MAX_DIST", 2.2, "CUDA.DAGGER_SEGMENT", 4,
                 "EVAL.SCAN_BATCH", 4, "EVAL.SCAN_SEGMENT", 5]
    cfg, policy, episodes = _scan_case(dev, bank_opts)
    headings = (2.0 * np.pi / 8) * np.arange(8, dtype=np.float32)
    for scene_id in sorted({ep.scene_id for ep in episodes}):
        scene = get_scene(scene_id)
        nodes = feature_bank.lattice_nodes(scene, 3.0)
        out = feature_bank.encode_scene_bank(policy, [], camera_specs_from_config(cfg.TASK_CONFIG.SIMULATOR), scene, nodes,
                                             headings, chunk=64)
        feature_bank.save_scene_bank(str(tmp_path / f"{feature_bank._scene_key(scene_id)}.npz"), nodes, *out)
    actions = {eager: run_scan_rollouts(policy, [], cfg, episodes, eager=eager) for eager in (False, True)}
    assert [a.tolist() for a in actions[False]] == [a.tolist() for a in actions[True]]
    payloads = {eager: collect_episodes_on_device(policy, [], cfg, episodes, 0.5, torch.Generator(device=dev).manual_seed(3),
                                                  eager=eager) for eager in (False, True)}
    for (obs, prev, oracle), (e_obs, e_prev, e_oracle) in zip(payloads[False], payloads[True]):
        np.testing.assert_array_equal(prev, e_prev)
        np.testing.assert_array_equal(oracle, e_oracle)
        for k in ("rgb_features", "depth_features"):
            np.testing.assert_array_equal(obs[k], e_obs[k], err_msg=k)  # looked up, not computed: exact
    bank = feature_bank.load_bank_batch(str(tmp_path), episodes[:4], device=dev)
    host = feature_bank.load_bank_batch(str(tmp_path), episodes[:4])
    pos = torch.tensor([[1.3, 0.0, 2.9], [7.5, 0.0, 3.1], [40.0, 0.0, 1.0], [4.4, 0.0, 9.9]])
    heading = torch.tensor([0.3, -2.0, 4.0, 7.9])
    got = feature_bank.lookup_features(bank, pos.to(dev), heading.to(dev), max_dist=2.2)
    want = feature_bank.lookup_features(host, pos, heading, max_dist=2.2)
    for k in got:
        assert torch.equal(got[k].cpu(), want[k]), k


# ---------------------------------------------------------------------------
# imported scene geometry on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_imported_scene_scan_step_graph_matches_eager_plain(tmp_path, monkeypatch):
    """Scan eval over two imported scenes (lattice exports in frames away
    from the origin, of two grid sizes: one chunk and one graph each) with
    the resize transform on, so that B1 and B2 both run in the step: the
    step captured in a CUDA graph through the kernels against the same step
    run eagerly with their plain versions (TF32 off), the same greedy
    actions; every scene run is an ImportedScene."""
    import vlnce_torch.models.rnn_state_encoder as rse
    import vlnce_torch.ops.obs_transforms as ot
    from vlnce_torch.config import get_config
    from vlnce_torch.envs import gridworld
    from vlnce_torch.envs.spaces import action_space_from_config, observation_space_from_config
    from vlnce_torch.models.cma_policy import CMAPolicy
    from vlnce_torch.envs.scene_import import ImportedScene, apply_scene_geometry, save_scene_geometry, scene_from_graph
    from vlnce_torch.ops.obs_transforms import apply_obs_transforms_obs_space, get_active_obs_transforms
    from vlnce_torch.tasks.episodes import InstructionData, NavigationGoal, VLNEpisode
    from vlnce_torch.tasks.geometry import quat_from_heading
    from vlnce_torch.trainers.scan_eval import run_scan_rollouts
    from vlnce_torch.utils.nav_graph import LatticeGraph

    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    monkeypatch.setattr(gridworld, "_SCENE_PROVIDERS", list(gridworld._SCENE_PROVIDERS))
    monkeypatch.setattr(gridworld, "_REGISTERED_SCENES", dict(gridworld._REGISTERED_SCENES))
    boxes = {"imported/lattice_a.glb": (-21.0, 13.0, 16.0, 16.0), "imported/lattice_b.glb": (7.0, -31.0, 24.0, 24.0)}
    episodes, rng = [], np.random.RandomState(0)
    for scene_id, box in boxes.items():
        graph = LatticeGraph(*box)
        stem = scene_id.split("/")[-1][:-4]
        save_scene_geometry(str(tmp_path / f"{stem}.npz"), scene_from_graph(stem, graph))
        nodes = [np.asarray(d["position"]) for d in graph.nodes.values()]
        for i in range(4):
            a, b = rng.choice(len(nodes), 2, replace=False)
            episodes.append(VLNEpisode(
                episode_id=f"{stem}_{i}", trajectory_id=str(i), scene_id=scene_id,
                start_position=[float(x) for x in nodes[a]],
                start_rotation=[float(x) for x in quat_from_heading(rng.uniform(0, 2 * np.pi))],
                instruction=InstructionData(instruction_text="walk", instruction_tokens=[2, 6, 9, 3]),
                goals=[NavigationGoal(position=[float(x) for x in nodes[b]], radius=3.0)],
                reference_path=[[float(x) for x in nodes[a]], [float(x) for x in nodes[b]]]))
    cfg = get_config("vlnce_torch/config/experiments/r2r_baselines/cma_pm_da_aug_tune.yaml", _R2R_SMALL + [
        "CUDA.DEVICE", str(dev), "TASK_CONFIG.SIMULATOR.GEOMETRY_DIR", str(tmp_path), "EVAL.SCAN_BATCH", 4,
        "EVAL.SCAN_SEGMENT", 6, "RL.POLICY.OBS_TRANSFORMS.ENABLED_TRANSFORMS", ["ResizeShortestEdge"],
        "RL.POLICY.OBS_TRANSFORMS.RESIZE_SHORTEST_EDGE.SIZE", 24])
    transforms = get_active_obs_transforms(cfg)
    space = apply_obs_transforms_obs_space(observation_space_from_config(cfg.TASK_CONFIG), transforms)
    policy = CMAPolicy.from_config(cfg, space, action_space_from_config(cfg.TASK_CONFIG))
    with torch.no_grad():
        policy.action_distribution.linear.weight.mul_(300.0)
        policy.action_distribution.linear.bias.copy_(torch.tensor([-0.5, 1.0, 0.5, 0.5]))
    assert len(transforms) == 1
    apply_scene_geometry(cfg.TASK_CONFIG.SIMULATOR)
    stats, actions = {}, {}
    actions["graph"] = run_scan_rollouts(policy, transforms, cfg, episodes, stats=stats)
    monkeypatch.setattr(rse, "gru_sequence", gru_sequence_plain)
    monkeypatch.setattr(ot, "fused_resize_normalize", fused_resize_normalize_plain)
    actions["plain"] = run_scan_rollouts(policy, transforms, cfg, episodes, eager=True)
    assert stats["graph"] and stats["captures"] == 2
    assert stats["capture_launches"] == {"gru_sequence": 2, "fused_resize_normalize": 2}
    assert [a.tolist() for a in actions["graph"]] == [a.tolist() for a in actions["plain"]]
    assert any(len(a) > 1 for a in actions["graph"])
    for scene_id in boxes:
        scene = gridworld.get_scene(scene_id)
        assert isinstance(scene, ImportedScene) and scene.origin != (0.0, 0.0)
