"""Masked GRU (kernel B1) of the PyTorch port against the JAX package.

On CPU tensors the port's `gru_sequence` runs its plain PyTorch version; the
JAX side runs the Pallas kernel in interpret mode, as tests/test_pallas_rnn.py
does. Tolerance: atol 1e-5 in f32, the same as that file (the two differ only
in summation order). The gradient (`gru_sequence_backward_plain`, the explicit
formula the backward kernel implements) is held against torch autograd
through the plain loop and against `jax.vjp` of the JAX RNNStateEncoder's
GRU scan, at the same tolerance, both recomputing the gates and reading
those the forward saved; so is the weight gradient taken over all steps at
once (`gru_weight_gradient_plain`, d_w_hh held relative to its scale).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vlnce_tpu.models.rnn_state_encoder import RNNStateEncoder as JaxRNNStateEncoder
from vlnce_tpu.ops.pallas_rnn import gru_sequence as jax_gru_sequence
from vlnce_torch.models.rnn_state_encoder import RNNStateEncoder
from vlnce_torch.ops.rnn import (gru_sequence, gru_sequence_backward, gru_sequence_backward_plain, gru_sequence_plain,
                                 gru_weight_gradient, gru_weight_gradient_plain)

ATOL = 1e-5


def _inputs(seed, T, B, H, h0_scale=1.0):
    rng = np.random.RandomState(seed)
    xi = rng.randn(T, B, 3 * H).astype(np.float32)
    w_hh = (rng.randn(3 * H, H) * 0.05).astype(np.float32)
    b_hh = (rng.randn(3 * H) * 0.05).astype(np.float32)
    h0 = (rng.randn(B, H) * h0_scale).astype(np.float32)
    masks = np.ones((T, B, 1), np.float32)
    return xi, masks, h0, w_hh, b_hh


@pytest.mark.parametrize(
    "case", ["reset_mid_sequence", "nonzero_h0", "single_step"],
)
def test_plain_gru_sequence_matches_pallas(case):
    T, B, H = {"reset_mid_sequence": (7, 4, 128), "nonzero_h0": (3, 2, 128), "single_step": (1, 5, 64)}[case]
    xi, masks, h0, w_hh, b_hh = _inputs(len(case), T, B, H)
    if case == "reset_mid_sequence":
        masks[3] = 0.0
        masks[5, 1] = 0.0
    if case == "single_step":
        masks[0, ::2] = 0.0
    ref = jax_gru_sequence(*(jnp.asarray(a) for a in (xi, masks, h0, w_hh, b_hh)), interpret=True)
    out = gru_sequence(*(torch.from_numpy(a) for a in (xi, masks, h0, w_hh, b_hh)))
    assert out.dtype == torch.float32 and tuple(out.shape) == (T, B, H)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    if case == "nonzero_h0":
        zero = gru_sequence_plain(*(torch.from_numpy(a) for a in (xi, masks, np.zeros_like(h0), w_hh, b_hh)))
        assert float((out[0] - zero[0]).abs().max()) > 1e-3  # step 0 consumed h0


@pytest.mark.parametrize("T", [1, 6])
def test_gru_sequence_takes_strided_h0(T):
    """h0 handed over as `states[:, 0]` of a [B, 2, H] recurrent state, rows
    2H apart, as the CMA policy does: no copy is needed first."""
    B, H = 4, 64
    xi, masks, h0, w_hh, b_hh = _inputs(11 + T, T, B, H)
    masks[T // 2, 1] = 0.0
    states = torch.from_numpy(np.stack([h0, np.full_like(h0, np.nan)], axis=1))
    strided = states[:, 0]
    assert not strided.is_contiguous() and strided.stride() == (2 * H, 1)
    ref = jax_gru_sequence(*(jnp.asarray(a) for a in (xi, masks, h0, w_hh, b_hh)), interpret=True)
    out = gru_sequence(torch.from_numpy(xi), torch.from_numpy(masks), strided, torch.from_numpy(w_hh), torch.from_numpy(b_hh))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_cma_state_slices_reach_the_gru_uncopied(monkeypatch):
    """RNNStateEncoder passes `states[:, 0]` of the policy's packed state to
    gru_sequence as a view of the same storage."""
    import vlnce_torch.models.rnn_state_encoder as rse

    seen = {}

    def spy(xi, masks, h0, w_hh, b_hh):
        seen["h0"] = h0
        return gru_sequence(xi, masks, h0, w_hh, b_hh)

    monkeypatch.setattr(rse, "gru_sequence", spy)
    enc = RNNStateEncoder(8, 16, "GRU")
    rnn_states = torch.randn(3, 2, 16)
    with torch.no_grad():
        enc(torch.randn(3, 8), rnn_states[:, :1], torch.ones(3, 1))
    assert seen["h0"].data_ptr() == rnn_states.data_ptr() and seen["h0"].stride() == (32, 1)


def _encoders(D, H, seed=0):
    jax_enc = JaxRNNStateEncoder(input_size=D, hidden_size=H, rnn_type="GRU")
    params = jax_enc.init(jax.random.PRNGKey(seed), jnp.zeros((1, D)), jax_enc.initial_state(1), jnp.ones((1, 1)))["params"]
    rng = np.random.RandomState(seed)
    params = {"cell": {k: np.array(v) + (0.1 * rng.randn(*v.shape)).astype(np.float32) if "bias" in k else np.array(v)
                       for k, v in params["cell"].items()}}
    enc = RNNStateEncoder(D, H, "GRU")
    enc.load_state_dict({f"rnn.{k}_l0": torch.from_numpy(v) for k, v in params["cell"].items()}, strict=True)
    return jax_enc, params, enc


@pytest.mark.parametrize("mode", ["single_step", "sequence"])
def test_rnn_state_encoder_gru_matches_jax(mode):
    D, H, B, T = 24, 32, 4, 6
    jax_enc, params, enc = _encoders(D, H)
    rng = np.random.RandomState(1)
    states = rng.randn(B, 1, H).astype(np.float32)
    if mode == "single_step":
        x = rng.randn(B, D).astype(np.float32)
        masks = np.array([[1.0], [0.0], [1.0], [0.0]], np.float32)
    else:
        x = rng.randn(T, B, D).astype(np.float32)
        masks = np.ones((T, B, 1), np.float32)
        masks[2, 1:3] = 0.0
    ref_out, ref_states = jax_enc.apply({"params": params}, jnp.asarray(x), jnp.asarray(states), jnp.asarray(masks))
    with torch.no_grad():
        out, new_states = enc(torch.from_numpy(x), torch.from_numpy(states), torch.from_numpy(masks))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=ATOL)
    np.testing.assert_allclose(new_states.numpy(), np.asarray(ref_states), atol=ATOL)



def _backward_case(T, seed=3):
    """Inputs with a reset in the middle of the sequence, h0 as the strided
    `states[:, 0]` of a [B, 2, H] state, and a gradient for every output."""
    B, H = 4, 32
    xi, masks, h0, w_hh, b_hh = _inputs(seed + T, T, B, H)
    masks[T // 2, 1::2] = 0.0
    d_out = np.random.RandomState(seed).randn(T, B, H).astype(np.float32)
    return d_out, xi, masks, h0, w_hh, b_hh


@pytest.mark.parametrize("T", [1, 3, 16])
def test_plain_gru_backward_matches_autograd(T):
    d_out, xi, masks, h0, w_hh, b_hh = _backward_case(T)
    states = torch.from_numpy(np.stack([h0, np.zeros_like(h0)], axis=1)).requires_grad_()
    xi_t, w_t, b_t = (torch.from_numpy(a).requires_grad_() for a in (xi, w_hh, b_hh))
    out = gru_sequence(xi_t, torch.from_numpy(masks), states[:, 0], w_t, b_t)  # the plain loop under autograd
    out.backward(torch.from_numpy(d_out))
    with torch.no_grad():
        got = gru_sequence_backward(torch.from_numpy(d_out), xi_t, torch.from_numpy(masks), states[:, 0], w_t, b_t, out)
    assert tuple(got[1].shape) == h0.shape
    for name, a, b in zip(("d_xi", "d_h0", "d_w_hh", "d_b_hh"), got, (xi_t.grad, states.grad[:, 0], w_t.grad, b_t.grad)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL, err_msg=name)
    assert float(states.grad[:, 1].abs().max()) == 0.0


def _jax_gradients(d_out, xi, masks, h0, w_hh, b_hh):
    """jax.vjp of the JAX encoder's GRU scan with an identity input
    projection (x is xi), so that the cotangent of x is d_xi: (d_xi, d_h0,
    d_w_hh, d_b_hh)."""
    B, H = h0.shape
    jax_enc = JaxRNNStateEncoder(input_size=3 * H, hidden_size=H, rnn_type="GRU")
    params = {"cell": {"weight_ih": jnp.eye(3 * H), "bias_ih": jnp.zeros(3 * H), "weight_hh": jnp.asarray(w_hh), "bias_hh": jnp.asarray(b_hh)}}

    def outputs(params, x, states):
        return jax_enc.apply({"params": params}, x, states, jnp.asarray(masks))[0]

    _, vjp = jax.vjp(outputs, params, jnp.asarray(xi), jnp.asarray(h0)[:, None, :])
    d_params, d_x, d_states = vjp(jnp.asarray(d_out))
    return d_x, d_states[:, 0], d_params["cell"]["weight_hh"], d_params["cell"]["bias_hh"]


def _strided_args(xi, masks, h0, w_hh, b_hh):
    """The plain functions' inputs with h0 as the strided `states[:, 0]`."""
    states = torch.from_numpy(np.stack([h0, np.full_like(h0, np.nan)], axis=1))
    return [torch.from_numpy(a) for a in (xi, masks)] + [states[:, 0]] + [torch.from_numpy(a) for a in (w_hh, b_hh)]


@pytest.mark.parametrize("T", [1, 3, 16])
def test_plain_gru_backward_matches_jax_vjp(T):
    d_out, xi, masks, h0, w_hh, b_hh = _backward_case(T)
    ref = _jax_gradients(d_out, xi, masks, h0, w_hh, b_hh)
    args = _strided_args(xi, masks, h0, w_hh, b_hh)
    out = gru_sequence_plain(*args)
    got = gru_sequence_backward_plain(torch.from_numpy(d_out), *args, out)
    for name, a, b in zip(("d_xi", "d_h0", "d_w_hh", "d_b_hh"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, err_msg=name)


@pytest.mark.parametrize("T", [1, 3, 16])
def test_saved_gates_rebuild_the_pallas_outputs(T):
    """r, z, n and hh_n as the training forward saves them give back the
    Pallas kernel's outputs, and n is tanh(xi_n + r * hh_n)."""
    _, xi, masks, h0, w_hh, b_hh = _backward_case(T)
    ref = np.asarray(jax_gru_sequence(*(jnp.asarray(a) for a in (xi, masks, h0, w_hh, b_hh)), interpret=True))
    args = _strided_args(xi, masks, h0, w_hh, b_hh)
    out, gates = gru_sequence_plain(*args, return_gates=True)
    assert tuple(gates.shape) == (T, h0.shape[0], 4 * h0.shape[1]) and torch.equal(out, gru_sequence_plain(*args))
    H = h0.shape[1]
    r, z, n, hh_n = gates.split(H, dim=2)
    h_prev = torch.cat([args[2][None], out[:-1]]) * args[1]
    np.testing.assert_allclose(((1.0 - z) * n + z * h_prev).numpy(), ref, atol=ATOL)
    np.testing.assert_allclose(n.numpy(), torch.tanh(args[0][..., 2 * H :] + r * hh_n).numpy(), atol=ATOL)


@pytest.mark.parametrize("T", [1, 3, 16])
def test_plain_gru_backward_from_saved_gates_matches_jax_vjp(T):
    d_out, xi, masks, h0, w_hh, b_hh = _backward_case(T)
    ref = _jax_gradients(d_out, xi, masks, h0, w_hh, b_hh)
    args = _strided_args(xi, masks, h0, w_hh, b_hh)
    out, gates = gru_sequence_plain(*args, return_gates=True)
    got = gru_sequence_backward(torch.from_numpy(d_out), *args, out, gates=gates)  # the plain version on the CPU
    for name, a, b in zip(("d_xi", "d_h0", "d_w_hh", "d_b_hh"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, err_msg=name)


@pytest.mark.parametrize("T", [1, 3, 16])
def test_saved_gate_backward_equals_the_recomputing_one(T):
    d_out, xi, masks, h0, w_hh, b_hh = _backward_case(T, seed=7)
    args = _strided_args(xi, masks, h0, w_hh, b_hh)
    out, gates = gru_sequence_plain(*args, return_gates=True)
    recomputed = gru_sequence_backward_plain(torch.from_numpy(d_out), *args, out)
    saved = gru_sequence_backward_plain(torch.from_numpy(d_out), *args, out, gates=gates)
    for name, a, b in zip(("d_xi", "d_h0", "d_w_hh", "d_b_hh"), saved, recomputed):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("T", [1, 3, 16])
def test_weight_gradient_over_all_steps_matches_jax_vjp(T):
    """d_gh rebuilt from d_xi and the saved r (d_gh = d_xi but for the n
    gate's r factor); the weight gradient over all T * B rows at once
    against the JAX scan's, d_w_hh held relative to its scale."""
    d_out, xi, masks, h0, w_hh, b_hh = _backward_case(T, seed=5)
    ref = _jax_gradients(d_out, xi, masks, h0, w_hh, b_hh)
    args = _strided_args(xi, masks, h0, w_hh, b_hh)
    out, gates = gru_sequence_plain(*args, return_gates=True)
    d_xi = gru_sequence_backward_plain(torch.from_numpy(d_out), *args, out, gates=gates)[0]
    H = h0.shape[1]
    d_gh = torch.cat([d_xi[..., : 2 * H], d_xi[..., 2 * H :] * gates[..., :H]], dim=2)
    d_w_hh, d_b_hh = gru_weight_gradient(d_gh, args[1], args[2], out)  # the plain version on the CPU
    assert torch.equal(d_w_hh, gru_weight_gradient_plain(d_gh, args[1], args[2], out)[0])
    for name, a, b in (("d_w_hh", d_w_hh, ref[2]), ("d_b_hh", d_b_hh, ref[3])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL * max(1.0, float(np.abs(b).max())), err_msg=name)


def test_rnn_state_encoder_gru_is_differentiable_like_jax():
    """Gradients of a weighted sum of the sequence outputs with respect to
    the encoder's four parameters and its input, against jax.grad."""
    D, H, B, T = 24, 32, 3, 5
    jax_enc, params, enc = _encoders(D, H, seed=2)
    rng = np.random.RandomState(4)
    x, states = rng.randn(T, B, D).astype(np.float32), rng.randn(B, 1, H).astype(np.float32)
    masks = np.ones((T, B, 1), np.float32)
    masks[2, 1] = 0.0
    weight = rng.randn(T, B, H).astype(np.float32)

    def loss(params, x):
        return jnp.sum(jax_enc.apply({"params": params}, x, jnp.asarray(states), jnp.asarray(masks))[0] * weight)

    d_params, d_x = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    x_t = torch.from_numpy(x).requires_grad_()
    out, _ = enc(x_t, torch.from_numpy(states), torch.from_numpy(masks))
    (out * torch.from_numpy(weight)).sum().backward()
    np.testing.assert_allclose(x_t.grad.numpy(), np.asarray(d_x), atol=ATOL)
    for k, v in d_params["cell"].items():
        np.testing.assert_allclose(getattr(enc.rnn, f"{k}_l0").grad.numpy(), np.asarray(v), atol=ATOL * max(1.0, float(np.abs(v).max())), err_msg=k)
