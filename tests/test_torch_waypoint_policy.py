"""The port's waypoint policy stack against the JAX package's, on the CPU:
the distributions (TruncatedNormal, Categorical and helpers),
MultiHeadDotProductAttention, WaypointPredictionNet in the single step and
in the sequence mode, and WaypointPolicy's act (deterministic), get_value
and evaluate_actions, at each of the six r2r_waypoint flag sets (continuous
and discrete heads, the HPN ablations) at a small size, with the same
weights in both packages and inputs made by numpy from a seed.

Tolerances: the distributions 1e-5 (their inverse CDF 1e-4, where erfinv of
each framework differs in the last digits near the tails); the attention
1e-5; the network's and the policy's outputs atol 1e-4 (two frameworks'
summation orders through two ResNet18s, a biLSTM and two GRUs, as
tests/test_torch_seq2seq.py holds the Seq2Seq policy); the STOP and pano
choices exactly.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import vlnce_tpu.models.distributions as jd
from vlnce_tpu.models.attention import MultiHeadDotProductAttention as JaxMHA
from vlnce_tpu.parallel.optim import trainable_mask as jax_trainable_mask
from vlnce_torch.models import distributions as td
from vlnce_torch.models.attention import MultiHeadDotProductAttention
from vlnce_torch.models.convert import state_dict_from_jax_params
from vlnce_torch.parallel.optim import trainable_mask

from tests.torch_port_cases import (WAYPOINT_NAMES, WP_H, build_waypoint_pair, waypoint_observations,
                                    waypoint_prev_actions)

ATOL = 1e-4

# ---------------------------------------------------------------------------
# distributions and attention
# ---------------------------------------------------------------------------


def _truncnorm_params(rng, n, smin, smax):
    """Locs inside, near and beyond the bounds; scales as the heads'
    variances give them (sqrt of 0.0003 to 3.5)."""
    width = smax - smin
    loc = rng.uniform(smin - 0.3 * width, smax + 0.3 * width, (n, 1)).astype(np.float32)
    scale = np.sqrt(rng.uniform(0.0003, 3.5, (n, 1))).astype(np.float32)
    return loc, scale


@pytest.mark.parametrize("bounds", [(0.25, 4.0), (-math.pi / 12, math.pi / 12)], ids=["distance", "offset"])
def test_truncated_normal_matches_jax(bounds):
    """log_prob, entropy, mean, variance and mode at seeded parameters, and
    the inverse CDF from the same u in [cdf(smin), cdf(smax)]."""
    smin, smax = bounds
    rng = np.random.RandomState(3)
    loc, scale = _truncnorm_params(rng, 64, smin, smax)
    value = rng.uniform(smin, smax, loc.shape).astype(np.float32)
    jdist = jd.TruncatedNormal(jnp.asarray(loc), jnp.asarray(scale), smin, smax)
    tdist = td.TruncatedNormal(torch.from_numpy(loc), torch.from_numpy(scale), smin, smax)
    pairs = {
        "log_prob": (jdist.log_prob(jnp.asarray(value)), tdist.log_prob(torch.from_numpy(value))),
        "entropy": (jdist.entropy(), tdist.entropy()),
        "mean": (jdist.mean, tdist.mean),
        "variance": (jdist.variance, tdist.variance),
        "mode": (jdist.mode(), tdist.mode()),
    }
    for name, (ref, got) in pairs.items():
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5, err_msg=name)

    frac = rng.uniform(0.0, 1.0, loc.shape).astype(np.float32)
    u = np.array(jdist._alpha_cdf + frac * jdist._Z, np.float32)  # the JAX sampler's uniform draw
    ref = jnp.clip(jnp.asarray(loc) + jnp.asarray(scale) * jd._std_icdf(jnp.asarray(u)), smin, smax)
    got = tdist.icdf(torch.from_numpy(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
    draws = tdist.sample(torch.Generator().manual_seed(0))
    assert draws.shape == loc.shape and bool(((draws >= smin) & (draws <= smax)).all())


def test_categorical_and_index_helpers_match_jax():
    rng = np.random.RandomState(4)
    logits = rng.randn(5, 13).astype(np.float32)
    actions = rng.randint(0, 13, (5, 1))
    jc, tc = jd.Categorical(jnp.asarray(logits)), td.Categorical(torch.from_numpy(logits))
    np.testing.assert_allclose(tc.log_prob(torch.from_numpy(actions)).numpy(), np.asarray(jc.log_prob(jnp.asarray(actions))), atol=1e-6)
    np.testing.assert_allclose(tc.entropy().numpy(), np.asarray(jc.entropy()), atol=1e-6)
    np.testing.assert_array_equal(tc.mode().numpy(), np.asarray(jc.mode()))
    x = rng.randn(5, 12, 7).astype(np.float32)
    index = rng.randint(0, 12, 5)
    np.testing.assert_array_equal(td.batched_index_select(torch.from_numpy(x), 1, torch.from_numpy(index)).numpy(),
                                  np.asarray(jd.batched_index_select(jnp.asarray(x), 1, jnp.asarray(index))))
    np.testing.assert_allclose(td.temperature_tanh(torch.from_numpy(x), 4.0).numpy(),
                               np.asarray(jd.temperature_tanh(jnp.asarray(x), 4.0)), atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_multi_head_attention_matches_jax(masked):
    """Single query, two heads, bias-free projections, LayerNorm: the JAX
    module's parameters carried into the port's by name."""
    rng = np.random.RandomState(5)
    B, P, d_q, d_kv = 3, 12, 20, 24
    q = rng.randn(B, d_q).astype(np.float32)
    k = rng.randn(B, d_kv, P).astype(np.float32)
    mask = (rng.rand(B, P) > 0.3).astype(np.float32) if masked else None
    jm = JaxMHA(d_qk=16, d_v=8, num_heads=2, d_out=d_kv)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), q, k, k)["params"])
    params["layer_norm"] = {"scale": rng.normal(1.0, 0.2, d_kv).astype(np.float32),
                            "bias": rng.normal(0.0, 0.1, d_kv).astype(np.float32)}
    ref = jm.apply({"params": params}, q, k, k, None if mask is None else jnp.asarray(mask))
    module = MultiHeadDotProductAttention(d_q, d_kv, d_kv, d_qk=16, d_v=8, num_heads=2, d_out=d_kv)
    with torch.no_grad():
        for name in ("q_linear", "k_linear", "v_linear", "final_linear"):
            getattr(module, name).weight.copy_(torch.from_numpy(params[name]["kernel"].T))
        module.layer_norm.weight.copy_(torch.from_numpy(params["layer_norm"]["scale"]))
        module.layer_norm.bias.copy_(torch.from_numpy(params["layer_norm"]["bias"]))
        got = module(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(k), None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


# ---------------------------------------------------------------------------
# the network and the policy at the six flag sets
# ---------------------------------------------------------------------------

T, N = 3, 2  # the sequence mode's length and envs
_CASES = {}


def _inputs(seed, B, wypt_cfg):
    """Observations, [B, 2, H] states, prev actions and masks (one reset) for
    a batch of B rows, as numpy."""
    rng = np.random.RandomState(seed)
    obs = waypoint_observations(rng, B)
    states = (rng.randn(B, 2, WP_H) * 0.5).astype(np.float32)
    prev = waypoint_prev_actions(rng, (B,), wypt_cfg)
    masks = np.ones((B, 1), np.float32)
    masks[1] = 0.0
    return obs, states, prev, masks


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else torch.from_numpy(np.ascontiguousarray(v)) for k, v in tree.items()}


def _case(name):
    """The pair of policies at `name`'s flags, the inputs of both modes, and
    the JAX package's outputs on them, built once per flag set. The JAX side
    runs as two jitted programs: the network's single step with the policy's
    act (deterministic) on the same B=3 inputs, and the network's sequence
    mode (T=3, n=2, resets at t=0 and in the middle) with evaluate_actions
    on stored actions with STOP rows among them; each program holds the
    network twice on the same inputs, which the compiler computes once."""
    if name in _CASES:
        return _CASES[name]
    (jax_policy, params), policy, (_, cfg) = build_waypoint_pair(name, seed=WAYPOINT_NAMES.index(name))
    wc = cfg.MODEL.WAYPOINT
    step = _inputs(1, 3, wc)
    seq_obs, _, seq_prev, _ = _inputs(2, T * N, wc)
    seq_masks = np.ones((T * N, 1), np.float32)
    seq_masks[:N] = 0.0
    seq_masks[N + 1] = 0.0
    actions = waypoint_prev_actions(np.random.RandomState(6), (T * N,), wc)
    actions["pano"][[0, 4]] = 12.0  # STOP rows
    seq = (seq_obs, step[1][:N], seq_prev, seq_masks)
    module = jax_policy.module

    @jax.jit
    def step_fn(params, obs, states, prev, masks):
        net = module.apply({"params": params}, obs, states, prev, masks)
        return net, jax_policy._act_impl(params, obs, states, prev, masks, jax.random.PRNGKey(0), deterministic=True)

    @jax.jit
    def seq_fn(params, obs, states, prev, masks, actions):
        net = module.apply({"params": params}, obs, states, prev, masks, seq_len=T)
        return net, jax_policy._evaluate_impl(params, obs, states, prev, masks, actions, seq_len=T)

    step_net, act = step_fn(params, *_jax(list(step)))
    seq_net, evaluate = seq_fn(params, *_jax(list(seq)), _jax(actions))
    _CASES[name] = {"jax_policy": jax_policy, "params": params, "policy": policy, "cfg": cfg, "step": step,
                    "seq": seq, "actions": actions, "step_net": step_net, "seq_net": seq_net, "act": act,
                    "evaluate": evaluate}
    return _CASES[name]


def _port_args(args):
    return [_torch(a) if isinstance(a, dict) else torch.from_numpy(a) for a in args]


@pytest.mark.parametrize("name", WAYPOINT_NAMES)
def test_prediction_net_matches_jax(name):
    """WaypointPredictionNet's every output in the single step (B=3, a
    reset) and in the sequence mode (T=3, n=2, time-major flattened, resets
    at t=0 and in the middle): heads, features, value and the [B, 2, H]
    states written back from both GRUs."""
    case = _case(name)
    for args, seq_len, ref in ((case["step"], None, case["step_net"]), (case["seq"], T, case["seq_net"])):
        with torch.no_grad():
            got = case["policy"](*_port_args(args), seq_len=seq_len)
        for key, value in ref.items():
            if value is None:
                assert key not in got or got[key] is None, key
                continue
            assert tuple(got[key].shape) == tuple(value.shape), key
            np.testing.assert_allclose(got[key].numpy(), np.asarray(value), atol=ATOL, err_msg=f"{key}, seq_len {seq_len}")


@pytest.mark.parametrize("name", WAYPOINT_NAMES)
def test_policy_act_and_value_match_jax(name):
    """act(deterministic=True): the pano/STOP choice and the decoded
    (r, theta) exactly as JAX chooses them, log-probs, modes, variances,
    value and states at ATOL; the env actions decode the same. get_value is
    held against the JAX network's value (the JAX get_value's own
    definition), and against JAX's get_value itself at 1-wpn-cc."""
    case = _case(name)
    policy, ref = case["policy"], case["act"]
    got = policy.act(*_port_args(case["step"]), deterministic=True)
    np.testing.assert_array_equal(got["stop"].numpy(), np.asarray(ref["stop"]))
    np.testing.assert_array_equal(got["action_elements"]["pano"].numpy(), np.asarray(ref["action_elements"]["pano"]))
    for key in ("value", "r", "theta", "action_log_probs", "rnn_states", "pano_stop_logits"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), atol=ATOL, err_msg=key)
    for group in ("action_elements", "modes", "variances"):
        for key, value in ref[group].items():
            np.testing.assert_allclose(got[group][key].float().numpy(), np.asarray(value, np.float32), atol=ATOL,
                                       err_msg=f"{group}/{key}")
    jax_policy = case["jax_policy"]

    def kinds(actions):
        return [a["action"] if isinstance(a["action"], str) else a["action"]["action"] for a in actions]

    assert kinds(type(policy).actions_to_env(got)) == kinds(type(jax_policy).actions_to_env(ref))
    value = policy.get_value(*_port_args(case["step"]))
    jax_value = jax_policy.get_value(*_jax(list(case["step"]))) if name == "1-wpn-cc" else case["step_net"]["value"]
    np.testing.assert_allclose(value.numpy(), np.asarray(jax_value), atol=ATOL)


@pytest.mark.parametrize("name", WAYPOINT_NAMES)
def test_policy_evaluate_actions_matches_jax(name):
    """evaluate_actions(seq_len=T) on stored action components with STOP
    rows among them (T=3, n=2): value, the joint log-prob (pano + masked
    distance and offset), the three entropies and the states, at ATOL; and
    its gradient flows to the trainable heads."""
    case = _case(name)
    policy, ref = case["policy"], case["evaluate"]
    got = policy.evaluate_actions(*_port_args(case["seq"]), _torch(case["actions"]), seq_len=T)
    for label, a, b in (("value", got[0], ref[0]), ("log_probs", got[1], ref[1]), ("states", got[3], ref[3])):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=ATOL, err_msg=label)
    for key in ("pano", "offset", "distance"):
        np.testing.assert_allclose(got[2][key].detach().numpy(), np.asarray(ref[2][key]), atol=ATOL, err_msg=key)
    policy.zero_grad(set_to_none=True)
    got[1].sum().backward()
    assert policy.net.stop_linear.weight.grad is not None
    policy.zero_grad(set_to_none=True)


def test_waypoint_trainable_mask_matches_jax():
    """At 1-wpn-cc.yaml's own flags (the pretrained token table frozen, as
    the default config says) the port's mask freezes exactly what the JAX
    package's freezes: the JAX mask as a tree of 0/1 arrays carried into the
    port's names, parameter by parameter; the frozen BatchNorm's affine and
    statistics are buffers in the port and frozen leaves in JAX."""
    (jax_policy, params), policy, (jcfg, cfg) = build_waypoint_pair(
        "1-wpn-cc", extra=("MODEL.INSTRUCTION_ENCODER.use_pretrained_embeddings", True))
    assert jcfg.MODEL.INSTRUCTION_ENCODER.use_pretrained_embeddings and not jcfg.MODEL.INSTRUCTION_ENCODER.fine_tune_embeddings
    jax_mask = jax_trainable_mask(params, jcfg.MODEL)
    as_arrays = jax.tree_util.tree_map(lambda p, m: np.full(np.shape(p), float(m), np.float32), params, jax_mask)
    carried = state_dict_from_jax_params(as_arrays, "WaypointPolicy")
    mask = trainable_mask(policy, cfg.MODEL)
    buffers = {n for n, _ in policy.named_buffers()}
    assert set(carried) == set(mask) | buffers
    for name, trains in mask.items():
        assert bool(carried[name].min()) == bool(carried[name].max()) == trains, name
    assert all(float(carried[name].max()) == 0.0 for name in buffers)
    assert not mask["net.instruction_encoder.embedding_layer.weight"]
    assert sum(not v for v in mask.values()) > 0 and mask["critic.fc.weight"]
