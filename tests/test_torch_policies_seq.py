"""The R2R CMA policy with the progress monitor in sequence mode, and
`act_with_features`, against the JAX package (f32, CPU, ResNet18s, H=64,
16x16 frames). Tolerances: 1e-4 against JAX (two frameworks' convolutions
and a 200-token biLSTM), 1e-5 between the port's own sequence and step modes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vlnce_torch.config import get_config
from vlnce_torch.envs.spaces import action_space_from_config, observation_space_from_config
from vlnce_torch.models.cma_policy import CMAPolicy
from vlnce_torch.models.convert import state_dict_from_jax_params

from tests.torch_port_cases import R2R_CMA, R2R_SMALL_OPTS, build_r2r_pair, r2r_observations, to_torch

T, N = 4, 3


@pytest.fixture(scope="module")
def case():
    (jax_policy, params), policy, (jcfg, cfg) = build_r2r_pair(seed=2)
    rng = np.random.RandomState(7)
    obs = r2r_observations(rng, T * N, cfg.TASK_CONFIG)
    # the instruction is an episode's: constant over T for each of the N envs
    obs["instruction"] = np.tile(obs["instruction"][:N], (T, 1))
    prev = rng.randint(0, 4, (T * N, 1)).astype(np.int64)
    masks = np.ones((T, N, 1), np.float32)
    masks[0] = 0.0
    masks[2, 1] = 0.0  # an episode boundary inside the sequence
    return {"jax_policy": jax_policy, "params": params, "policy": policy, "cfg": cfg, "obs": obs, "prev": prev,
            "masks": masks.reshape(T * N, 1)}


def _jax_obs(obs):
    return {k: jnp.asarray(v) for k, v in obs.items()}


def test_r2r_cma_with_progress_monitor_loads_strictly(case):
    sd = state_dict_from_jax_params(case["params"])
    assert "net.progress_monitor.weight" in sd and "net.instruction_encoder.embedding_layer.weight" in sd
    cfg = case["cfg"]
    policy = CMAPolicy.from_config(cfg, observation_space_from_config(cfg.TASK_CONFIG), action_space_from_config(cfg.TASK_CONFIG))
    assert policy.load_state_dict(sd, strict=True).missing_keys == []
    with pytest.raises(RuntimeError, match="progress_monitor"):
        policy.load_state_dict({k: v for k, v in sd.items() if "progress_monitor" not in k}, strict=True)


def test_sequence_forward_matches_jax(case):
    jp = case["jax_policy"]
    ref_logits, ref_states, ref_aux = jp.build_distribution_logits(
        _jax_obs(case["obs"]), jp.initial_rnn_states(N), jnp.asarray(case["prev"], jnp.int32), jnp.asarray(case["masks"]), T
    )
    policy = case["policy"]
    with torch.no_grad():
        logits, states, aux = policy.build_distribution_logits(
            to_torch(case["obs"]), policy.initial_rnn_states(N), torch.from_numpy(case["prev"]), torch.from_numpy(case["masks"]), T
        )
    assert tuple(logits.shape) == (T * N, 4) and tuple(states.shape) == (N, 2, 64)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=1e-4)
    np.testing.assert_allclose(states.numpy(), np.asarray(ref_states), atol=1e-4)
    loss, alpha = aux["progress_monitor"]
    assert tuple(loss.shape) == (T * N,) and alpha == ref_aux["progress_monitor"][1]
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref_aux["progress_monitor"][0]), atol=1e-4)


def test_sequence_forward_equals_single_steps(case):
    policy = case["policy"]
    obs, prev, masks = to_torch(case["obs"]), torch.from_numpy(case["prev"]), torch.from_numpy(case["masks"])
    with torch.no_grad():
        seq_logits, seq_states, seq_aux = policy(obs, policy.initial_rnn_states(N), prev, masks, seq_len=T)
        states, logits, aux = policy.initial_rnn_states(N), [], []
        for t in range(T):
            rows = slice(t * N, (t + 1) * N)
            lg, states, ax = policy({k: v[rows] for k, v in obs.items()}, states, prev[rows], masks[rows])
            logits.append(lg)
            aux.append(ax["progress_monitor"][0])
    np.testing.assert_allclose(seq_logits.numpy(), torch.cat(logits).numpy(), atol=1e-5)
    np.testing.assert_allclose(seq_states.numpy(), states.numpy(), atol=1e-5)
    np.testing.assert_allclose(seq_aux["progress_monitor"][0].numpy(), torch.cat(aux).numpy(), atol=1e-5)


def test_act_with_features_returns_the_encoders_outputs_as_jax_does(case):
    jp, policy = case["jax_policy"], case["policy"]
    rows = slice(0, N)
    obs = {k: v[rows] for k, v in case["obs"].items()}
    ref_action, ref_states, ref_feats = jp.act_with_features(
        _jax_obs(obs), jp.initial_rnn_states(N), jnp.asarray(case["prev"][rows], jnp.int32), jnp.ones((N, 1)), deterministic=True
    )
    tobs = to_torch(obs)
    action, states, feats = policy.act_with_features(
        tobs, policy.initial_rnn_states(N), torch.from_numpy(case["prev"][rows]), torch.ones(N, 1), deterministic=True
    )
    assert sorted(feats) == ["depth_features", "rgb_features"] and tuple(action.shape) == (N, 1)
    assert not feats["rgb_features"].requires_grad
    np.testing.assert_array_equal(action.numpy(), np.asarray(ref_action))
    np.testing.assert_allclose(states.numpy(), np.asarray(ref_states), atol=1e-4)
    for key in feats:
        np.testing.assert_allclose(feats[key].numpy(), np.asarray(ref_feats[key]), atol=1e-4, err_msg=key)
    # they are the backbones' own outputs, and feeding them back bypasses the backbones
    with torch.no_grad():
        depth = policy.net.depth_encoder.visual_encoder(tobs["depth"].permute(0, 3, 1, 2))
        cached = dict(tobs, **feats)
        del cached["rgb"], cached["depth"]
        logits_frames = policy(tobs, policy.initial_rnn_states(N), torch.from_numpy(case["prev"][rows]), torch.ones(N, 1))[0]
        logits_cached = policy(cached, policy.initial_rnn_states(N), torch.from_numpy(case["prev"][rows]), torch.ones(N, 1))[0]
    assert torch.equal(feats["depth_features"], depth)
    assert torch.equal(logits_frames, logits_cached)
    action2, _, feats2 = policy.act_with_features(
        cached, policy.initial_rnn_states(N), torch.from_numpy(case["prev"][rows]), torch.ones(N, 1), deterministic=True
    )
    assert feats2 == {} and torch.equal(action2, action)


def _encoder_grads(trainable_rgb: bool, trainable_depth: bool):
    cfg = get_config(R2R_CMA, R2R_SMALL_OPTS + [
        "CUDA.DEVICE", "cpu", "CUDA.PRECISION.compute_dtype", "float32",
        "MODEL.RGB_ENCODER.trainable", trainable_rgb, "MODEL.DEPTH_ENCODER.trainable", trainable_depth,
    ])
    policy = CMAPolicy.from_config(cfg, observation_space_from_config(cfg.TASK_CONFIG), action_space_from_config(cfg.TASK_CONFIG))
    obs = to_torch(r2r_observations(np.random.RandomState(0), 2, cfg.TASK_CONFIG))
    logits, _, aux = policy(obs, policy.initial_rnn_states(2), torch.zeros(2, 1, dtype=torch.long), torch.ones(2, 1))
    (logits.sum() + aux["progress_monitor"][0].sum()).backward()
    rgb = policy.net.rgb_encoder.cnn[0].weight
    depth = policy.net.depth_encoder.visual_encoder.backbone.conv1[0].weight
    return (rgb.requires_grad, rgb.grad), (depth.requires_grad, depth.grad), policy.net.rgb_linear[2].weight.grad


@pytest.mark.parametrize("trainable_rgb,trainable_depth", [(False, False), (True, False), (False, True)])
def test_backbones_train_only_when_the_config_says_so(trainable_rgb, trainable_depth):
    """MODEL.{RGB,DEPTH}_ENCODER.trainable False (the default) is the JAX
    wrappers' stop_gradient: the backbone's parameters ask for no gradient and
    get none; True trains them."""
    (rgb_asks, rgb_grad), (depth_asks, depth_grad), head_grad = _encoder_grads(trainable_rgb, trainable_depth)
    assert rgb_asks == trainable_rgb and (rgb_grad is not None) == trainable_rgb
    assert depth_asks == trainable_depth and (depth_grad is not None) == trainable_depth
    assert head_grad is not None and float(head_grad.abs().max()) > 0
    if trainable_rgb:
        assert float(rgb_grad.abs().max()) > 0
    if trainable_depth:
        assert float(depth_grad.abs().max()) > 0


def test_train_mode_changes_no_output(case):
    """The policy is kept in eval() while it trains; train() would change
    nothing, since no module of it has a training mode."""
    policy = case["policy"]
    assert not policy.training
    obs, prev, masks = to_torch(case["obs"]), torch.from_numpy(case["prev"]), torch.from_numpy(case["masks"])
    with torch.no_grad():
        ref = policy(obs, policy.initial_rnn_states(N), prev, masks, seq_len=T)[0]
        policy.train()
        try:
            got = policy(obs, policy.initial_rnn_states(N), prev, masks, seq_len=T)[0]
            stats = {k: v.clone() for k, v in policy.state_dict().items()}
        finally:
            policy.eval()
    assert torch.equal(got, ref)
    assert all(torch.equal(v, policy.state_dict()[k]) for k, v in stats.items())
