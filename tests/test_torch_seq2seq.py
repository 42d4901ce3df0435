"""The port's Seq2Seq policy and the non-spatial heads of its visual
encoders against the JAX package (f32, CPU, ResNet18s, H=64, 32x32 frames),
and the optimizer's trainable mask of Seq2Seq and of RxR CMA against JAX's.

Weights are carried across by `state_dict_from_jax_params(params,
"Seq2SeqPolicy")` and loaded strictly. Tolerances: 1e-4 against JAX (two
frameworks' convolutions and instruction RNNs), 1e-5 between the port's own
sequence and step modes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vlnce_tpu.models.convert import convert_policy_state_dict
from vlnce_tpu.models.encoders.visual_wrappers import (
    TorchVisionResNetEncoder as JaxRGBEncoder,
    VlnResnetDepthEncoder as JaxDepthEncoder,
)
from vlnce_tpu.parallel.optim import trainable_mask as jax_trainable_mask
from vlnce_torch.models.convert import state_dict_from_jax_params
from vlnce_torch.parallel.optim import masked_adam, trainable_mask

from tests.torch_port_cases import (
    build_pair,
    build_seq2seq_pair,
    observations,
    r2r_observations,
    to_torch,
)

T, N = 4, 3
ATOL = 1e-4


def _sequence_inputs(rng, task_config, rxr=False):
    """[T*N] observations (each env's instruction constant over T), prev
    actions and masks with an episode boundary inside the sequence."""
    obs = (observations if rxr else r2r_observations)(rng, T * N, task_config)
    key = "rxr_instruction" if rxr else "instruction"
    obs[key] = np.tile(obs[key][:N], (T,) + (1,) * (obs[key].ndim - 1))
    prev = rng.randint(0, 4, (T * N, 1)).astype(np.int64)
    masks = np.ones((T, N, 1), np.float32)
    masks[0] = 0.0
    masks[2, 1] = 0.0
    return obs, prev, masks.reshape(T * N, 1)


@pytest.fixture(scope="module", params=["GRU", "LSTM"])
def case(request):
    (jax_policy, params), policy, (jcfg, cfg) = build_seq2seq_pair(
        seed=4, extra=["MODEL.STATE_ENCODER.rnn_type", request.param])
    obs, prev, masks = _sequence_inputs(np.random.RandomState(8), cfg.TASK_CONFIG)
    return {"rnn": request.param, "jax_policy": jax_policy, "params": params, "policy": policy, "jcfg": jcfg, "cfg": cfg,
            "obs": obs, "prev": prev, "masks": masks}


@pytest.fixture(scope="module")
def rxr_case():
    (jax_policy, params), policy, (jcfg, cfg) = build_seq2seq_pair(seed=5, rxr=True)
    obs, prev, masks = _sequence_inputs(np.random.RandomState(9), cfg.TASK_CONFIG, rxr=True)
    return {"jax_policy": jax_policy, "params": params, "policy": policy, "jcfg": jcfg, "cfg": cfg,
            "obs": obs, "prev": prev, "masks": masks}


def _jax_obs(obs):
    return {k: jnp.asarray(v) for k, v in obs.items()}


def test_seq2seq_loads_strictly_and_is_the_inverse_of_the_jax_converter(case):
    sd = state_dict_from_jax_params(case["params"], "Seq2SeqPolicy")
    for key in ("net.depth_encoder.visual_fc.1.weight", "net.rgb_encoder.fc.1.weight", "net.prev_action_embedding.weight",
                "net.progress_monitor.weight", "net.state_encoder.rnn.weight_hh_l0"):
        assert key in sd, key
    assert not any("spatial_embeddings" in k for k in sd)
    back = convert_policy_state_dict({k: v.numpy() for k, v in sd.items()}, case["params"], "Seq2SeqPolicy")
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(case["params"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(KeyError, match="no place in the port"):
        state_dict_from_jax_params({**case["params"], "stray": {"kernel": np.zeros(2)}}, "Seq2SeqPolicy")


@pytest.mark.parametrize("encoder", ["depth", "rgb"])
def test_non_spatial_heads_match_jax(case, encoder):
    """The depth encoder's flatten -> visual_fc -> ReLU and the RGB encoder's
    global average pool -> fc -> ReLU, each against its JAX module on the
    same weights; what they cache is JAX's sown map ([B, C, 1, 1] for RGB)."""
    cfg, params, policy = case["cfg"], case["params"]["net"], case["policy"]
    mc = cfg.MODEL
    obs = {k: v[:N] for k, v in case["obs"].items()}
    if encoder == "depth":
        jax_module = JaxDepthEncoder(input_hw=obs["depth"].shape[1:3], output_size=mc.DEPTH_ENCODER.output_size,
                                     backbone=mc.DEPTH_ENCODER.backbone, spatial_output=False)
        port_module, jax_params = policy.net.depth_encoder, params["depth_encoder"]
    else:
        jax_module = JaxRGBEncoder(version="resnet18", output_size=mc.RGB_ENCODER.output_size, spatial_output=False)
        port_module, jax_params = policy.net.rgb_encoder, params["rgb_encoder"]
    ref, sown = jax_module.apply({"params": jax_params}, _jax_obs(obs), mutable=["intermediates"])
    with torch.no_grad():
        got = port_module(to_torch(obs))
    assert tuple(got.shape) == (N, port_module.output_size) == tuple(ref.shape) and bool((got >= 0).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    cached = np.asarray(sown["intermediates"]["cached_features"][0])
    assert tuple(port_module.cached_features.shape) == cached.shape
    if encoder == "rgb":
        assert cached.shape[2:] == (1, 1)
    np.testing.assert_allclose(port_module.cached_features.numpy(), cached, atol=ATOL)


def test_act_step_matches_jax(case):
    jp, policy = case["jax_policy"], case["policy"]
    rows = slice(0, N)
    obs = {k: v[rows] for k, v in case["obs"].items()}
    prev, masks = case["prev"][rows], np.ones((N, 1), np.float32)
    ref_action, ref_states, ref_feats = jp.act_with_features(
        _jax_obs(obs), jp.initial_rnn_states(N), jnp.asarray(prev, jnp.int32), jnp.asarray(masks), deterministic=True)
    ref_logits, _, _ = jp.module.apply({"params": case["params"]}, _jax_obs(obs), jp.initial_rnn_states(N),
                                       jnp.asarray(prev, jnp.int32), jnp.asarray(masks))
    action, states, feats = policy.act_with_features(
        to_torch(obs), policy.initial_rnn_states(N), torch.from_numpy(prev), torch.from_numpy(masks), deterministic=True)
    with torch.no_grad():
        logits = policy(to_torch(obs), policy.initial_rnn_states(N), torch.from_numpy(prev), torch.from_numpy(masks))[0]
    layers = 2 if case["rnn"] == "LSTM" else 1
    assert tuple(states.shape) == (N, layers, 64) == tuple(ref_states.shape)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=ATOL)
    np.testing.assert_array_equal(action.numpy(), np.asarray(ref_action))
    np.testing.assert_allclose(states.numpy(), np.asarray(ref_states), atol=ATOL)
    assert sorted(feats) == sorted(ref_feats) == ["depth_features", "rgb_features"]
    for key in feats:
        np.testing.assert_allclose(feats[key].numpy(), np.asarray(ref_feats[key]), atol=ATOL, err_msg=key)


def test_sequence_forward_matches_jax(case):
    jp, policy = case["jax_policy"], case["policy"]
    ref_logits, ref_states, ref_aux = jp.build_distribution_logits(
        _jax_obs(case["obs"]), jp.initial_rnn_states(N), jnp.asarray(case["prev"], jnp.int32), jnp.asarray(case["masks"]), T)
    with torch.no_grad():
        logits, states, aux = policy.build_distribution_logits(
            to_torch(case["obs"]), policy.initial_rnn_states(N), torch.from_numpy(case["prev"]),
            torch.from_numpy(case["masks"]), T)
    assert tuple(logits.shape) == (T * N, 4)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=ATOL)
    np.testing.assert_allclose(states.numpy(), np.asarray(ref_states), atol=ATOL)
    loss, alpha = aux["progress_monitor"]
    assert alpha == ref_aux["progress_monitor"][1] and tuple(loss.shape) == (T * N,)
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref_aux["progress_monitor"][0]), atol=ATOL)


def test_sequence_forward_equals_single_steps(case):
    policy = case["policy"]
    obs, prev, masks = to_torch(case["obs"]), torch.from_numpy(case["prev"]), torch.from_numpy(case["masks"])
    with torch.no_grad():
        seq_logits, seq_states, _ = policy(obs, policy.initial_rnn_states(N), prev, masks, seq_len=T)
        states, logits = policy.initial_rnn_states(N), []
        for t in range(T):
            rows = slice(t * N, (t + 1) * N)
            lg, states, _ = policy({k: v[rows] for k, v in obs.items()}, states, prev[rows], masks[rows])
            logits.append(lg)
    np.testing.assert_allclose(seq_logits.numpy(), torch.cat(logits).numpy(), atol=1e-5)
    np.testing.assert_allclose(seq_states.numpy(), states.numpy(), atol=1e-5)


def test_cached_features_bypass_the_backbones(case):
    """What DAgger stores for Seq2Seq (the unpooled depth map, the pooled RGB
    vector) fed back in place of the frames gives the same logits."""
    policy = case["policy"]
    obs = to_torch({k: v[:N] for k, v in case["obs"].items()})
    prev, masks = torch.from_numpy(case["prev"][:N]), torch.ones(N, 1)
    _, _, feats = policy.act_with_features(obs, policy.initial_rnn_states(N), prev, masks, deterministic=True)
    c, h, w = policy.net.depth_encoder.visual_encoder.output_shape_chw()
    assert tuple(feats["depth_features"].shape) == (N, c, h, w)
    assert tuple(feats["rgb_features"].shape) == (N, policy.net.rgb_encoder.resnet_layer_size, 1, 1)
    cached = {k: v for k, v in obs.items() if k not in ("rgb", "depth")}
    cached.update(feats)
    with torch.no_grad():
        from_frames = policy(obs, policy.initial_rnn_states(N), prev, masks)[0]
        from_cache = policy(cached, policy.initial_rnn_states(N), prev, masks)[0]
    assert torch.equal(from_frames, from_cache)


def test_rxr_seq2seq_sequence_forward_matches_jax(rxr_case):
    """rxr_seq2seq.yaml: BERT-feature instructions, frames through the obs
    transforms on both sides."""
    from vlnce_tpu.ops.obs_transforms import (apply_obs_transforms_batch as jax_apply,
                                              get_active_obs_transforms as jax_transforms)
    from vlnce_torch.ops.obs_transforms import apply_obs_transforms_batch, get_active_obs_transforms

    c = rxr_case
    jp, policy = c["jax_policy"], c["policy"]
    jax_obs = jax_apply(_jax_obs(c["obs"]), jax_transforms(c["jcfg"]))
    ref_logits, ref_states, _ = jp.build_distribution_logits(
        jax_obs, jp.initial_rnn_states(N), jnp.asarray(c["prev"], jnp.int32), jnp.asarray(c["masks"]), T)
    obs = apply_obs_transforms_batch(to_torch(c["obs"]), get_active_obs_transforms(c["cfg"]))
    with torch.no_grad():
        logits, states, aux = policy.build_distribution_logits(
            obs, policy.initial_rnn_states(N), torch.from_numpy(c["prev"]), torch.from_numpy(c["masks"]), T)
    assert aux == {} and tuple(logits.shape) == (T * N, 6)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=ATOL)
    np.testing.assert_allclose(states.numpy(), np.asarray(ref_states), atol=ATOL)


def _masks_against_jax(params, jax_model_config, policy, model_config, policy_name):
    """The port's trainable mask and JAX's, both in the port's names: every
    parameter tensor trains in one iff it trains in the other, and every
    buffer (the frozen BatchNorm's affine and statistics, leaves of the JAX
    tree) is frozen in JAX's."""
    jax_mask = jax_trainable_mask(params, jax_model_config)
    as_arrays = jax.tree_util.tree_map(lambda m, p: np.full(np.shape(p), float(m), np.float32), jax_mask, params)
    jax_named = {k: bool(v.all()) for k, v in state_dict_from_jax_params(as_arrays, policy_name).items()}
    assert all(bool(v.all()) or not bool(v.any()) for v in state_dict_from_jax_params(as_arrays, policy_name).values())
    mask = trainable_mask(policy, model_config)
    assert mask == {k: jax_named[k] for k in mask}
    buffers = {k for k, _ in policy.named_buffers() if not k.endswith("num_batches_tracked")}
    assert buffers and not any(jax_named[k] for k in buffers)
    assert set(jax_named) == set(mask) | buffers
    return mask


def test_seq2seq_trainable_mask_matches_jax(case):
    mask = _masks_against_jax(case["params"], case["jcfg"].MODEL, case["policy"], case["cfg"].MODEL, "Seq2SeqPolicy")
    assert mask["net.depth_encoder.visual_fc.1.weight"] and mask["net.rgb_encoder.fc.1.weight"]
    assert not mask["net.rgb_encoder.cnn.0.weight"] and not mask["net.instruction_encoder.embedding_layer.weight"]


def test_rxr_trainable_masks_match_jax(rxr_case):
    """RxR CMA and RxR Seq2Seq: JAX's mask with `use_pretrained_embeddings
    False` (it raises at the YAML's True, finding no token table to freeze)
    equals the port's at the YAML's flags, which freezes no table either:
    the one known difference is where the JAX mask raises, nowhere else."""
    c = rxr_case
    mask = _masks_against_jax(c["params"], c["jcfg"].MODEL, c["policy"], c["cfg"].MODEL, "Seq2SeqPolicy")
    assert c["cfg"].MODEL.INSTRUCTION_ENCODER.use_pretrained_embeddings
    assert all(v for k, v in mask.items() if k.startswith("net.instruction_encoder."))
    jcfg = c["jcfg"].clone().defrost()
    jcfg.MODEL.INSTRUCTION_ENCODER.use_pretrained_embeddings = True
    with pytest.raises(ValueError, match="instruction_encoder/embedding"):
        jax_trainable_mask(c["params"], jcfg.MODEL)

    (jax_cma, _, params), (policy, _), cfg = build_pair(seed=6)
    assert cfg.MODEL.INSTRUCTION_ENCODER.use_pretrained_embeddings
    jax_model = jax_cma.config.MODEL.clone().defrost()
    jax_model.INSTRUCTION_ENCODER.use_pretrained_embeddings = False
    mask = _masks_against_jax(params, jax_model, policy, cfg.MODEL, "CMAPolicy")
    assert sum(mask.values()) == len([p for p in jax.tree_util.tree_leaves(jax_trainable_mask(params, jax_model)) if p])


def test_masked_adam_steps_move_only_trainable_seq2seq_leaves(case):
    """One masked Adam step on the sequence loss: every trainable tensor
    moves, every frozen one stays bit-equal and holds no state."""
    import copy

    from vlnce_torch.parallel.il_step import il_losses

    policy = copy.deepcopy(case["policy"])
    optimizer = masked_adam(2.5e-4, policy, case["cfg"].MODEL)
    before = {k: v.clone() for k, v in policy.state_dict().items()}
    obs = {k: torch.from_numpy(v).reshape((T, N) + v.shape[1:]) for k, v in case["obs"].items()}
    corrected = torch.from_numpy(np.random.RandomState(3).randint(0, 4, (T, N)))
    loss, _, _ = il_losses(policy, obs, torch.from_numpy(case["prev"]).reshape(T, N),
                           torch.from_numpy(case["masks"]).reshape(T, N), corrected, torch.ones(T, N))
    loss.backward()
    optimizer.step()
    mask = trainable_mask(policy, case["cfg"].MODEL)
    for name, value in policy.state_dict().items():
        if mask.get(name, False):
            assert not torch.equal(value, before[name]), name
        else:
            assert torch.equal(value, before[name]), name
    assert len(optimizer.state) == sum(mask.values())
