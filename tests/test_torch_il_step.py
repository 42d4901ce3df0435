"""The port's IL step (loss terms, gradients, masked Adam) against the JAX
package's, on one [T, N] batch of cached features, tokens and progress.

Both sides run in f32 on the CPU from the same weights (through
`state_dict_from_jax_params`, which also carries `jax.grad`'s tree into the
port's names). Tolerances: loss terms 1e-5; gradients atol 1e-5 / rtol 1e-4
(two frameworks' summation orders through a 200-token biLSTM and two GRUs);
parameters after Adam steps 1e-5, except the few elements whose gradient is
below 1e-6: there Adam's g / (sqrt(v) + 1e-8) turns a rounding difference of
1e-9 into a visible share of the step, so they are held to the step's own
bound, lr x steps.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from vlnce_tpu.parallel.il_step import _il_loss_terms, build_il_accum_step as jax_build_il_accum_step
from vlnce_tpu.parallel.il_step import build_il_train_step as jax_build_il_train_step
from vlnce_tpu.parallel.optim import masked_adam as jax_masked_adam, trainable_mask as jax_trainable_mask
from vlnce_torch.data.collate import collate_episodes, inflection_weights
from vlnce_torch.models.convert import state_dict_from_jax_params
from vlnce_torch.parallel.il_step import build_il_accum_step, build_il_train_step, il_loss_terms, il_losses
from vlnce_torch.parallel.optim import clip_by_global_norm_, masked_adam, trainable_mask

from tests.torch_port_cases import build_r2r_pair, seeded_episodes

LR = 2.5e-4  # IL.lr


@pytest.fixture(scope="module")
def case():
    (jax_policy, params), policy, (jcfg, cfg) = build_r2r_pair(seed=1)
    rng = np.random.RandomState(5)
    episodes = seeded_episodes(rng, policy, cfg.TASK_CONFIG, [5, 3, 6])
    batch = [(ep[0], ep[1], ep[2], inflection_weights(ep[2], 3.2)) for ep in episodes]
    obs, prev, masks, corrected, weights = collate_episodes(batch, length_quantum=1)
    T, N = corrected.shape
    tn = lambda a: a.reshape((T, N) + a.shape[1:])  # noqa: E731
    arrays = ({k: tn(v) for k, v in obs.items()}, prev.reshape(T, N), masks.reshape(T, N), corrected, weights)
    return {"jax_policy": jax_policy, "params": params, "policy": policy, "jcfg": jcfg, "cfg": cfg, "arrays": arrays}


def _jax_batch(arrays):
    obs, prev, masks, corrected, weights = arrays
    return ({k: jnp.asarray(v) for k, v in obs.items()}, jnp.asarray(prev, jnp.int32), jnp.asarray(masks),
            jnp.asarray(corrected, jnp.int32), jnp.asarray(weights))


def _torch_batch(arrays):
    obs, prev, masks, corrected, weights = arrays
    return ({k: torch.from_numpy(v) for k, v in obs.items()}, torch.from_numpy(prev), torch.from_numpy(masks),
            torch.from_numpy(corrected), torch.from_numpy(weights))


def _jax_terms(case, params, arrays):
    jp = case["jax_policy"]
    return _il_loss_terms(jp.module, params, *_jax_batch(arrays), jp.num_recurrent_layers, jp.hidden_size)


def _jax_loss(case, params, arrays):
    a_num, a_den, x_num, x_den = _jax_terms(case, params, arrays)
    return a_num / jnp.maximum(a_den, 1.0) + x_num / jnp.maximum(x_den, 1.0)


@pytest.fixture(scope="module")
def jax_grads(case):
    return jax.jit(jax.grad(lambda p: _jax_loss(case, p, case["arrays"])))(case["params"])


def _assert_parameters_close(policy, ref, jax_grads, steps):
    """Trainable parameters against the JAX package's after `steps` Adam
    steps: 1e-5, and lr x steps where the first step's gradient is under 1e-6."""
    tiny = state_dict_from_jax_params(jax.tree_util.tree_map(lambda g: (np.abs(np.asarray(g)) < 1e-6).astype(np.float32), jax_grads))
    held = count = 0
    for name, p in policy.named_parameters():
        if p.requires_grad:
            diff = (p.detach() - ref[name]).abs()
            assert float((diff * (1 - tiny[name])).max()) <= 1e-5, name
            assert float(diff.max()) <= LR * steps * 1.01, name
            held, count = held + int((1 - tiny[name]).sum()), count + p.numel()
    # the tiny ones are unused embedding rows and biases that a softmax cancels (text_k, rgb_kv, depth_kv)
    assert held > 0.7 * count


def _fresh_policy(case):
    """A copy of the port's policy whose parameters all ask for a gradient
    again (masked_adam turns it off for the frozen ones)."""
    return copy.deepcopy(case["policy"])


def test_loss_terms_match_jax(case):
    ref = [float(x) for x in _jax_terms(case, case["params"], case["arrays"])]
    with torch.no_grad():
        got = [float(x) for x in il_loss_terms(case["policy"], *_torch_batch(case["arrays"]))]
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    assert got[1] == 3.0 and got[3] == 5 + 3 + 6  # three envs; the valid steps share the aux denominator


def test_trainable_gradients_match_jax_grad(case, jax_grads):
    policy = _fresh_policy(case)
    masked_adam(LR, policy, case["cfg"].MODEL)
    loss, _, _ = il_losses(policy, *_torch_batch(case["arrays"]))
    loss.backward()
    ref = state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, jax_grads))
    checked = 0
    for name, p in policy.named_parameters():
        if p.requires_grad:
            np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(), atol=1e-5, rtol=1e-4, err_msg=name)
            checked += 1
    assert checked == 39 and float(policy.net.progress_monitor.weight.grad.abs().max()) > 0


def test_frozen_parameters_have_no_grad_and_no_adam_state(case):
    policy = _fresh_policy(case)
    optimizer = masked_adam(LR, policy, case["cfg"].MODEL)
    build_il_train_step(policy, optimizer)(*_torch_batch(case["arrays"]))
    frozen = [n for n, p in policy.named_parameters() if not p.requires_grad]
    assert any(n.startswith("net.rgb_encoder.cnn.") for n in frozen)
    assert any(n.startswith("net.depth_encoder.visual_encoder.") for n in frozen)
    assert "net.instruction_encoder.embedding_layer.weight" in frozen
    for name, p in policy.named_parameters():
        assert (p.grad is None) == (name in frozen), name
        assert (p in optimizer.state) == (name not in frozen), name
    # the same split as the JAX package's mask
    jax_mask = jax.tree_util.tree_leaves(jax_trainable_mask(case["params"], case["jcfg"].MODEL))
    # the frozen BatchNorm's scale, shift and statistics are buffers in the port and leaves of the JAX tree
    buffers = sum(1 for n, _ in policy.named_buffers() if n.startswith("net.rgb_encoder.cnn."))
    assert sum(jax_mask) == len(list(policy.parameters())) - len(frozen)
    assert len(jax_mask) - sum(jax_mask) == len(frozen) + buffers


@pytest.mark.parametrize("steps", [1, 3])
def test_masked_adam_steps_match_jax(case, jax_grads, steps):
    jp = case["jax_policy"]
    tx = jax_masked_adam(LR, case["params"], case["jcfg"].MODEL)
    jax_step = jax_build_il_train_step(jp.module, tx, jp.num_recurrent_layers, jp.hidden_size)
    params = jax.tree_util.tree_map(jnp.array, case["params"])
    state = tx.init(params)
    policy = _fresh_policy(case)
    train_step = build_il_train_step(policy, masked_adam(LR, policy, case["cfg"].MODEL))
    before = {k: v.clone() for k, v in policy.state_dict().items()}
    for _ in range(steps):
        params, state, jax_loss, jax_action, jax_aux = jax_step(params, state, *_jax_batch(case["arrays"]))
        loss, action_loss, aux_loss = train_step(*_torch_batch(case["arrays"]))
        np.testing.assert_allclose([float(loss), float(action_loss), float(aux_loss)],
                                   [float(jax_loss), float(jax_action), float(jax_aux)], atol=1e-5)
    ref = state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    trainable = {n for n, p in policy.named_parameters() if p.requires_grad}
    moved = 0
    _assert_parameters_close(policy, ref, jax_grads, steps)
    for name, value in policy.state_dict().items():
        if name in trainable:
            moved += int(not torch.equal(value, before[name]))
        else:
            assert torch.equal(value, before[name]) and torch.equal(value, ref[name]), name
    assert moved == len(trainable)


def test_all_zero_weight_env_changes_nothing(case):
    """An env slot whose inflection weights are all zero (padding) leaves
    the four terms and every gradient as they were."""
    obs, prev, masks, corrected, weights = case["arrays"]
    pad = lambda a, value=0: np.concatenate([a, np.full_like(a[:, :1], value)], axis=1)  # noqa: E731
    padded = ({k: pad(v, 1) for k, v in obs.items()}, pad(prev), pad(masks, 1), pad(corrected), pad(weights))
    results = []
    for arrays in (case["arrays"], padded):
        policy = _fresh_policy(case)
        masked_adam(LR, policy, case["cfg"].MODEL)
        terms = il_loss_terms(policy, *_torch_batch(arrays))
        (terms[0] / terms[1] + terms[2] / terms[3]).backward()
        results.append(([float(t.detach()) for t in terms], {n: p.grad for n, p in policy.named_parameters() if p.grad is not None}))
    (terms, grads), (padded_terms, padded_grads) = results
    np.testing.assert_allclose(padded_terms, terms, atol=1e-6)
    for name, g in grads.items():
        np.testing.assert_allclose(padded_grads[name].numpy(), g.numpy(), atol=1e-6, err_msg=name)


def test_trainable_mask_raises_for_a_missing_anchor_as_jax_does(case):
    policy = _fresh_policy(case)
    policy.net.rgb_encoder.backbone = policy.net.rgb_encoder.cnn  # the module renamed
    del policy.net.rgb_encoder.cnn
    with pytest.raises(ValueError, match="config freezes .*net.rgb_encoder.cnn"):
        trainable_mask(policy, case["cfg"].MODEL)
    renamed = {k: v for k, v in case["params"]["net"]["rgb_encoder"].items() if k != "cnn"}
    jax_params = {**case["params"], "net": {**case["params"]["net"], "rgb_encoder": {**renamed, "backbone": 0}}}
    with pytest.raises(ValueError, match="config freezes .*rgb_encoder/cnn"):
        jax_trainable_mask(jax_params, case["jcfg"].MODEL)
    # without a config every parameter trains, in both packages
    assert all(trainable_mask(case["policy"], None).values())
    assert all(jax.tree_util.tree_leaves(jax_trainable_mask(case["params"], None)))


def test_an_encoder_without_a_token_table_freezes_none(case):
    """With precomputed instruction features (sensor_uuid rxr_instruction)
    the encoder has no table: the default flags must not make the mask raise."""
    policy = _fresh_policy(case)
    del policy.net.instruction_encoder.embedding_layer
    cfg = case["cfg"].clone().defrost()
    with pytest.raises(ValueError, match="net.instruction_encoder.embedding"):
        trainable_mask(policy, cfg.MODEL)
    cfg.MODEL.INSTRUCTION_ENCODER.sensor_uuid = "rxr_instruction"
    mask = trainable_mask(policy, cfg.MODEL)
    assert all(v for k, v in mask.items() if k.startswith("net.instruction_encoder."))


def test_trainable_encoders_and_embeddings_follow_the_config(case):
    cfg = case["cfg"].clone().defrost()
    cfg.MODEL.RGB_ENCODER.trainable = True
    cfg.MODEL.INSTRUCTION_ENCODER.fine_tune_embeddings = True
    mask = trainable_mask(case["policy"], cfg.MODEL)
    assert mask["net.rgb_encoder.cnn.0.weight"] and mask["net.instruction_encoder.embedding_layer.weight"]
    assert not mask["net.depth_encoder.visual_encoder.backbone.conv1.0.weight"]


def test_accumulation_step_equals_plain_step_at_scale_one(case):
    results = []
    for accumulate in (False, True):
        policy = _fresh_policy(case)
        optimizer = masked_adam(LR, policy, case["cfg"].MODEL)
        if accumulate:
            optimizer.zero_grad()
            losses = build_il_accum_step(policy, optimizer, apply=True)(1.0, *_torch_batch(case["arrays"]))
        else:
            losses = build_il_train_step(policy, optimizer)(*_torch_batch(case["arrays"]))
        results.append(([float(x) for x in losses], policy.state_dict()))
    assert results[0][0] == results[1][0]
    assert all(torch.equal(v, results[1][1][k]) for k, v in results[0][1].items())


def test_accumulation_over_two_batches_matches_jax(case, jax_grads):
    """Two half-scaled accumulation steps, the second applying: the port's
    parameters against the JAX package's accumulation step."""
    jp = case["jax_policy"]
    tx = jax_masked_adam(LR, case["params"], case["jcfg"].MODEL)
    params = jax.tree_util.tree_map(jnp.array, case["params"])
    state, accum = tx.init(params), jax.tree_util.tree_map(jnp.zeros_like, params)
    policy = _fresh_policy(case)
    optimizer = masked_adam(LR, policy, case["cfg"].MODEL)
    optimizer.zero_grad()
    for apply in (False, True):
        jax_step = jax_build_il_accum_step(jp.module, tx, jp.num_recurrent_layers, jp.hidden_size, apply=apply)
        params, state, accum, *_ = jax_step(params, state, accum, 2.0, *_jax_batch(case["arrays"]))
        build_il_accum_step(policy, optimizer, apply=apply)(2.0, *_torch_batch(case["arrays"]))
    ref = state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    _assert_parameters_close(policy, ref, jax_grads, 1)
    assert all(p.grad is None for p in policy.parameters())  # cleared after the applying step


def test_clip_by_global_norm_matches_optax():
    rng = np.random.RandomState(0)
    grads = [rng.randn(3, 4).astype(np.float32) * 5, rng.randn(7).astype(np.float32)]
    for max_norm in (1.0, 1e3):
        params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g.copy())
        norm = clip_by_global_norm_(params, max_norm)
        ref, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], optax.EmptyState())
        np.testing.assert_allclose(float(norm), float(optax.global_norm([jnp.asarray(g) for g in grads])), rtol=1e-6)
        for p, r in zip(params, ref):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(r), rtol=1e-6, atol=1e-7)
