"""The port's RxR CMA act step as a whole against the JAX package.

`make_fused_act_step` (obs transforms + CMAPolicy.act) is held against the
JAX `apply_obs_transforms_batch` + `ILPolicy._act_impl(deterministic=True)`
on the same carried-across weights, for 3 steps with a mask reset on step 2,
in f32 on the CPU. Tolerances: logits and RNN states atol 1e-4 (f32 through
two ResNet18s, summation order differs), greedy actions equal. Sampling is
checked by frequencies, since jax.random and torch draw different bits.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from vlnce_tpu.ops.obs_transforms import apply_obs_transforms_batch as jax_apply_batch
from vlnce_torch.models.distributions import Categorical
from vlnce_torch.trainers.base_trainer import make_fused_act_step

from tests.torch_port_cases import build_pair, observations, to_torch

B = 4
ATOL = 1e-4


def _jax_act_step(jax_policy, jax_transforms):
    @jax.jit
    def step(params, obs, rnn_states, prev_actions, masks):
        batch = jax_apply_batch(obs, jax_transforms)
        logits, _, _ = jax_policy.module.apply({"params": params}, batch, rnn_states, prev_actions, masks)
        action, rnn_out = jax_policy._act_impl(params, batch, rnn_states, prev_actions, masks, jax.random.PRNGKey(0), True)
        return action, rnn_out, logits

    return step


def test_fused_act_step_matches_jax_over_three_steps():
    (jax_policy, jax_transforms, params), (policy, transforms), cfg = build_pair(seed=0)
    jax_step = _jax_act_step(jax_policy, jax_transforms)
    act_step = make_fused_act_step(policy, transforms)

    rng = np.random.RandomState(0)
    rnn_j = jnp.zeros((B, 2, 64), jnp.float32)
    rnn_t = policy.initial_rnn_states(B)
    prev = np.zeros((B, 1), np.int64)
    step_masks = [np.zeros((B, 1), np.float32), np.ones((B, 1), np.float32), np.array([[1.0], [0.0], [1.0], [0.0]], np.float32)]
    for masks in step_masks:
        obs = observations(rng, B, cfg.TASK_CONFIG)
        a_j, rnn_j, logits_j = jax_step(params, {k: jnp.asarray(v) for k, v in obs.items()}, rnn_j,
                                        jnp.asarray(prev.astype(np.int32)), jnp.asarray(masks))
        a_t, rnn_t, logits_t = act_step(to_torch(obs), rnn_t, torch.from_numpy(prev), torch.from_numpy(masks), deterministic=True)
        np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), atol=ATOL)
        np.testing.assert_allclose(rnn_t.numpy(), np.asarray(rnn_j), atol=ATOL)
        np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
        assert float(np.abs(np.asarray(logits_j)).max()) > 1e-2  # the logits are not trivially small
        prev = a_t.numpy().astype(np.int64)


def test_sampled_actions_follow_probs():
    logits = torch.tensor([[2.0, 0.5, -1.0, 0.0, 1.0, -3.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0]])
    dist = Categorical(logits.repeat(20000, 1))
    actions = dist.sample(torch.Generator().manual_seed(0)).reshape(20000, 2)
    for row in range(2):
        freq = np.bincount(actions[:, row].numpy(), minlength=6) / 20000.0
        np.testing.assert_allclose(freq, torch.softmax(logits[row], -1).numpy(), atol=0.015)
