"""The port's rollout storage and PPO update (WDDPPO) against the JAX
package's, on the CPU, for the small 1-wpn-cc policy with the same weights
in both packages (tests/torch_port_cases.build_waypoint_pair).

- The rollout storage: inserts, GAE and plain returns, after_update, and the
  recurrent generator's env columns from the same `np.random.RandomState`,
  exactly (both are numpy).
- The optimizer's and the loss's forms for a captured step on the card,
  here on the CPU: WDDPPO's plain Adam, the clip range as a float64 scalar
  tensor giving the float's numbers, the learning rate written into a
  tensor following the float schedule and the JAX package's optax one, and
  a capturable Adam keeping its form across `load_state_dict`.
- One update over rollouts the port's own policy collected (sampled
  actions, their log-probs, values and states), with linear clip and LR
  decay on: the first minibatch's loss stats within 1e-5 and its gradients
  at atol 1e-5 / rtol 1e-4 (as tests/test_torch_il_step.py holds the IL
  step), the update's mean stats within 1e-5, and the parameters after its
  four Adam steps within 1e-5 where the first minibatch's JAX gradient is
  not negligible (above 1e-6). Where it is, Adam's first step divides a
  rounding difference by |g| and its sign may flip, so those elements are
  held to the steps' own bound, 2 x lr x steps.
"""

import numpy as np
import pytest
import torch
from gymnasium import spaces as gym_spaces

import jax
import jax.numpy as jnp

import optax

from vlnce_tpu.rl.ppo import WDDPPO as JaxWDDPPO
from vlnce_tpu.rl.rollout_storage import ActionDictRolloutStorage as JaxStorage
from vlnce_torch.envs import spaces as port_spaces
from vlnce_torch.models.convert import state_dict_from_jax_params
from vlnce_torch.parallel.optim import masked_adam
from vlnce_torch.rl.ppo import STAT_KEYS, WDDPPO
from vlnce_torch.rl.rollout_storage import ActionDictRolloutStorage

from tests.torch_port_cases import WP_H, build_waypoint_pair, waypoint_observations, waypoint_space

N, T = 4, 3  # envs, rollout steps
PPO_OPTS = ("RL.PPO.num_steps", T, "RL.PPO.num_mini_batch", 2, "RL.PPO.ppo_epoch", 2, "RL.NUM_UPDATES", 2,
            "RL.PPO.use_linear_lr_decay", True, "RL.PPO.use_linear_clip_decay", True,
            "RL.PPO.use_normalized_advantage", True)
UPDATE_IDX = 1


def _storages():
    """Both packages' storages over the waypoint space at 8x8 frames."""
    return (JaxStorage(T, N, waypoint_space(gym_spaces, img=8), WP_H, num_recurrent_layers=2),
            ActionDictRolloutStorage(T, N, waypoint_space(port_spaces, img=8), WP_H, num_recurrent_layers=2))


def _seeded_step(rng):
    """One insert's arguments: observations, states, actions, log-probs,
    values, rewards and masks with episode ends."""
    return (waypoint_observations(rng, N, img=8), rng.randn(N, 2, WP_H).astype(np.float32),
            {"pano": rng.randint(0, 13, (N, 1)).astype(np.float32),
             "offset": rng.uniform(-0.2, 0.2, (N, 1)).astype(np.float32),
             "distance": rng.uniform(0.25, 4.0, (N, 1)).astype(np.float32)},
            -rng.rand(N, 1).astype(np.float32) * 3, rng.randn(N, 1).astype(np.float32),
            rng.randn(N, 1).astype(np.float32), (rng.rand(N, 1) > 0.3).astype(np.float32))


def _assert_storages_equal(a, b):
    for name in ("recurrent_hidden_states", "rewards", "value_preds", "returns", "action_log_probs", "masks"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
    for group in ("observations", "actions", "prev_actions"):
        ga, gb = getattr(a, group), getattr(b, group)
        assert sorted(ga) == sorted(gb), group
        for k in ga:
            np.testing.assert_array_equal(ga[k], gb[k], err_msg=f"{group}/{k}")
    assert a.step == b.step


@pytest.mark.parametrize("use_gae", [True, False])
def test_rollout_storage_matches_jax(use_gae):
    """Inserts with episode ends, returns, the recurrent generator's samples
    (the same env columns from the same RandomState), and after_update."""
    jax_store, store = _storages()
    rng = np.random.RandomState(0)
    for _ in range(T):
        step = _seeded_step(rng)
        jax_store.insert(*step)
        store.insert(*step)
    next_value = rng.randn(N, 1).astype(np.float32)
    for s in (jax_store, store):
        s.compute_returns(next_value, use_gae, gamma=0.99, tau=0.95)
    _assert_storages_equal(jax_store, store)
    advantages = store.returns[:-1] - store.value_preds[:-1]
    jax_samples = list(jax_store.recurrent_generator(advantages, 2, np.random.RandomState(7)))
    samples = list(store.recurrent_generator(advantages, 2, np.random.RandomState(7)))
    assert len(samples) == len(jax_samples) == 2
    for got, ref in zip(samples, jax_samples):
        assert got[-2:] == ref[-2:] == (T, N // 2)
        for a, b in zip(got[:-2], ref[:-2]):
            if isinstance(a, dict):
                assert sorted(a) == sorted(b)
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                np.testing.assert_array_equal(a, b)
    for s in (jax_store, store):
        s.after_update()
    _assert_storages_equal(jax_store, store)


@pytest.fixture(scope="module")
def case():
    """The small 1-wpn-cc pair with PPO_OPTS, both packages' WDDPPO, and a
    rollout of T steps at N envs collected by the port's policy (sampled
    actions), in both packages' storages with returns computed."""
    (jax_policy, params), policy, (jcfg, cfg) = build_waypoint_pair("1-wpn-cc", seed=3, extra=PPO_OPTS)
    ppo = cfg.RL.PPO
    coefs = dict(offset_regularize_coef=ppo.offset_regularize_coef, pano_entropy_coef=ppo.pano_entropy_coef,
                 offset_entropy_coef=ppo.offset_entropy_coef, distance_entropy_coef=ppo.distance_entropy_coef,
                 num_updates=int(cfg.RL.NUM_UPDATES))
    jax_agent = JaxWDDPPO(jax_policy, jcfg.RL.PPO, mesh=None, **coefs)
    agent = WDDPPO(policy, ppo, **coefs)

    jax_space, port_space = waypoint_space(gym_spaces), waypoint_space(port_spaces)
    jax_store = JaxStorage(T, N, jax_space, WP_H, num_recurrent_layers=2)
    store = ActionDictRolloutStorage(T, N, port_space, WP_H, num_recurrent_layers=2)
    rng = np.random.RandomState(9)
    generator = torch.Generator().manual_seed(9)
    obs = waypoint_observations(rng, N)
    hist = {k: np.zeros((N,) + port_space[k].shape, port_space[k].dtype) for k in ("rgb_history", "depth_history")}
    first = {**obs, **hist}
    for s in (jax_store, store):
        for k, v in first.items():
            s.observations[k][0] = v
    for t in range(T):
        cur = {k: torch.from_numpy(v[t]) for k, v in store.observations.items()}
        out = policy.act(cur, torch.from_numpy(store.recurrent_hidden_states[t]),
                         {k: torch.from_numpy(v[t]) for k, v in store.prev_actions.items()},
                         torch.from_numpy(store.masks[t]), deterministic=False, generator=generator)
        nxt = {**waypoint_observations(rng, N), **{k: rng.rand(*v.shape).astype(v.dtype) * (255 if v.dtype == np.uint8 else 1)
                                                   for k, v in hist.items()}}
        rewards = rng.randn(N, 1).astype(np.float32)
        masks = (rng.rand(N, 1) > 0.25).astype(np.float32)
        args = (nxt, out["rnn_states"].numpy(), {k: v.numpy() for k, v in out["action_elements"].items()},
                out["action_log_probs"].numpy(), out["value"].numpy(), rewards, masks)
        for s in (jax_store, store):
            s.insert(*args)
    next_value = rng.randn(N, 1).astype(np.float32)
    for s in (jax_store, store):
        s.compute_returns(next_value, ppo.use_gae, ppo.gamma, ppo.tau)
    return {"jax_agent": jax_agent, "agent": agent, "params": params, "policy": policy, "jax_store": jax_store,
            "store": store, "cfg": cfg}


@pytest.fixture(scope="module")
def first_minibatch(case):
    """The update's first minibatch (the same env columns in both packages)
    and the JAX package's gradients and stats on it, through its own
    grads-only entry, with the gradients in the port's names."""
    agent, jax_agent, store = case["agent"], case["jax_agent"], case["store"]
    advantages = agent.get_advantages(store)
    np.testing.assert_array_equal(advantages, jax_agent.get_advantages(case["jax_store"]))
    *arrays, T_, n = next(store.recurrent_generator(advantages, 2, np.random.RandomState(11)))
    clip = agent.clip_param(UPDATE_IDX)
    grads, stats = jax_agent._build_grads(T_)(case["params"], jax.tree_util.tree_map(jnp.asarray, tuple(arrays)),
                                              jnp.ones((n,), jnp.float32), jnp.float32(clip))
    grads = state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, grads), "WaypointPolicy")
    return {"arrays": arrays, "T": T_, "clip": clip, "jax_grads": grads, "jax_stats": stats}


def test_first_minibatch_gradients_match_jax(case, first_minibatch):
    """The first minibatch's loss stats within 1e-5 and every trainable
    gradient at atol 1e-5 / rtol 1e-4; the clip range decayed to half at
    update 1 of 2."""
    agent, policy, mb = case["agent"], case["policy"], first_minibatch
    assert mb["clip"] == pytest.approx(case["cfg"].RL.PPO.clip_param * 0.5)
    policy.zero_grad(set_to_none=True)
    total, stats = agent.loss(agent.upload(mb["arrays"]), mb["clip"], mb["T"])
    total.backward()
    np.testing.assert_allclose([float(stats[k].detach()) for k in STAT_KEYS],
                               [float(mb["jax_stats"][k]) for k in STAT_KEYS], atol=1e-5)
    ref, checked = mb["jax_grads"], 0
    for name, p in policy.named_parameters():
        if p.requires_grad:
            assert p.grad is not None, name
            np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(), atol=1e-5, rtol=1e-4, err_msg=name)
            checked += 1
        else:
            assert float(ref[name].abs().max()) == 0.0, name  # frozen: JAX's stop_gradient gives exact zeros
    assert checked > 40
    policy.zero_grad(set_to_none=True)


def test_update_matches_jax(case, first_minibatch):
    """One whole update (ppo_epoch 2 x num_mini_batch 2 Adam steps, clip and
    LR decayed at update_idx 1) from the same weights and minibatch draws:
    the mean stats within 1e-5; the parameters after it within 1e-5 where
    the first minibatch's JAX gradient exceeds 1e-6, and within 2 x lr x
    steps elsewhere; frozen parameters bit-equal; Adam's step count and
    learning rate as JAX's schedule has them."""
    agent, jax_agent, policy = case["agent"], case["jax_agent"], case["policy"]
    before = {k: v.clone() for k, v in policy.state_dict().items()}
    jax_stats = jax_agent.update(case["jax_store"], np.random.RandomState(11), update_idx=UPDATE_IDX)
    stats = agent.update(case["store"], np.random.RandomState(11), update_idx=UPDATE_IDX)
    np.testing.assert_allclose([stats[k] for k in STAT_KEYS], [jax_stats[k] for k in STAT_KEYS], atol=1e-5)
    ppo = case["cfg"].RL.PPO
    steps = ppo.ppo_epoch * ppo.num_mini_batch
    assert agent.optimizer_steps == steps
    # the last step's rate: lr x (1 - (steps - 1) / (NUM_UPDATES x steps)), as optax's linear schedule
    assert agent.optimizer.param_groups[0]["lr"] == pytest.approx(ppo.lr * (1 - (steps - 1) / (2 * steps)))
    ref = state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, jax_agent.policy.params), "WaypointPolicy")
    tiny = {k: (g.abs() < 1e-6).float() for k, g in first_minibatch["jax_grads"].items()}
    loose = count = 0
    for name, value in policy.state_dict().items():
        p = dict(policy.named_parameters()).get(name)
        if p is not None and p.requires_grad:
            diff = (value - ref[name]).abs()
            assert float((diff * (1 - tiny[name])).max()) <= 1e-5, name
            assert float(diff.max()) <= 2 * ppo.lr * steps, name
            assert not torch.equal(value, before[name]), name
            loose, count = loose + int((diff > 1e-5).sum()), count + value.numel()
        else:
            assert torch.equal(value, before[name]) and torch.equal(value, ref[name]), name
    # the looser bound serves few: half the elements have |g| < 1e-6 at
    # this size (dead ReLU units, the attention queries and keys that a
    # softmax over near-equal energies cancels), most of them exactly 0 in
    # both packages
    assert loose < 0.1 * count, (loose, count)


def _coefs(cfg):
    ppo = cfg.RL.PPO
    return dict(offset_regularize_coef=ppo.offset_regularize_coef, pano_entropy_coef=ppo.pano_entropy_coef,
                offset_entropy_coef=ppo.offset_entropy_coef, distance_entropy_coef=ppo.distance_entropy_coef,
                num_updates=int(cfg.RL.NUM_UPDATES))


def test_wddppo_builds_plain_adam_on_the_cpu(case):
    """On the CPU WDDPPO's Adam is the one it built before the captured step
    existed: not capturable, a float learning rate, torch's betas, the
    config's eps, every trainable parameter in its one group; and its
    counters of captures and replays start at 0."""
    policy, cfg = case["policy"], case["cfg"]
    agent = WDDPPO(policy, cfg.RL.PPO, **_coefs(cfg))
    group, = agent.optimizer.param_groups
    assert group["capturable"] is False and isinstance(group["lr"], float) and group["lr"] == cfg.RL.PPO.lr
    assert group["betas"] == (0.9, 0.999) and group["eps"] == cfg.RL.PPO.eps and not group["fused"]
    assert group["params"] == [p for p in policy.parameters() if p.requires_grad]
    assert not agent.eager and agent.captures == agent.replayed_steps == 0 and not agent.optimizer.state


@pytest.mark.parametrize("scale", [1.0, 0.5, 0.37, 0.0])
def test_loss_takes_the_clip_range_as_a_device_scalar(case, first_minibatch, scale):
    """The loss, its six stats and every gradient are the same bits with the
    clip range as a float and as the 0-d float64 tensor a captured step
    fills, at the configured range and decayed ones."""
    agent, policy, mb = case["agent"], case["policy"], first_minibatch
    clip = case["cfg"].RL.PPO.clip_param * scale
    sample = agent.upload(mb["arrays"])
    runs = []
    for c in (clip, torch.tensor(clip, dtype=torch.float64)):
        policy.zero_grad(set_to_none=True)
        total, stats = agent.loss(sample, c, mb["T"])
        total.backward()
        runs.append((total.detach(), {k: v.detach() for k, v in stats.items()},
                     {n: p.grad.clone() for n, p in policy.named_parameters() if p.grad is not None}))
    policy.zero_grad(set_to_none=True)
    (t0, s0, g0), (t1, s1, g1) = runs
    assert torch.equal(t0, t1) and all(torch.equal(s0[k], s1[k]) for k in STAT_KEYS)
    assert sorted(g0) == sorted(g1) and len(g0) > 40 and all(torch.equal(g0[n], g1[n]) for n in g0)


def test_set_lr_into_a_tensor_follows_the_float_and_optax_schedules(case):
    """Linear LR decay written by `_set_lr` into a capturable Adam's tensor
    (built here on the CPU; only its step needs the card) reads, at every
    optimizer step and past the last, the float schedule rounded to
    float32, and the JAX package's optax.linear_schedule within 1e-6 of the
    initial rate."""
    policy, cfg = case["policy"], case["cfg"]
    ppo = cfg.RL.PPO
    floats = WDDPPO(policy, ppo, **_coefs(cfg))
    tensors = WDDPPO(policy, ppo, **_coefs(cfg))
    tensors.optimizer = masked_adam(ppo.lr, policy, policy.config.MODEL, eps=ppo.eps, max_grad_norm=ppo.max_grad_norm,
                                    capturable=True)
    rate = tensors.optimizer.param_groups[0]["lr"]
    assert torch.is_tensor(rate) and rate.dim() == 0 and tensors.optimizer.param_groups[0]["capturable"]
    steps = int(cfg.RL.NUM_UPDATES) * ppo.ppo_epoch * ppo.num_mini_batch
    assert floats._lr_steps == tensors._lr_steps == steps
    schedule = optax.linear_schedule(init_value=ppo.lr, end_value=0.0, transition_steps=steps)
    for step in range(steps + 2):
        floats.optimizer_steps = tensors.optimizer_steps = step
        floats._set_lr()
        tensors._set_lr()
        assert tensors.optimizer.param_groups[0]["lr"] is rate  # written in place: a replay reads it
        assert float(rate) == float(np.float32(floats.optimizer.param_groups[0]["lr"])), step
        assert float(rate) == pytest.approx(float(schedule(step)), abs=1e-6 * ppo.lr), step


def test_capturable_adam_keeps_its_form_across_load_state_dict():
    """A capturable Adam loading a plain one's state keeps its own rate
    tensor (the saved rate copied in), `capturable` and its step counts on
    the parameters' device; a plain one loading a capturable one's state
    keeps a float rate and stays plain; the moments load as they were."""
    torch.manual_seed(0)
    plain = masked_adam(1e-3, torch.nn.Linear(3, 2), None)
    graphable = masked_adam(5e-4, torch.nn.Linear(3, 2), None, capturable=True)
    rate = graphable.param_groups[0]["lr"]
    for p in plain.param_groups[0]["params"]:
        p.grad = torch.randn_like(p)
    plain.step()
    graphable.load_state_dict(plain.state_dict())
    group, = graphable.param_groups
    assert group["lr"] is rate and float(rate) == pytest.approx(1e-3) and group["capturable"] is True
    for p, q in zip(group["params"], plain.param_groups[0]["params"]):
        st = graphable.state[p]
        assert st["step"].dtype == torch.float32 and st["step"].device == p.device and float(st["step"]) == 1.0
        assert torch.equal(st["exp_avg"], plain.state[q]["exp_avg"])
    rate.fill_(2e-4)
    plain.load_state_dict(graphable.state_dict())
    group, = plain.param_groups
    assert isinstance(group["lr"], float) and group["lr"] == pytest.approx(2e-4) and group["capturable"] is False
