"""Data-parallel training across two gloo ranks on the CPU
(vlnce_torch/parallel/mp_smoke.py): the IL update and the PPO minibatch of
two ranks, each on half of one deterministic global batch, against the JAX
package's single-device step on the whole batch with the same weights; the
resident DAgger and resident recollect `train()` of two ranks; the
DD-PPO waypoint trainer's `train()` of two ranks; the rank gating of
checkpoints; the time padding helpers against JAX's; and the PPO
loss over the global count on equal ranks in one process.

One module-scoped launch runs every mode in one rank pair (about 25 s).
Tolerances: losses and stats 1e-5 relative; gradients atol 1e-5, rtol
1e-4 (the IL step's parity test's: two frameworks' summation orders through
the biLSTM and the GRUs). The two ranks agree with each other bit for bit.
"""

import numpy as np
import pytest
import torch
from gymnasium import spaces as gym_spaces

import jax
import jax.numpy as jnp

from vlnce_torch.models.convert import state_dict_from_jax_params
from vlnce_torch.parallel import il_step, mp_smoke
from vlnce_torch.utils.checkpoints import save_checkpoint
from vlnce_tpu.config import get_config as jax_get_config
from vlnce_tpu.models.cma_policy import CMAPolicy as JaxCMAPolicy
from vlnce_tpu.parallel import il_step as jax_il_step
from vlnce_tpu.rl.ppo import WDDPPO as JaxWDDPPO

from tests.torch_port_cases import EqualRanks, _perturb, build_waypoint_pair

MODES = "il,ppo,resident_recollect,resident_dagger,ddppo"


def _jax_il_case():
    """The JAX mp_smoke's R2R CMA (f32) with perturbed weights, and its space."""
    jcfg = jax_get_config(opts=mp_smoke.IL_SMALL_OPTS + ["TPU.PRECISION.compute_dtype", "float32"])
    _, space = mp_smoke.il_config()
    jspace = gym_spaces.Dict({k: gym_spaces.Box(0, 1, s.shape, s.dtype) for k, s in space.spaces.items()})
    policy = JaxCMAPolicy.from_config(jcfg, jspace, gym_spaces.Discrete(4))
    params = policy.init_params(jax.random.PRNGKey(0), batch_size=1)
    params = _perturb(jax.tree_util.tree_map(np.asarray, params), np.random.RandomState(0))
    policy.params = params
    return policy, params, space


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    il_policy, il_params, space = _jax_il_case()
    save_checkpoint(str(tmp / "il.ckpt"), state_dict_from_jax_params(il_params))
    (wp_policy, wp_params), port_wp, (wjcfg, wcfg) = build_waypoint_pair("1-wpn-cc", extra=mp_smoke.PPO_ONE_MINIBATCH)
    rank_cfg = mp_smoke.ppo_config()[0]  # the ranks build this very policy
    for key in ("MODEL", "RL", "TASK_CONFIG", "CUDA"):
        assert wcfg[key].dump() == rank_cfg[key].dump(), key
    save_checkpoint(str(tmp / "ppo.ckpt"), port_wp.state_dict())
    results = mp_smoke.launch(MODES, timeout=240, extra_env={
        "MP_SMOKE_OUT": str(tmp), "MP_SMOKE_IL_CKPT": str(tmp / "il.ckpt"), "MP_SMOKE_PPO_CKPT": str(tmp / "ppo.ckpt"),
    })
    return {"tmp": tmp, "results": results, "il": (il_policy, il_params, space), "ppo": (wp_policy, wp_params, wjcfg)}


def _grads(runs, mode):
    out = []
    for rank in range(2):
        with np.load(runs["tmp"] / f"{mode}_grads_rank{rank}.npz") as f:
            out.append({k: f[k] for k in f.files})
    return out


def _assert_grads_close(ours, jax_grads, policy_name):
    want = {k: v.numpy() for k, v in state_dict_from_jax_params(jax_grads, policy_name).items()}
    assert ours and set(ours) <= set(want)
    for name, g in ours.items():
        np.testing.assert_allclose(g, want[name], atol=1e-5, rtol=1e-4, err_msg=name)


def test_il_update_of_two_ranks_equals_jax_on_the_whole_batch(runs):
    policy, params, space = runs["il"]
    r0, r1 = runs["results"]["il"]
    assert r0["ranks"] == r1["ranks"] == 2
    assert r0["loss"] == r1["loss"]  # the all_reduce'd losses, the same bits on both ranks
    # rank 1's slice has no weight in its last step: it cut its batch to
    # T=3, and prepare_global_batch padded it back to the agreed T
    assert (r0["t_local"], r1["t_local"]) == (4, 3) and r0["t_global"] == r1["t_global"] == 4

    obs, prev, masks, corrected, weights = mp_smoke.global_batch(space)
    batch = ({k: jnp.asarray(v) for k, v in obs.items()}, jnp.asarray(prev, jnp.int32), jnp.asarray(masks),
             jnp.asarray(corrected, jnp.int32), jnp.asarray(weights))

    def loss_fn(p):
        a_num, a_den, x_num, x_den = jax_il_step._il_loss_terms(
            policy.module, p, *batch, policy.num_recurrent_layers, policy.hidden_size)
        action, aux = a_num / jnp.maximum(a_den, 1.0), x_num / jnp.maximum(x_den, 1.0)
        return action + aux, (action, aux)

    (loss, (action, aux)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    np.testing.assert_allclose(r0["loss"], [float(loss), float(action), float(aux)], rtol=1e-5)

    g0, g1 = _grads(runs, "il")
    assert g0.keys() == g1.keys() and all(np.array_equal(g0[k], g1[k]) for k in g0)
    _assert_grads_close(g0, grads, "CMAPolicy")


def test_ppo_minibatch_of_two_ranks_equals_jax_on_the_whole_batch(runs):
    policy, params, jcfg = runs["ppo"]
    r0, r1 = runs["results"]["ppo"]
    assert r0["ranks"] == 2 and r0["grads_stats"] == r1["grads_stats"] and r0["update_stats"] == r1["update_stats"]

    ppo = jcfg.RL.PPO
    agent = JaxWDDPPO(policy, ppo, mesh=None, offset_regularize_coef=ppo.offset_regularize_coef,
                      pano_entropy_coef=ppo.pano_entropy_coef, offset_entropy_coef=ppo.offset_entropy_coef,
                      distance_entropy_coef=ppo.distance_entropy_coef, num_updates=int(jcfg.RL.NUM_UPDATES))
    batch = mp_smoke.ppo_global_batch(mp_smoke.ppo_agent())
    tree = lambda v: {k: jnp.asarray(x) for k, x in v.items()}  # noqa: E731
    sample = (tree(batch["obs"]), jnp.asarray(batch["hidden0"]), tree(batch["actions"]), tree(batch["prev_actions"]),
              *(jnp.asarray(batch[k]) for k in ("value_preds", "returns", "masks", "old_log_probs", "advantages")))
    valid = jnp.ones((mp_smoke.PPO_N_GLOBAL,), jnp.float32)
    grads, stats = agent._build_grads(mp_smoke.PPO_T)(params, sample, valid, jnp.float32(ppo.clip_param))
    for k, v in r0["grads_stats"].items():
        np.testing.assert_allclose(v, float(stats[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    # the update's one minibatch is the same data (permuted env order)
    for k, v in r0["update_stats"].items():
        np.testing.assert_allclose(v, r0["grads_stats"][k], rtol=1e-5, atol=1e-7, err_msg=k)

    g0, g1 = _grads(runs, "ppo")
    assert g0.keys() == g1.keys() and all(np.array_equal(g0[k], g1[k]) for k in g0)
    _assert_grads_close(g0, grads, "WaypointPolicy")


@pytest.mark.parametrize("mode", ["resident_dagger", "resident_recollect"])
def test_resident_train_of_two_ranks_takes_disjoint_slices_with_equal_losses(runs, mode):
    r0, r1 = runs["results"][mode]
    assert r0["ids"] and len(r0["ids"]) == len(r1["ids"])
    assert not set(r0["ids"]) & set(r1["ids"])  # disjoint rank slices
    assert sorted(r0["ids"] + r1["ids"]) == sorted(str(i) for i in range(4))  # that cover the plan
    assert r0["losses"] and r0["losses"] == r1["losses"]
    assert np.isfinite(np.asarray(r0["losses"])).all()
    if mode == "resident_dagger":
        assert r0["bank_episodes"] == r1["bank_episodes"] == 2


def test_ddppo_train_of_two_ranks_ends_with_equal_weights(runs):
    """The DD-PPO waypoint trainer's train(), one update with the rollout on
    the card and PPO_UPDATE_SCAN asked for (single-process: the ranks take
    update_device): the summed stats and the final weights equal on both
    ranks, each rank counting its own env steps."""
    r0, r1 = runs["results"]["ddppo"]
    assert r0["ranks"] == r1["ranks"] == 2
    assert len(r0["updates"]) == 1 and r0["updates"] == r1["updates"]
    assert r0["updates"][0]["count_steps"] == 2 * r0["n_envs"]  # T=2 steps of this rank's envs
    assert all(np.isfinite(v) for v in r0["updates"][0].values())
    assert r0["params"] == r1["params"]


@pytest.mark.parametrize("mode", ["resident_dagger", "resident_recollect", "ddppo"])
def test_only_rank_0_writes_checkpoints(runs, mode):
    r0, r1 = runs["results"][mode]
    assert r0["checkpoints"] == ["ckpt.0.ckpt"] and r1["checkpoints"] == []
    assert (runs["tmp"] / f"{mode}_rank0" / "ckpts" / "ckpt.0.ckpt").is_file()
    assert not (runs["tmp"] / f"{mode}_rank1" / "ckpts").exists() or not any(
        (runs["tmp"] / f"{mode}_rank1" / "ckpts").iterdir())


# ------------------------------------------------------- the padding helpers
def _il_arrays(T=5, N=3, seed=0):
    rng = np.random.RandomState(seed)
    obs = {"rgb": rng.randint(0, 255, (T, N, 4, 4, 3)).astype(np.uint8), "progress": rng.rand(T, N, 1).astype(np.float32)}
    return (obs, rng.randint(0, 4, (T, N)).astype(np.int64), rng.rand(T, N).astype(np.float32),
            rng.randint(0, 4, (T, N)).astype(np.int64), rng.rand(T, N).astype(np.float32))


def _to(lib, arrays):
    obs, *rest = arrays
    conv = torch.from_numpy if lib == "torch" else jnp.asarray
    return ({k: conv(v) for k, v in obs.items()}, *(conv(v) for v in rest))


def _assert_batches_equal(ours, theirs):
    (o, *rest), (jo, *jrest) = ours, theirs
    assert sorted(o) == sorted(jo)
    for a, b in [(o[k], jo[k]) for k in o] + list(zip(rest, jrest)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("t_target", [5, 6, 9])
def test_pad_time_axis_equals_jax(t_target):
    arrays = _il_arrays()
    _assert_batches_equal(il_step.pad_time_axis(*_to("torch", arrays), t_target=t_target),
                          jax_il_step.pad_time_axis(*_to("jax", arrays), t_target=t_target))


def test_global_max_time_and_prepare_on_one_process():
    assert il_step.global_max_time(None, 7) == jax_il_step.global_max_time(None, 7) == 7
    batch = _to("torch", _il_arrays())
    assert il_step.prepare_global_batch(None, *batch) is not None
    out = il_step.prepare_global_batch(None, *batch)
    assert all(a is b for a, b in zip(out[1:], batch[1:])) and out[0] is batch[0]


@pytest.mark.parametrize("ranks", [1, 2])
def test_ppo_loss_over_the_global_count_on_equal_ranks(ranks):
    """WDDPPO with a mesh of `ranks` ranks that hold the same minibatch, in
    one process: each rank's loss is its sum over the global count of rows
    (1/ranks of one process's mean), and the summed stats and gradients are
    one process's."""
    torch.manual_seed(0)
    one = mp_smoke.ppo_agent()
    agent = mp_smoke.ppo_agent(mesh=EqualRanks(ranks, 0, torch.device("cpu")))
    agent.policy.load_state_dict(one.policy.state_dict())
    batch = mp_smoke.ppo_global_batch(one)
    tree = lambda v: {k: torch.from_numpy(x) for k, x in v.items()}  # noqa: E731
    sample = (tree(batch["obs"]), torch.from_numpy(batch["hidden0"]), tree(batch["actions"]),
              tree(batch["prev_actions"]),
              *(torch.from_numpy(batch[k]) for k in ("value_preds", "returns", "masks", "old_log_probs", "advantages")))
    clip, T = one.clip_param(0), mp_smoke.PPO_T
    with torch.no_grad():
        (total_one, _), (total, _) = one.loss(sample, clip, T), agent.loss(sample, clip, T)
    torch.testing.assert_close(total * ranks, total_one, rtol=1e-6, atol=1e-7)
    for a in (one, agent):
        a.optimizer.zero_grad(set_to_none=True)
    stats_one, stats = one._grads_and_stats(sample, clip, T), agent._grads_and_stats(sample, clip, T)
    torch.testing.assert_close(stats, stats_one, rtol=1e-6, atol=1e-7)
    grads_one = dict(one.policy.named_parameters())
    for name, p in agent.policy.named_parameters():
        if grads_one[name].grad is None:
            assert p.grad is None or not p.grad.any(), name
        else:
            torch.testing.assert_close(p.grad, grads_one[name].grad, rtol=1e-5, atol=1e-7, msg=name)

