"""The port's DD-PPO rollout on the device (rl/device_rollout.py) and its
device PPO update (WDDPPO.update_device_scan) against the
JAX package's, at the smallest size on the CPU, where the port's captured
step runs eagerly and B1's wrapper runs its plain version.

The small 1-wpn-cc policy (tests/torch_port_cases.build_waypoint_pair) at
16x16 frames, N=2 slots, T=3 steps, MAX_EPISODE_STEPS 2 (so that slots
reset inside a rollout), with the stop head scaled so that greedy STOPs
follow what the agent sees. Greedy rollouts are compared: the JAX rollout
draws by a key folded with the step and the port by inverse CDFs of
uniforms drawn beforehand, so sampled ones agree in distribution only.
Tolerances: f32 values rtol 1e-4 (atol 1e-6), RGB equal, depth atol 1e-6;
the update's stats atol 1e-4 and its parameters as tests/test_torch_ppo.py
holds them.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import vlnce_tpu.models  # noqa: F401
import vlnce_tpu.tasks  # noqa: F401
import vlnce_torch.tasks  # noqa: F401
from vlnce_tpu.config.default import add_pano_sensors_to_config as jax_add_pano_sensors
from vlnce_tpu.envs import ensure_registered as jax_ensure_registered
from vlnce_tpu.ops.obs_transforms import get_active_obs_transforms as jax_get_transforms
from vlnce_tpu.rl.device_rollout import DeviceRolloutCollector as JaxCollector
from vlnce_tpu.rl.device_rollout import compute_returns_device as jax_compute_returns
from vlnce_tpu.rl.ppo import WDDPPO as JaxWDDPPO
from vlnce_torch.config import get_config
from vlnce_torch.config.default import add_pano_sensors_to_config
from vlnce_torch.envs import ensure_registered
from vlnce_torch.envs import rl_envs  # noqa: F401  (registers the waypoint env)
from vlnce_torch.envs import spaces as port_spaces
from vlnce_torch.models.convert import state_dict_from_jax_params
from vlnce_torch.ops.obs_transforms import get_active_obs_transforms
from vlnce_torch.registry import registry
from vlnce_torch.rl.device_rollout import DeviceRolloutCollector, compute_returns_device
from vlnce_torch.rl.ppo import STAT_KEYS, WDDPPO
from vlnce_torch.rl.rollout_storage import ActionDictRolloutStorage
from vlnce_torch.trainers import ddppo_waypoint_trainer
from vlnce_torch.utils.checkpoints import load_checkpoint

from tests.torch_port_cases import build_waypoint_pair

jax_ensure_registered()
ensure_registered()

N, T, IMG = 2, 3, 16
OPTS = [
    "NUM_ENVIRONMENTS", N, "RL.PPO.num_steps", T, "TASK_CONFIG.DATASET.NUM_EPISODES", 6,
    "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", 2,
    "TASK_CONFIG.SIMULATOR.RGB_SENSOR.HEIGHT", IMG, "TASK_CONFIG.SIMULATOR.RGB_SENSOR.WIDTH", IMG,
    "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.HEIGHT", IMG, "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.WIDTH", IMG,
    "RL.PPO.num_mini_batch", 2, "RL.PPO.ppo_epoch", 2, "RL.NUM_UPDATES", 2, "RL.PPO.use_linear_lr_decay", True,
    "RL.PPO.use_linear_clip_decay", True, "RL.PPO.use_normalized_advantage", True,
]
ROLLOUTS = 2
RTOL, ATOL = 1e-4, 1e-6


def _np(x):
    return x.detach().cpu().numpy().copy() if isinstance(x, torch.Tensor) else np.asarray(x).copy()


def _tree(batch):
    """A batch dict of tensors or JAX arrays -> the same dict of numpy copies."""
    return {k: _tree(v) if isinstance(v, dict) else _np(v) for k, v in batch.items()}


@pytest.mark.parametrize("use_gae", [True, False])
def test_compute_returns_device_matches_jax_and_the_storage(use_gae):
    rng = np.random.RandomState(0)
    Tn, Bn = 7, 3
    rewards, values = rng.randn(Tn, Bn, 1).astype(np.float32), rng.randn(Tn, Bn, 1).astype(np.float32)
    masks_next = (rng.rand(Tn, Bn, 1) > 0.3).astype(np.float32)
    next_value = rng.randn(Bn, 1).astype(np.float32)
    got = compute_returns_device(*(torch.from_numpy(a) for a in (rewards, values, masks_next, next_value)), 0.99, 0.95,
                                 use_gae).numpy()
    ref = np.asarray(jax_compute_returns(*(jnp.asarray(a) for a in (rewards, values, masks_next, next_value)), 0.99,
                                         0.95, use_gae))
    storage = ActionDictRolloutStorage(Tn, Bn, port_spaces.Dict({"x": port_spaces.Box(0, 1, (1,), np.float32)}), 4)
    storage.rewards[:] = rewards
    storage.value_preds[:Tn] = values
    storage.masks[1:] = masks_next
    storage.step = Tn
    storage.compute_returns(next_value, use_gae, gamma=0.99, tau=0.95)
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_allclose(got, storage.returns[:Tn], atol=1e-5)


@pytest.fixture(scope="module")
def pair():
    """The small policy in both packages with the stop head scaled (gain 20,
    bias -2), the configs with the pano sensors."""
    (jax_policy, params), policy, (jcfg, cfg) = build_waypoint_pair("1-wpn-cc", seed=5, extra=OPTS, img=IMG)
    params = copy.deepcopy(params)
    params["stop_linear"]["kernel"] = (params["stop_linear"]["kernel"] * 20.0).astype(np.float32)
    params["stop_linear"]["bias"] = np.full_like(params["stop_linear"]["bias"], -2.0)
    jax_policy.params = params
    policy.load_state_dict(state_dict_from_jax_params(params, "WaypointPolicy"), strict=True)
    return {"jax_policy": jax_policy, "params": params, "policy": policy, "jcfg": jax_add_pano_sensors(jcfg),
            "cfg": add_pano_sensors_to_config(cfg)}


def _merged(cfg, extra):
    if extra:
        cfg = cfg.clone()
        cfg.defrost()
        cfg.merge_from_list(list(extra))
        cfg.freeze()
    return cfg


def _collector(pair, extra=(), num_envs=N, **kwargs):
    cfg = _merged(pair["cfg"], extra)
    collector = DeviceRolloutCollector(pair["policy"], get_active_obs_transforms(cfg), cfg, num_envs, **kwargs)
    collector.initial_carry_and_obs()
    return collector


def _collect(collector, generator=None):
    """One rollout: (the batch as numpy, the episode stats, the episode rewards)."""
    rewards = np.zeros((collector.B, 1), np.float32)
    stats = {"count": np.zeros((collector.B, 1), np.float32)}
    batch, n = collector.collect_device(rewards, stats, generator)
    assert n == collector.T * collector.B
    return _tree(batch), stats, rewards


def _greedy_runs(pair, rollouts, num_envs=N, extra=(), jax_extra=()):
    """`rollouts` consecutive greedy rollouts of each package, each policy's
    act wrapped on its instance to pass deterministic=True; `extra` and
    `jax_extra` are merged into the port's and JAX's configs."""
    jax_policy, policy = pair["jax_policy"], pair["policy"]
    jax_act, act = jax_policy._act_impl, policy.act
    jax_policy._act_impl = lambda p, o, r, pa, m, key, det: jax_act(p, o, r, pa, m, key, True)
    policy.act = lambda *a, **k: act(*a, **{**k, "deterministic": True})
    try:
        jcfg = _merged(pair["jcfg"], jax_extra)
        jax_collector = JaxCollector(jax_policy, jax_get_transforms(jcfg), jcfg, num_envs)
        jax_collector.initial_carry_and_obs()
        collector = _collector(pair, extra, num_envs)
        runs = {"jax": [], "port": []}
        for r in range(rollouts):
            rewards = np.zeros((num_envs, 1), np.float32)
            stats = {"count": np.zeros((num_envs, 1), np.float32)}
            batch, _ = jax_collector.collect_device(rewards, stats, jax.random.PRNGKey(r))
            carry = [_np(x) for x in jax.tree_util.tree_leaves(jax_collector._carry)]
            runs["jax"].append((_tree(batch), stats, rewards, list(jax_collector._slot_ptr), carry))
            batch, stats, rewards = _collect(collector)
            runs["port"].append((batch, stats, rewards, list(collector._slot_ptr),
                                 {k: _np(v) for k, v in collector._state.items()}))
    finally:
        del jax_policy._act_impl, policy.act
    return runs, collector


@pytest.fixture(scope="module")
def greedy(pair):
    """ROLLOUTS consecutive greedy rollouts of each package."""
    return _greedy_runs(pair, ROLLOUTS)


def _close(got, want, name):
    np.testing.assert_allclose(got, want.reshape(got.shape), rtol=RTOL, atol=ATOL, err_msg=name)


def _assert_greedy_runs_match(runs):
    """Each rollout's batch, episode stats and rewards, slot pointers and
    final carry equal JAX's; returns the rollouts' pano actions."""
    panos = []
    for r, (port, ref) in enumerate(zip(runs["port"], runs["jax"])):
        batch, stats, rewards, slot_ptr, state = port
        jbatch, jstats, jrewards, jslot_ptr, jcarry = ref
        for k in ("actions", "prev_actions"):
            assert sorted(batch[k]) == sorted(jbatch[k]) == ["distance", "offset", "pano"]
            for a in batch[k]:
                _close(batch[k][a], jbatch[k][a], f"rollout {r} {k}/{a}")
        np.testing.assert_array_equal(batch["actions"]["pano"], jbatch["actions"]["pano"])
        for k in ("masks", "masks_next"):
            np.testing.assert_array_equal(batch[k], jbatch[k].reshape(batch[k].shape), err_msg=k)
        for k in ("rewards", "returns", "advantages", "value_preds", "old_log_probs", "hidden0"):
            _close(batch[k], jbatch[k], f"rollout {r} {k}")
        assert sorted(batch["obs"]) == sorted(jbatch["obs"])
        for k, v in batch["obs"].items():
            ref_v = jbatch["obs"][k].reshape(v.shape)
            if v.dtype == np.uint8 or v.dtype == np.int32:
                np.testing.assert_array_equal(v, ref_v, err_msg=k)
            else:
                np.testing.assert_allclose(v, ref_v, rtol=RTOL if k in ("globalgps", "heading") else 0, atol=ATOL,
                                           err_msg=k)
        assert sorted(stats) == sorted(jstats)
        for k in stats:
            _close(stats[k], jstats[k], f"rollout {r} stats/{k}")
            assert np.isfinite(stats[k]).all(), k
        _close(rewards, jrewards, f"rollout {r} episode rewards")
        assert slot_ptr == jslot_ptr
        names = ("pos", "heading", "rnn", "prev_distance", "prev_offset", "prev_pano", "mask", "prev_d", "ep_idx",
                 "step_in_ep", "ep_reward", "hist_rgb", "hist_depth")
        for name, ref_v in zip(names, jcarry):  # the JAX carry's leaves, prev actions in key order
            _close(state[name].astype(np.float64), ref_v.astype(np.float64), f"rollout {r} carry {name}")
        panos.append(batch["actions"]["pano"])
    return np.concatenate(panos)


def test_greedy_collect_device_matches_jax(greedy):
    runs, collector = greedy
    panos = _assert_greedy_runs_match(runs)
    # the rollouts moved, STOPped, and reset inside a rollout (MAX_EPISODE_STEPS 2 < T)
    assert (panos == 12).any() and (panos < 12).any()
    assert any((run[0]["masks"][1:] == 0).any() for run in runs["port"])
    assert collector.rollouts == collector.readbacks == ROLLOUTS and collector.replays == ROLLOUTS * T


# grid sizes of the train split's four scenes: three sizes, the largest
# only in scene 3, so that a queue without it pads to a smaller grid
MIXED_SIZES = {"synth_scene_0": 20.0, "synth_scene_1": 24.0, "synth_scene_2": 20.0, "synth_scene_3": 28.0}


@pytest.mark.parametrize("source", ["bank", "queue"])
def test_greedy_collect_device_on_imported_scenes_of_mixed_sizes_matches_jax(pair, tmp_path, monkeypatch, source):
    """The train split's scenes imported as lattice exports of three grid
    sizes, one slot, T=2, three rollouts: greedy rollouts of both packages
    agree, from the episode bank and from per-rollout queues. Both pad the
    bank to the split's largest grid and a queue to its own largest
    (blocked, +inf, `nearest` edge-repeated); the padded size is part of
    the result (walls are shaded by the grid's width), and the first queue
    (scenes 0, 1, 2) pads to a smaller grid than the later ones."""
    import vlnce_tpu.rl.device_rollout as jax_device_rollout
    import vlnce_torch.rl.device_rollout as device_rollout
    from vlnce_tpu.envs import scene_import as jax_scene_import
    from vlnce_tpu.envs.gridworld import get_scene as jax_get_scene
    from vlnce_torch.envs.gridworld import get_scene
    from vlnce_torch.tasks.datasets import make_dataset

    from tests.torch_port_cases import SceneRegistrySnapshot, assert_imported, export_synthetic_geometry

    geometry = tmp_path / "geometry"
    opts = ["RL.PPO.num_steps", 2, "TASK_CONFIG.DATASET.NUM_EPISODES", 8,
            "TASK_CONFIG.SIMULATOR.GEOMETRY_DIR", str(geometry)]
    bank = ("EPISODE_BANK_MAX", 8192 if source == "bank" else 2)
    grids = {"jax": [], "port": []}
    builders = {"jax": jax_device_rollout.build_episode_queue, "port": device_rollout.build_episode_queue}
    for name, module in (("jax", jax_device_rollout), ("port", device_rollout)):
        def record_grid(*args, _build=builders[name], _grids=grids[name]):
            queue = _build(*args)
            _grids.append(queue.occupancy.shape[-1])
            return queue

        monkeypatch.setattr(module, "build_episode_queue", record_grid)
    with SceneRegistrySnapshot():
        dataset = _merged(pair["cfg"], opts).TASK_CONFIG.DATASET
        scene_ids = sorted({e.scene_id for e in make_dataset(dataset.TYPE, dataset).episodes})
        export_synthetic_geometry(str(geometry), scene_ids, MIXED_SIZES)
        runs, collector = _greedy_runs(pair, 3, num_envs=1, extra=opts + ["CUDA." + bank[0], bank[1]],
                                       jax_extra=opts + ["TPU." + bank[0], bank[1]])
        assert_imported(scene_ids)
        assert all(isinstance(jax_get_scene(s), jax_scene_import.ImportedScene) for s in scene_ids)
        sizes = [get_scene(s).n for s in scene_ids]
        # the padded arrays themselves, fills and `nearest`'s edge included:
        # the bank, or a queue whose slots pad scenes 0, 1, 2 to scene 3's grid
        eps = collector._slot_streams[0]
        slots = [eps] if source == "bank" else [eps[0:3], eps[3:6]]
        got, want = builders["port"](slots, "cpu"), builders["jax"](slots)
        for field in device_rollout.EpisodeQueue._fields:
            np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)), err_msg=field)
        assert got.occupancy.shape[-1] == max(sizes) and bool(got.occupancy[0, 0, -1, -1])
    assert len(set(sizes)) == 3 and (collector._bank_episodes is None) == (source == "queue")
    _assert_greedy_runs_match(runs)
    assert any((run[0]["masks"] == 0).any() for run in runs["port"][1:])  # a slot reset between rollouts
    assert grids["port"] == grids["jax"]
    if source == "bank":
        assert grids["port"] == [max(sizes)] and collector.builds == 1
    else:
        assert len(grids["port"]) == 3 and grids["port"][0] < max(sizes) == grids["port"][-1]
        assert collector.builds == len(set(grids["port"])) == len(collector._graphs)
    assert collector.replays == 3 * 2


def test_bank_and_per_rollout_queue_give_the_same_batch(pair):
    """EPISODE_BANK_MAX below the split: each rollout uploads its queue in
    place of the bank's index map; the batches are the same."""
    batches = {}
    for name, extra in (("bank", ()), ("queue", ("CUDA.EPISODE_BANK_MAX", 2))):
        collector = _collector(pair, extra)
        generator = torch.Generator().manual_seed(3)
        batches[name] = [_collect(collector, generator) for _ in range(ROLLOUTS)]
        assert (collector._bank_episodes is None) == (name == "queue")
    for (a, sa, ra), (b, sb, rb) in zip(batches["bank"], batches["queue"]):
        for k in ("rewards", "returns", "advantages", "masks"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        for k in a["actions"]:
            np.testing.assert_array_equal(a["actions"][k], b["actions"][k], err_msg=k)
        for k in a["obs"]:
            np.testing.assert_array_equal(a["obs"][k], b["obs"][k], err_msg=k)
        for k in sa:
            np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)


def test_sampled_rollouts_follow_the_generator(pair):
    """The same generator seed gives the same sampled rollout; another seed
    another one; the stats stay finite."""
    def run(seed):
        collector = _collector(pair)
        return _collect(collector, torch.Generator().manual_seed(seed))

    a, b, c = run(1), run(1), run(2)
    for k in a[0]["actions"]:
        np.testing.assert_array_equal(a[0]["actions"][k], b[0]["actions"][k], err_msg=k)
    assert any(not np.array_equal(a[0]["actions"][k], c[0]["actions"][k]) for k in a[0]["actions"])
    assert all(np.isfinite(v).all() for v in a[1].values())


@pytest.mark.parametrize("key,value", [("TASK_CONFIG.SIMULATOR.TYPE", "Sim-v0"), ("ENV_NAME", "VLNCEDaggerEnv")])
def test_collector_refuses_other_simulators_and_envs(pair, key, value):
    with pytest.raises(ValueError, match="ON_DEVICE_ROLLOUT"):
        _collector(pair, (key, value))


def _agents(pair):
    cfg, jcfg = pair["cfg"], pair["jcfg"]
    ppo = cfg.RL.PPO
    coefs = dict(offset_regularize_coef=ppo.offset_regularize_coef, pano_entropy_coef=ppo.pano_entropy_coef,
                 offset_entropy_coef=ppo.offset_entropy_coef, distance_entropy_coef=ppo.distance_entropy_coef,
                 num_updates=int(cfg.RL.NUM_UPDATES))
    return JaxWDDPPO(pair["jax_policy"], jcfg.RL.PPO, mesh=None, **coefs), WDDPPO(pair["policy"], ppo, **coefs)


def _device_batch(batch):
    return {k: ({a: torch.from_numpy(b) for a, b in v.items()} if isinstance(v, dict) else torch.from_numpy(v))
            for k, v in batch.items()}


def test_update_device_scan_never_captures_on_the_cpu(pair, greedy):
    """On the CPU every update of update_device_scan runs its steps eagerly,
    the second (Adam holding state, the shapes warmed up) too: no capture,
    no replay, every step counted."""
    batch = _device_batch(greedy[0]["port"][0][0])
    policy = pair["policy"]
    start = {k: v.clone() for k, v in policy.state_dict().items()}
    _, agent = _agents(pair)
    try:
        for update in range(2):
            stats = agent.update_device_scan(batch, np.random.RandomState(update), update_idx=update)
            assert sorted(stats) == sorted(STAT_KEYS) and all(np.isfinite(v) for v in stats.values())
        T_, rows, _ = agent._minibatch_plan(batch, np.random.RandomState(0), 0)
        assert agent.optimizer.state and agent._step_graph(batch, T_, rows.shape[1]) is None
        assert agent.captures == agent.replayed_steps == 0 and agent.minibatch_steps == agent.optimizer_steps == 8
    finally:
        policy.load_state_dict(start)


def test_update_device_scan_matches_jax(pair, greedy):
    """One device update of both packages from one batch (the port's greedy
    rollout, carried across as numpy; the JAX package's per-minibatch
    update_device, whose minibatches and Adam steps the port's one update
    takes): the mean stats within 1e-4; the
    parameters within 1e-5 where the first minibatch's JAX gradient exceeds
    1e-6 and within 2 x lr x steps elsewhere, frozen ones bit-equal."""
    batch = greedy[0]["port"][0][0]
    policy, params = pair["policy"], pair["params"]
    start = {k: v.clone() for k, v in policy.state_dict().items()}
    jax_agent, agent = _agents(pair)
    try:
        T_, rows, clip = agent._minibatch_plan(batch, np.random.RandomState(11), 1)
        idx = rows[0]
        first = tuple(
            {k: v[:, idx] for k, v in batch[name].items()} if isinstance(batch[name], dict)
            else (batch[name][idx] if name == "hidden0" else batch[name][:, idx])
            for name in ("obs", "hidden0", "actions", "prev_actions", "value_preds", "returns", "masks",
                         "old_log_probs", "advantages")
        )
        grads, _ = jax_agent._build_grads(T_)(params, jax.tree_util.tree_map(jnp.asarray, first),
                                               jnp.ones((len(idx),), jnp.float32), jnp.float32(clip))
        grads = state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, grads), "WaypointPolicy")
        jax_stats = jax_agent.update_device(jax.tree_util.tree_map(jnp.asarray, batch), np.random.RandomState(11),
                                            update_idx=1)
        stats = agent.update_device_scan(_device_batch(batch), np.random.RandomState(11), update_idx=1)
        np.testing.assert_allclose([stats[k] for k in STAT_KEYS], [jax_stats[k] for k in STAT_KEYS], atol=1e-4)
        ppo = pair["cfg"].RL.PPO
        steps = ppo.ppo_epoch * ppo.num_mini_batch
        ref = state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, jax_agent.policy.params), "WaypointPolicy")
        named = dict(policy.named_parameters())
        for name, value in policy.state_dict().items():
            p = named.get(name)
            if p is not None and p.requires_grad:
                diff = (value - ref[name]).abs()
                big = (grads[name].abs() > 1e-6).float()
                assert float((diff * big).max()) <= 1e-5, name
                assert float(diff.max()) <= 2 * ppo.lr * steps, name
            else:
                assert torch.equal(value, start[name]) and torch.equal(value, ref[name]), name
    finally:
        policy.load_state_dict(start)
        pair["jax_policy"].params = params


def test_device_steps_never_test_a_tensor_for_truth(pair, monkeypatch):
    """A rollout's steps and update_device_scan's minibatch loop run with
    `Tensor.__bool__` refused: on the card a truth test reads the value
    back. (Masked Adam's norm clip once did: `clip(...) and None`.)"""
    collector = _collector(pair)
    _collect(collector, torch.Generator().manual_seed(4))  # builds the step and the buffers
    _, agent = _agents(pair)
    state = {k: v.clone() for k, v in pair["policy"].state_dict().items()}

    def refuse(self):
        raise AssertionError("a tensor was tested for truth")

    collector.load_rollout()
    batch = collector._buffers
    T_, rows, clip = agent._minibatch_plan(batch, np.random.RandomState(0), 0)
    idx = torch.from_numpy(rows)
    try:
        with monkeypatch.context() as patch:
            patch.setattr(torch.Tensor, "__bool__", refuse)
            collector.run_rollout(torch.Generator().manual_seed(5))
            stats = agent.minibatch_loop(batch, idx, clip, T_)
        assert stats.shape == (len(rows), len(STAT_KEYS)) and bool(torch.isfinite(stats).all())
    finally:
        pair["policy"].load_state_dict(state)


@pytest.fixture
def smoke_config(tmp_path):
    def make(*extra):
        return get_config("vlnce_torch/config/experiments/synthetic/smoke_waypoint.yaml", [
            "CUDA.DEVICE", "cpu", "CUDA.PRECISION.compute_dtype", "float32", "CHECKPOINT_FOLDER", str(tmp_path / "ckpts"),
            "RL.NUM_UPDATES", 1, "RL.PPO.num_steps", 2, "TASK_CONFIG.DATASET.NUM_EPISODES", 4,
            "TASK_CONFIG.SIMULATOR.RGB_SENSOR.HEIGHT", IMG, "TASK_CONFIG.SIMULATOR.RGB_SENSOR.WIDTH", IMG,
            "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.HEIGHT", IMG, "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.WIDTH", IMG,
            "CUDA.ON_DEVICE_ROLLOUT", True, *extra])
    return make


@pytest.mark.parametrize("scan", [False, True])
def test_trainer_trains_on_device_without_an_env_pool(smoke_config, tmp_path, monkeypatch, scan):
    """`train()` with CUDA.ON_DEVICE_ROLLOUT: no worker is forked, the
    update is update_device_scan whatever CUDA.PPO_UPDATE_SCAN says, and one
    update moves the trainable weights and writes a checkpoint."""
    def no_pool(*args, **kwargs):
        raise AssertionError("the env pool was constructed")

    monkeypatch.setattr(ddppo_waypoint_trainer, "construct_envs", no_pool)
    trainer = registry.get_trainer("ddppo-waypoint")(smoke_config("CUDA.PPO_UPDATE_SCAN", scan))
    used = []
    for name in ("update_device_scan", "update"):
        method = getattr(WDDPPO, name)
        monkeypatch.setattr(WDDPPO, name, lambda self, *a, _m=method, _n=name, **k: used.append(_n) or _m(self, *a, **k))
    start = {}
    init = trainer._initialize_policy_rl

    def record(*args, **kwargs):
        init(*args, **kwargs)
        start.update({k: v.clone() for k, v in trainer.policy.state_dict().items()})

    trainer._initialize_policy_rl = record
    trainer.train()
    assert trainer.envs is None and trainer.collector is not None
    assert used == ["update_device_scan"]
    assert trainer.collector.rollouts == trainer.collector.readbacks == 1 and trainer.collector.replays == 2
    saved = load_checkpoint(str(tmp_path / "ckpts" / "ckpt.0.ckpt"))
    assert saved["extra_state"] == {"update": 0, "count_steps": 2 * trainer.config.NUM_ENVIRONMENTS}
    named = dict(trainer.policy.named_parameters())
    moved = [k for k, p in named.items() if p.requires_grad and not torch.equal(p.detach(), start[k])]
    assert moved and all(torch.equal(saved["state_dict"][k], v) for k, v in trainer.policy.state_dict().items())
    h = trainer.update_history
    assert len(h) == 1 and all(np.isfinite(v) for v in h[0].values())
