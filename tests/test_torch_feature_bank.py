"""The port's feature-bank route (data/feature_bank.py and the bank hooks of
trainers/scan_eval.py and trainers/device_dagger.py) against the JAX
package's, at a small size on the CPU (R2R CMA: ResNet18s, H=64, 16x16
frames, as tests/test_torch_scan_eval.py builds it).

The JAX package's `encode_scene_bank` writes the banks of the four
synthetic scenes (a lattice of nodes 3 m apart, 8 heading bins) with its
policy; the port reads them (the npz schema is shared). Held against JAX:

- `load_bank_batch` (node padding at 1e9) and `lookup_features` on seeded
  poses, some beyond `max_dist` and outside every scene: exact (the JAX
  lookup contracts one-hot matrices with f16 values in f32, which is
  exact; the port gathers);
- the port's `encode_scene_bank` with the port's policy, same weights:
  within 1e-4 (two frameworks' ResNets, the tolerance of
  tests/test_torch_dagger.py's stored features);
- R2R scan eval with CUDA.FEATURE_BANK_DIR through `run_exp`: the same
  actions, measures within atol 1e-6;
- DAgger collection on the card with the bank at beta 1: the payloads equal
  JAX's (features exact, progress 1e-6), and the resident bank follows the
  expert exactly as the render-driven collection does;
- the coverage guard and the missing-bank error.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import vlnce_tpu.models  # noqa: F401
import vlnce_tpu.tasks  # noqa: F401
import vlnce_tpu.trainers  # noqa: F401
from scripts.generate_feature_bank import lattice_nodes
from vlnce_tpu.data import feature_bank as jax_fb
from vlnce_tpu.envs import ensure_registered as jax_ensure_registered
from vlnce_tpu.envs.device_sim import camera_specs_from_config as jax_camera_specs
from vlnce_tpu.envs.gridworld import get_scene as jax_get_scene
from vlnce_tpu.tasks.datasets import make_dataset as jax_make_dataset
from vlnce_tpu.trainers import device_dagger as jax_dagger
from vlnce_tpu.trainers import scan_eval as jax_scan
import vlnce_torch.tasks  # noqa: F401
import vlnce_torch.trainers  # noqa: F401
from vlnce_torch.data import feature_bank
from vlnce_torch.envs import ensure_registered
from vlnce_torch.envs.device_sim import camera_specs_from_config
from vlnce_torch.envs.gridworld import get_scene
from vlnce_torch.models.convert import state_dict_from_jax_params
from vlnce_torch.run import run_exp
from vlnce_torch.tasks.datasets import make_dataset
from vlnce_torch.trainers import device_dagger, scan_eval
from vlnce_torch.utils.checkpoints import save_checkpoint

from tests.torch_port_cases import R2R_CMA, R2R_SMALL_OPTS, build_r2r_pair

jax_ensure_registered()
ensure_registered()

SPACING = 3.0  # meters between lattice nodes: up to 2.12 m from a pose to its node
HEADINGS = 8
MEASURES = ["steps_taken", "path_length", "distance_to_goal", "success", "oracle_success", "spl", "ndtw"]
LOOP = [
    "TASK_CONFIG.DATASET.NUM_EPISODES", 4, "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", 6,
    "EVAL.SCAN_BATCH", 3, "EVAL.SCAN_SEGMENT", 4, "EVAL.SAMPLE", False, "NUM_ENVIRONMENTS", 2,
]


def _with(cfg, **keys):
    """A copy of `cfg` with the dotted keys set."""
    cfg = cfg.clone()
    cfg.defrost()
    for k, v in keys.items():
        node = cfg
        *path, leaf = k.split(".")
        for p in path:
            node = node[p]
        node[leaf] = v
    cfg.freeze()
    return cfg


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The R2R pair with a head that follows what the agent sees (as in
    tests/test_torch_scan_eval.py), and the JAX package's banks of the four
    synthetic scenes in a temporary directory."""
    tmp = tmp_path_factory.mktemp("banks")
    (jax_policy, params), policy, (jcfg, cfg) = build_r2r_pair(seed=1, extra=LOOP)
    head = params["action_distribution"]
    head["kernel"] = (head["kernel"] * 30.0).astype(np.float32)
    head["bias"] = np.asarray([6.0, 3.0, 1.5, 1.5], np.float32)
    jax_policy.params = params
    policy.load_state_dict(state_dict_from_jax_params(params), strict=True)
    eps = list(make_dataset(cfg.TASK_CONFIG.DATASET.TYPE, cfg.TASK_CONFIG.DATASET).episodes)
    jeps = list(jax_make_dataset(jcfg.TASK_CONFIG.DATASET.TYPE, jcfg.TASK_CONFIG.DATASET).episodes)
    assert [e.episode_id for e in eps] == [e.episode_id for e in jeps] and len(eps) == 4
    bank_dir = str(tmp / "banks")
    os.makedirs(bank_dir)
    headings = (2.0 * np.pi / HEADINGS) * np.arange(HEADINGS, dtype=np.float32)
    specs = jax_camera_specs(jcfg.TASK_CONFIG.SIMULATOR)
    for scene_id in sorted({e.scene_id for e in jeps}):
        scene = jax_get_scene(scene_id)
        nodes = lattice_nodes(scene, SPACING)
        rgb, depth, rgb_shape, depth_shape = jax_fb.encode_scene_bank(jax_policy, [], specs, scene, nodes, headings,
                                                                      chunk=128)
        jax_fb.save_scene_bank(os.path.join(bank_dir, f"{jax_fb._scene_key(scene_id)}.npz"), nodes, rgb, depth,
                               rgb_shape, depth_shape)
    ckpt = str(tmp / "ckpt.0.pth")
    save_checkpoint(ckpt, policy.state_dict(), config=cfg)
    return {"jax_policy": jax_policy, "policy": policy, "jcfg": jcfg, "cfg": cfg, "eps": eps, "jeps": jeps,
            "bank_dir": bank_dir, "headings": headings, "tmp": tmp, "ckpt": ckpt}


def test_load_bank_batch_matches_jax(world):
    bank_dir, eps = world["bank_dir"], world["eps"]
    chunk = [eps[0], eps[1], eps[3], eps[0]]
    got = feature_bank.load_bank_batch(bank_dir, chunk)
    want = jax_fb.load_bank_batch(bank_dir, chunk)
    for name in ("node_pos", "rgb", "depth"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
    assert (got.rgb_shape, got.depth_shape) == (want.rgb_shape, want.depth_shape)
    assert got.node_pos.shape[1] == 64 and got.rgb.dtype == torch.float16 and got.num_headings == HEADINGS
    with np.load(os.path.join(bank_dir, "synth_scene_0.npz")) as z:
        m = z["node_pos"].shape[0]
    assert m < 64 and bool((got.node_pos[0, m:] == 1e9).all())  # padding nodes, never the nearest
    assert feature_bank.load_bank_shapes(bank_dir, eps[0]) == jax_fb.load_bank_shapes(bank_dir, eps[0])


@pytest.mark.parametrize("max_dist", [0.0, 1.0])
def test_lookup_matches_jax(world, max_dist):
    bank_dir, eps = world["bank_dir"], world["eps"]
    chunk = [eps[0], eps[1], eps[2], eps[3]] * 4
    rng = np.random.RandomState(7)
    B = len(chunk)
    pos = np.zeros((B, 3), np.float32)
    pos[:, 0], pos[:, 2] = rng.uniform(-1.0, 17.0, B), rng.uniform(-1.0, 17.0, B)
    pos[:4, [0, 2]] = np.load(os.path.join(bank_dir, "synth_scene_0.npz"))["node_pos"][:4]  # on nodes
    pos[4, [0, 2]] = [60.0, -40.0]  # outside every scene
    heading = rng.uniform(-3 * np.pi, 3 * np.pi, B).astype(np.float32)
    heading[:4] = world["headings"][[0, 3, 5, 7]]
    heading[5] = 4.5 * 2 * np.pi / HEADINGS  # a half bin: half to even in both
    got, dist = feature_bank.lookup_features(feature_bank.load_bank_batch(bank_dir, chunk), torch.from_numpy(pos),
                                             torch.from_numpy(heading), max_dist=max_dist, return_distance=True)
    want, jdist = jax_fb.lookup_features(jax_fb.load_bank_batch(bank_dir, chunk), jnp.asarray(pos), jnp.asarray(heading),
                                         max_dist=max_dist, return_distance=True)
    for k in ("rgb_features", "depth_features"):
        assert got[k].dtype == torch.float32 and got[k].shape == tuple(want[k].shape)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    np.testing.assert_allclose(dist.numpy(), np.asarray(jdist), rtol=1e-6)
    far = dist.numpy() > max_dist
    if max_dist:
        assert far.any() and (~far).any()
        assert float(got["rgb_features"][torch.from_numpy(far)].abs().max()) == 0.0
    assert float(got["rgb_features"][torch.from_numpy(~far)].abs().max()) > 0.0


def _render_both(world, scene_id, nodes, headings):
    """Each package's device renderer at every (node, heading) pose of the
    bank: {sensor: (port [P, ...], jax [P, ...])}."""
    from vlnce_tpu.envs.device_sim import SceneBatch as JaxSceneBatch, render_batch as jax_render_batch
    from vlnce_torch.envs.device_sim import SceneBatch, render_batch

    H = len(headings)
    pos = np.zeros((len(nodes) * H, 3), np.float32)
    pos[:, 0], pos[:, 2] = np.repeat(nodes[:, 0], H), np.repeat(nodes[:, 1], H)
    head = np.tile(np.asarray(headings, np.float32), len(nodes))
    n, scene = len(pos), get_scene(scene_id)
    arrays = {
        "occupancy": np.broadcast_to(scene.occupancy.astype(bool), (n,) + scene.occupancy.shape),
        "wall_colors": np.broadcast_to(scene.wall_colors, (n,) + scene.wall_colors.shape),
        "floor_color": np.broadcast_to(scene.floor_color, (n, 3)), "ceil_color": np.broadcast_to(scene.ceil_color, (n, 3)),
        "goal_field": np.ones((n,) + scene.occupancy.shape, np.float32), "d0": np.ones((n,), np.float32),
        "origin_xz": np.broadcast_to(np.asarray(scene.origin, np.float32), (n, 2)),
    }
    got = render_batch(SceneBatch(**{k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrays.items()}),
                       torch.from_numpy(pos), torch.from_numpy(head), camera_specs_from_config(world["cfg"].TASK_CONFIG.SIMULATOR))
    want = jax_render_batch(JaxSceneBatch(**{k: jnp.asarray(v) for k, v in arrays.items()}), jnp.asarray(pos),
                            jnp.asarray(head), jax_camera_specs(world["jcfg"].TASK_CONFIG.SIMULATOR))
    return {k: (got[k].numpy(), np.asarray(want[k])) for k in got}


def test_encode_scene_bank_matches_jax(world, tmp_path):
    """The port's encoder pass over a scene's poses (a ragged last chunk
    included) against the JAX package's, within 1e-4 at every pose whose
    frames the two renderers draw alike. A bank's poses sit at cell centres
    and at multiples of 45 degrees, where a ray can run exactly through a
    grid corner and an f32 rounding decides which wall it hits: there the
    renderers (both f32, each held against the host simulator by its own
    tests) may differ in a few pixels, and so do the features. The test
    requires such poses to be under 5% of the bank. What the port saves,
    the JAX package loads."""
    scene_id = world["eps"][2].scene_id
    nodes = lattice_nodes(jax_get_scene(scene_id), SPACING)[:9]
    headings = world["headings"]
    rgb, depth, rgb_shape, depth_shape = feature_bank.encode_scene_bank(
        world["policy"], [], camera_specs_from_config(world["cfg"].TASK_CONFIG.SIMULATOR), get_scene(scene_id), nodes,
        headings, chunk=32)
    jrgb, jdepth, jrgb_shape, jdepth_shape = jax_fb.encode_scene_bank(
        world["jax_policy"], [], jax_camera_specs(world["jcfg"].TASK_CONFIG.SIMULATOR), jax_get_scene(scene_id), nodes,
        headings, chunk=32)
    for spacing in (SPACING, 1.0, 2.0):  # the port's copy of the generator's lattice
        np.testing.assert_array_equal(feature_bank.lattice_nodes(get_scene(scene_id), spacing),
                                      lattice_nodes(jax_get_scene(scene_id), spacing))
    assert (rgb_shape, depth_shape) == (tuple(jrgb_shape), tuple(jdepth_shape))
    assert rgb.shape == jrgb.shape == (9, HEADINGS, int(np.prod(rgb_shape)))
    frames = _render_both(world, scene_id, nodes, headings)
    alike = np.ones(rgb.shape[0] * HEADINGS, bool)
    for got, want in frames.values():
        alike &= np.abs(got.astype(np.float64) - want.astype(np.float64)).reshape(len(alike), -1).max(axis=1) <= 1e-3
    assert alike.mean() > 0.95, alike.mean()
    for ours, theirs in ((rgb, jrgb), (depth, jdepth)):
        ours, theirs = ours.reshape(len(alike), -1), theirs.reshape(len(alike), -1)
        np.testing.assert_allclose(ours[alike], theirs[alike], rtol=0, atol=1e-4)
    feature_bank.save_scene_bank(str(tmp_path / "scene.npz"), nodes, rgb, depth, rgb_shape, depth_shape)

    class Ep:
        scene_id = "scene"

    back = jax_fb.load_bank_batch(str(tmp_path), [Ep()], m_quantum=1)
    np.testing.assert_array_equal(np.asarray(back.rgb[0]), rgb.astype(np.float16))
    assert (back.rgb_shape, back.depth_shape) == (rgb_shape, depth_shape)


def test_scan_eval_with_the_bank_matches_jax(world):
    """Scan eval through the port's CLI with CUDA.FEATURE_BANK_DIR (and a
    radius that covers every pose) against the JAX package's scan rollouts
    with TPU.FEATURE_BANK_DIR: the same actions, so the same measures."""
    jcfg = _with(world["jcfg"], **{"TPU.FEATURE_BANK_DIR": world["bank_dir"], "TPU.FEATURE_BANK_MAX_DIST": 2.2})
    want = jax_scan.run_scan_rollouts(world["jax_policy"], [], jcfg, world["jeps"], jax.random.PRNGKey(0))
    assert len({len(a) for a in want}) > 1  # the episodes ended apart
    jm = jax_scan.metrics_from_actions(jcfg, world["jeps"], want)
    tmp = world["tmp"] / "scan"
    split = world["cfg"].TASK_CONFIG.DATASET.SPLIT  # the banks' episodes
    trainer = run_exp(R2R_CMA, "eval", R2R_SMALL_OPTS + LOOP + [
        "EVAL.SPLIT", split, "CUDA.DEVICE", "cpu", "CUDA.PRECISION.compute_dtype", "float32", "CUDA.FEATURE_BANK_DIR", world["bank_dir"],
        "CUDA.FEATURE_BANK_MAX_DIST", 2.2, "EVAL.ON_DEVICE_SCAN", True, "EVAL.EPISODE_COUNT", 4,
        "EVAL.USE_CKPT_CONFIG", False, "EVAL_CKPT_PATH_DIR", world["ckpt"], "RESULTS_DIR", str(tmp / "evals"),
        "LOG_FILE", "", "VERBOSE", False])
    episodes = trainer._last_eval_episode_stats
    assert list(episodes) == list(jm)
    for ep_id, stats in episodes.items():
        assert sorted(stats) == sorted(MEASURES)
        for k in MEASURES:
            np.testing.assert_allclose(stats[k], jm[ep_id][k], rtol=0, atol=1e-6, err_msg=f"{ep_id} {k}")
    assert os.path.exists(tmp / "evals" / f"stats_ckpt_0_{split}.json")
    timing = trainer.last_loop_timing
    assert timing["readbacks"] == timing["segments"] >= 2 and timing["env_steps"] == sum(len(a) for a in want)


def _dagger_cfgs(world, bank=True):
    keys = {"TASK_CONFIG.DATASET.NUM_EPISODES": 4, "NUM_ENVIRONMENTS": 2}
    jcfg = _with(world["jcfg"], **keys, **{"TPU.DAGGER_SEGMENT": 4},
                 **({"TPU.FEATURE_BANK_DIR": world["bank_dir"]} if bank else {}))
    cfg = _with(world["cfg"], **keys, **{"CUDA.DAGGER_SEGMENT": 4},
                **({"CUDA.FEATURE_BANK_DIR": world["bank_dir"]} if bank else {}))
    return jcfg, cfg


@pytest.fixture(scope="module")
def bank_payloads(world):
    jcfg, cfg = _dagger_cfgs(world)
    want = jax_dagger.collect_episodes_on_device(world["jax_policy"], [], jcfg, world["jeps"], 1.0, jax.random.PRNGKey(0))
    stats = {}
    got = device_dagger.collect_episodes_on_device(world["policy"], [], cfg, world["eps"], 1.0,
                                                   torch.Generator().manual_seed(0), stats=stats)
    return got, want, stats


def test_dagger_collection_with_the_bank_matches_jax(world, bank_payloads):
    got, want, stats = bank_payloads
    shapes = feature_bank.load_bank_shapes(world["bank_dir"], world["eps"][0])
    assert len(got) == len(want) == 4 and stats["chunk_readbacks"] == 2
    for (obs, prev, oracle), (jobs, jprev, joracle) in zip(got, want):
        np.testing.assert_array_equal(prev, jprev)
        np.testing.assert_array_equal(oracle, joracle)
        np.testing.assert_array_equal(prev[1:], oracle[:-1])  # beta 1: the expert's actions
        assert sorted(obs) == sorted(jobs) == ["depth_features", "instruction", "progress", "rgb_features"]
        assert (obs["rgb_features"].shape[1:], obs["depth_features"].shape[1:]) == shapes  # the bank's own shapes
        np.testing.assert_array_equal(obs["instruction"], jobs["instruction"])
        np.testing.assert_allclose(obs["progress"], jobs["progress"], rtol=0, atol=1e-6)
        for k in ("rgb_features", "depth_features"):
            assert obs[k].dtype == jobs[k].dtype == np.float32
            np.testing.assert_array_equal(obs[k], jobs[k], err_msg=k)


def test_resident_dagger_with_the_bank_follows_the_expert(world, bank_payloads):
    """The device expert steers by the scene's geometry, not by what the
    agent sees: at beta 1 the resident bank collected with the feature bank
    holds the render-driven collection's trajectories, with the bank's
    features as its rows (the store-wired payloads')."""
    _, cfg = _dagger_cfgs(world)
    _, cfg_render = _dagger_cfgs(world, bank=False)
    bank = device_dagger.collect_episodes_resident(world["policy"], [], cfg, world["eps"], 1.0,
                                                   torch.Generator().manual_seed(0))
    render = device_dagger.collect_episodes_resident(world["policy"], [], cfg_render, world["eps"], 1.0,
                                                     torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(bank.lengths, render.lengths)
    got = bank_payloads[0]
    for e in range(len(bank)):
        lo, rlo, T = int(bank.offsets[e]), int(render.offsets[e]), int(bank.lengths[e])
        np.testing.assert_array_equal(bank.oracle[lo : lo + T].numpy(), render.oracle[rlo : rlo + T].numpy())
        np.testing.assert_array_equal(bank.prev[lo : lo + T].numpy(), render.prev[rlo : rlo + T].numpy())
        obs = got[e][0]
        for k in ("rgb_features", "depth_features"):
            assert bank.feat_shapes[k] == obs[k].shape[1:]
            np.testing.assert_array_equal(bank.data[k][lo : lo + T].numpy().reshape(obs[k].shape), obs[k], err_msg=k)
        assert not torch.equal(bank.data["rgb_features"][lo : lo + T], render.data["rgb_features"][rlo : rlo + T])


def test_coverage_and_missing_banks_fail_at_load(world, tmp_path):
    eps = world["eps"]
    with pytest.raises(ValueError, match=r"feature bank does not cover episode .*\(CUDA\.FEATURE_BANK_MAX_DIST=0\.01\)"):
        feature_bank.check_bank_coverage(world["bank_dir"], eps, 0.01)
    feature_bank.check_bank_coverage(world["bank_dir"], eps, 2.2)
    feature_bank.check_bank_coverage(world["bank_dir"], eps, 0.0)  # off
    # the loops check at load, before any chunk steps
    cfg = _with(world["cfg"], **{"CUDA.FEATURE_BANK_DIR": world["bank_dir"], "CUDA.FEATURE_BANK_MAX_DIST": 0.01})
    stats = {}
    with pytest.raises(ValueError, match="does not cover episode"):
        scan_eval.run_scan_rollouts(world["policy"], [], cfg, eps, stats=stats)
    assert stats == {}
    _, dcfg = _dagger_cfgs(world)
    dcfg = _with(dcfg, **{"CUDA.FEATURE_BANK_DIR": str(tmp_path)})
    with pytest.raises(FileNotFoundError, match="feature bank for scene 'synth_scene_0' not found.*encode_scene_bank"):
        device_dagger.collect_episodes_resident(world["policy"], [], dcfg, eps, 1.0)
