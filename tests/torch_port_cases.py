"""Shared cases for the PyTorch port's parity tests: the RxR CMA policy and
the R2R CMA policy with the progress monitor at a small size, built in both
packages with the same weights, and episodes written into both packages'
trajectory stores.

The JAX policy is initialized, then its norm statistics, biases and head are
perturbed from a numpy seed so that no parameter keeps a trivial value; the
port gets those weights through `state_dict_from_jax_params`.
"""

import copy
import os

import numpy as np
import torch
from gymnasium import spaces as gym_spaces

import jax

from vlnce_tpu.config import get_config as jax_get_config
from vlnce_tpu.models.cma_policy import CMAPolicy as JaxCMAPolicy
from vlnce_tpu.ops.obs_transforms import (
    apply_obs_transforms_obs_space as jax_apply_space,
    get_active_obs_transforms as jax_get_transforms,
)
from vlnce_torch.config import get_config
from vlnce_torch.envs.spaces import action_space_from_config, observation_space_from_config
from vlnce_torch.models.cma_policy import CMAPolicy
from vlnce_torch.models.convert import state_dict_from_jax_params
from vlnce_torch.ops.obs_transforms import apply_obs_transforms_obs_space, get_active_obs_transforms
from vlnce_torch.parallel.mesh import DataMesh

# One intra-op thread for torch in the test processes: the suite runs in
# several worker processes at once, and at these small sizes more threads per
# process only make the workers fight over the cores (every worker imports
# this module when it collects the tests).
torch.set_num_threads(1)

JAX_RXR_CMA = "vlnce_tpu/config/experiments/rxr_baselines/rxr_cma_en.yaml"
RXR_CMA = "vlnce_torch/config/experiments/rxr_baselines/rxr_cma_en.yaml"

# RxR CMA at small depth and width: ResNet18 for both encoders, H=64, 32-d
# instruction features of 16 tokens, 48x64 frames -> ResizeShortestEdge(32)
# -> 32x42 -> 32x32 crops
SMALL_OPTS = [
    "MODEL.RGB_ENCODER.cnn_type", "TorchVisionResNet18",
    "MODEL.DEPTH_ENCODER.backbone", "resnet18",
    "MODEL.STATE_ENCODER.hidden_size", 64,
    "MODEL.INSTRUCTION_ENCODER.hidden_size", 32,
    "RL.POLICY.OBS_TRANSFORMS.RESIZE_SHORTEST_EDGE.SIZE", 32,
    "RL.POLICY.OBS_TRANSFORMS.CENTER_CROPPER_PER_SENSOR.SENSOR_CROPS", [["rgb", [32, 32]], ["depth", [32, 32]]],
    "TASK_CONFIG.SIMULATOR.RGB_SENSOR.HEIGHT", 48,
    "TASK_CONFIG.SIMULATOR.RGB_SENSOR.WIDTH", 64,
    "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.HEIGHT", 48,
    "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.WIDTH", 64,
    "TASK_CONFIG.TASK.RXR_INSTRUCTION_SENSOR.feature_dim", 32,
    "TASK_CONFIG.TASK.RXR_INSTRUCTION_SENSOR.max_text_len", 16,
]


def configs(extra=()):
    """(jax config, port config), both f32, the port on the CPU."""
    jcfg = jax_get_config(JAX_RXR_CMA, SMALL_OPTS + ["TPU.PRECISION.compute_dtype", "float32", *extra])
    cfg = get_config(RXR_CMA, SMALL_OPTS + ["CUDA.DEVICE", "cpu", "CUDA.PRECISION.compute_dtype", "float32", *extra])
    return jcfg, cfg


def jax_observation_space(task_config):
    """The environment's observation space in gymnasium terms."""
    space = observation_space_from_config(task_config)
    return gym_spaces.Dict({
        k: gym_spaces.Box(low=s.low.min(), high=s.high.max(), shape=s.shape, dtype=s.dtype)
        for k, s in space.spaces.items()
    })


def _perturb(params, rng):
    """Replace trivially initialized leaves (unit scales, zero biases and
    stats) with seeded random values, and scale the head to unit gain."""
    def walk(node, path):
        out = {}
        for k, v in node.items():
            p = f"{path}/{k}"
            if isinstance(v, dict):
                out[k] = walk(v, p)
                continue
            v = np.array(v)
            if k in ("scale", "weight") and v.ndim == 1:
                v = rng.normal(1.0, 0.2, v.shape)
            elif k in ("bias", "bias_ih", "bias_hh", "running_mean"):
                v = rng.normal(0.0, 0.1, v.shape)
            elif k == "running_var":
                v = rng.uniform(0.5, 2.0, v.shape)
            elif p == "/action_distribution/kernel":
                v = v * 100.0
            out[k] = v.astype(np.float32)
        return out

    return walk(params, "")


def build_pair(seed=0, extra=()):
    """JAX policy + transforms + params, and the port's policy + transforms
    carrying the same weights."""
    jcfg, cfg = configs(extra)
    jax_transforms = jax_get_transforms(jcfg)
    jax_space = jax_apply_space(jax_observation_space(jcfg.TASK_CONFIG), jax_transforms)
    jax_policy = JaxCMAPolicy.from_config(jcfg, jax_space, gym_spaces.Discrete(len(jcfg.TASK_CONFIG.TASK.POSSIBLE_ACTIONS)))
    params = jax_policy.init_params(jax.random.PRNGKey(seed), batch_size=1)
    params = _perturb(jax.tree_util.tree_map(np.asarray, params), np.random.RandomState(seed))
    jax_policy.params = params

    transforms = get_active_obs_transforms(cfg)
    space = apply_obs_transforms_obs_space(observation_space_from_config(cfg.TASK_CONFIG), transforms)
    policy = CMAPolicy.from_config(cfg, space, action_space_from_config(cfg.TASK_CONFIG))
    policy.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return (jax_policy, jax_transforms, params), (policy, transforms), cfg


def observations(rng, B, task_config):
    """Seeded observations in the env's format: u8 rgb, f32 depth in [0, 1],
    BERT-like instruction features zero past ragged lengths."""
    sim, task = task_config.SIMULATOR, task_config.TASK
    T, F = task.RXR_INSTRUCTION_SENSOR.max_text_len, task.RXR_INSTRUCTION_SENSOR.feature_dim
    instr = np.zeros((B, T, F), np.float32)
    for b in range(B):
        n = rng.randint(1, T + 1)
        instr[b, :n] = rng.randn(n, F)
    return {
        "rgb": rng.randint(0, 256, (B, sim.RGB_SENSOR.HEIGHT, sim.RGB_SENSOR.WIDTH, 3)).astype(np.uint8),
        "depth": rng.rand(B, sim.DEPTH_SENSOR.HEIGHT, sim.DEPTH_SENSOR.WIDTH, 1).astype(np.float32),
        "rxr_instruction": instr,
    }


def to_torch(obs):
    return {k: torch.from_numpy(v) for k, v in obs.items()}


# ---------------------------------------------------------------------------
# R2R CMA with the progress monitor (the DAgger training recipe), small
# ---------------------------------------------------------------------------

JAX_R2R_CMA = "vlnce_tpu/config/experiments/r2r_baselines/cma_pm_da_aug_tune.yaml"
R2R_CMA = "vlnce_torch/config/experiments/r2r_baselines/cma_pm_da_aug_tune.yaml"

# ResNet18 for both encoders, H=64, a 64-word vocabulary, 16x16 frames, no
# obs transforms (R2R enables none)
R2R_IMG = 16
R2R_SMALL_OPTS = [
    "MODEL.RGB_ENCODER.cnn_type", "TorchVisionResNet18",
    "MODEL.DEPTH_ENCODER.backbone", "resnet18",
    "MODEL.STATE_ENCODER.hidden_size", 64,
    "MODEL.INSTRUCTION_ENCODER.hidden_size", 32,
    "MODEL.INSTRUCTION_ENCODER.vocab_size", 64,
    "TASK_CONFIG.DATASET.TYPE", "Synthetic-VLN-v0",
    "TASK_CONFIG.SIMULATOR.RGB_SENSOR.HEIGHT", R2R_IMG,
    "TASK_CONFIG.SIMULATOR.RGB_SENSOR.WIDTH", R2R_IMG,
    "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.HEIGHT", R2R_IMG,
    "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.WIDTH", R2R_IMG,
    "TENSORBOARD_DIR", "",
]


def r2r_configs(extra=()):
    """(jax config, port config) of the small R2R CMA, both f32, the port on
    the CPU. `extra` must not name a TPU.* or CUDA.* key."""
    jcfg = jax_get_config(JAX_R2R_CMA, R2R_SMALL_OPTS + ["TPU.PRECISION.compute_dtype", "float32", *extra])
    cfg = get_config(R2R_CMA, R2R_SMALL_OPTS + ["CUDA.DEVICE", "cpu", "CUDA.PRECISION.compute_dtype", "float32", *extra])
    return jcfg, cfg


def build_r2r_pair(seed=0, extra=()):
    """The small R2R CMA policy with the progress monitor in both packages,
    carrying the same perturbed weights: (jax policy, params), port policy,
    (jax config, port config)."""
    jcfg, cfg = r2r_configs(extra)
    jax_space = jax_observation_space(jcfg.TASK_CONFIG)
    jax_policy = JaxCMAPolicy.from_config(jcfg, jax_space, gym_spaces.Discrete(len(jcfg.TASK_CONFIG.TASK.POSSIBLE_ACTIONS)))
    params = jax_policy.init_params(jax.random.PRNGKey(seed), batch_size=1)
    params = _perturb(jax.tree_util.tree_map(np.asarray, params), np.random.RandomState(seed))
    jax_policy.params = params
    policy = CMAPolicy.from_config(cfg, observation_space_from_config(cfg.TASK_CONFIG), action_space_from_config(cfg.TASK_CONFIG))
    policy.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return (jax_policy, params), policy, (jcfg, cfg)


def r2r_observations(rng, B, task_config, max_tokens=12):
    """Seeded R2R observations in the env's format: u8 rgb, f32 depth,
    instruction tokens zero-padded past ragged lengths, oracle progress."""
    sim = task_config.SIMULATOR
    space = observation_space_from_config(task_config)
    tokens = np.zeros((B,) + space["instruction"].shape, np.int32)
    for b in range(B):
        n = rng.randint(3, max_tokens + 1)
        tokens[b, :n] = rng.randint(2, 32, n)
    return {
        "rgb": rng.randint(0, 256, (B, sim.RGB_SENSOR.HEIGHT, sim.RGB_SENSOR.WIDTH, 3)).astype(np.uint8),
        "depth": rng.rand(B, sim.DEPTH_SENSOR.HEIGHT, sim.DEPTH_SENSOR.WIDTH, 1).astype(np.float32),
        "instruction": tokens,
        "progress": rng.rand(B, 1).astype(np.float32),
    }


def seeded_episodes(rng, policy, task_config, lengths):
    """Episodes as DAgger stores them, `[obs, prev_actions, oracle_actions]`
    with the frames replaced by frozen-encoder features of the right shapes
    (seeded values, not encoder outputs)."""
    rgb_c = policy.net.rgb_encoder.resnet_layer_size
    depth_chw = policy.net.depth_encoder.visual_encoder.output_shape_chw()
    episodes = []
    for n in lengths:
        obs = r2r_observations(rng, 1, task_config)
        oracle = rng.randint(0, 4, n).astype(np.int64)
        oracle[-1] = 0  # the expert ends with STOP
        episodes.append([
            {
                "instruction": np.repeat(obs["instruction"], n, axis=0),
                "progress": np.linspace(0.0, 1.0, n, dtype=np.float32).reshape(n, 1),
                "rgb_features": rng.randn(n, rgb_c, 4, 4).astype(np.float32),
                "depth_features": np.abs(rng.randn(n, *depth_chw)).astype(np.float32),
            },
            np.concatenate([[0], oracle[:-1]]).astype(np.int64),
            oracle,
        ])
    return episodes


def write_both_stores(episodes, jax_dir, torch_dir):
    """One list of episodes into the JAX package's store and the port's."""
    from vlnce_tpu.data.trajectory_store import TrajectoryStoreWriter as JaxWriter
    from vlnce_torch.data.trajectory_store import TrajectoryStoreWriter

    for writer in (JaxWriter(str(jax_dir), drop_existing=True), TrajectoryStoreWriter(str(torch_dir), drop_existing=True)):
        for ep in episodes:
            writer.put(ep)
        writer.close()


# ---------------------------------------------------------------------------
# Seq2Seq (R2R with the progress monitor and the prev-action embedding; RxR
# on BERT features), small
# ---------------------------------------------------------------------------

JAX_R2R_SEQ2SEQ = "vlnce_tpu/config/experiments/r2r_baselines/seq2seq_pm.yaml"
R2R_SEQ2SEQ = "vlnce_torch/config/experiments/r2r_baselines/seq2seq_pm.yaml"
JAX_RXR_SEQ2SEQ = "vlnce_tpu/config/experiments/rxr_baselines/rxr_seq2seq.yaml"
RXR_SEQ2SEQ = "vlnce_torch/config/experiments/rxr_baselines/rxr_seq2seq.yaml"

# the R2R sizes above at 32x32 frames, with the prev-action embedding on
SEQ2SEQ_IMG = 32
SEQ2SEQ_SMALL_OPTS = R2R_SMALL_OPTS + [
    "TASK_CONFIG.SIMULATOR.RGB_SENSOR.HEIGHT", SEQ2SEQ_IMG,
    "TASK_CONFIG.SIMULATOR.RGB_SENSOR.WIDTH", SEQ2SEQ_IMG,
    "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.HEIGHT", SEQ2SEQ_IMG,
    "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.WIDTH", SEQ2SEQ_IMG,
    "MODEL.SEQ2SEQ.use_prev_action", True,
]


def build_seq2seq_pair(seed=0, extra=(), rxr=False):
    """The small Seq2Seq policy in both packages with the same perturbed
    weights: (jax policy, params), port policy, (jax config, port config).
    `rxr` takes rxr_seq2seq.yaml at the RxR CMA cases' sizes (BERT features,
    obs transforms; the JAX config without pretrained embeddings, which its
    optimizer mask requires) instead of seq2seq_pm.yaml."""
    from vlnce_tpu.models.seq2seq_policy import Seq2SeqPolicy as JaxSeq2SeqPolicy
    from vlnce_torch.models.seq2seq_policy import Seq2SeqPolicy

    if rxr:
        jcfg = jax_get_config(JAX_RXR_SEQ2SEQ, SMALL_OPTS + [
            "TPU.PRECISION.compute_dtype", "float32", "MODEL.INSTRUCTION_ENCODER.use_pretrained_embeddings", False, *extra])
        cfg = get_config(RXR_SEQ2SEQ, SMALL_OPTS + ["CUDA.DEVICE", "cpu", "CUDA.PRECISION.compute_dtype", "float32", *extra])
        jax_space = jax_apply_space(jax_observation_space(jcfg.TASK_CONFIG), jax_get_transforms(jcfg))
        space = apply_obs_transforms_obs_space(observation_space_from_config(cfg.TASK_CONFIG), get_active_obs_transforms(cfg))
    else:
        jcfg = jax_get_config(JAX_R2R_SEQ2SEQ, SEQ2SEQ_SMALL_OPTS + ["TPU.PRECISION.compute_dtype", "float32", *extra])
        cfg = get_config(R2R_SEQ2SEQ, SEQ2SEQ_SMALL_OPTS + ["CUDA.DEVICE", "cpu", "CUDA.PRECISION.compute_dtype", "float32", *extra])
        jax_space, space = jax_observation_space(jcfg.TASK_CONFIG), observation_space_from_config(cfg.TASK_CONFIG)
    jax_policy = JaxSeq2SeqPolicy.from_config(jcfg, jax_space, gym_spaces.Discrete(len(jcfg.TASK_CONFIG.TASK.POSSIBLE_ACTIONS)))
    params = jax_policy.init_params(jax.random.PRNGKey(seed), batch_size=1)
    params = _perturb(jax.tree_util.tree_map(np.asarray, params), np.random.RandomState(seed))
    jax_policy.params = params
    policy = Seq2SeqPolicy.from_config(cfg, space, action_space_from_config(cfg.TASK_CONFIG))
    policy.load_state_dict(state_dict_from_jax_params(params, "Seq2SeqPolicy"), strict=True)
    return (jax_policy, params), policy, (jcfg, cfg)


# ---------------------------------------------------------------------------
# The waypoint policy at each of the six r2r_waypoint flag sets, small
# ---------------------------------------------------------------------------

WAYPOINT_NAMES = ("1-wpn-cc", "2-wpn-dc", "3-wpn-dd", "4-wpn-d_", "5-hpn-_c", "6-hpn-__")
WP_IMG = 32
WP_H = 64
# ResNet18 for both encoders, 64-d RGB head, H=64, a 64-word vocabulary
# without the pretrained table, 32x32 frames (tests/test_trainers.py's
# waypoint sizes), synthetic episodes
WP_SMALL_OPTS = [
    "MODEL.RGB_ENCODER.cnn_type", "TorchVisionResNet18",
    "MODEL.RGB_ENCODER.output_size", 64,
    "MODEL.DEPTH_ENCODER.backbone", "resnet18",
    "MODEL.STATE_ENCODER.hidden_size", WP_H,
    "MODEL.INSTRUCTION_ENCODER.vocab_size", 64,
    "MODEL.INSTRUCTION_ENCODER.use_pretrained_embeddings", False,
    "TASK_CONFIG.DATASET.TYPE", "Synthetic-VLN-v0",
    "TASK_CONFIG.SIMULATOR.RGB_SENSOR.HEIGHT", WP_IMG,
    "TASK_CONFIG.SIMULATOR.RGB_SENSOR.WIDTH", WP_IMG,
    "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.HEIGHT", WP_IMG,
    "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.WIDTH", WP_IMG,
    "TENSORBOARD_DIR", "",
]


def waypoint_configs(name, extra=()):
    """(jax config, port config) of r2r_waypoint/<name>.yaml at the small
    sizes, both f32, the port on the CPU."""
    jcfg = jax_get_config(f"vlnce_tpu/config/experiments/r2r_waypoint/{name}.yaml",
                          WP_SMALL_OPTS + ["TPU.PRECISION.compute_dtype", "float32", *extra])
    cfg = get_config(f"vlnce_torch/config/experiments/r2r_waypoint/{name}.yaml",
                     WP_SMALL_OPTS + ["CUDA.DEVICE", "cpu", "CUDA.PRECISION.compute_dtype", "float32", *extra])
    return jcfg, cfg


def waypoint_space(spaces, img=WP_IMG):
    """The policy's observation space as the ddppo-waypoint trainer builds it
    (12 stacked pano frames per sensor, the history frames, tokens, angle
    features), in `spaces` (gymnasium's or the port's)."""
    return spaces.Dict({
        "rgb": spaces.Box(0, 255, (12, img, img, 3), np.uint8),
        "depth": spaces.Box(0.0, 1.0, (12, img, img, 1), np.float32),
        "rgb_history": spaces.Box(0, 255, (img, img, 3), np.uint8),
        "depth_history": spaces.Box(0.0, 1.0, (img, img, 1), np.float32),
        "instruction": spaces.Box(0, 2**31 - 1, (200,), np.int32),
        "angle_features": spaces.Box(-1.0, 1.0, (12, 4), np.float32),
    })


def _perturb_state_dict(policy, rng):
    """Seeded values for the trivially initialized tensors of a port policy:
    norm scales, biases and running statistics."""
    with torch.no_grad():
        for name, t in policy.state_dict().items():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "weight" and t.dim() == 1:
                t.copy_(torch.from_numpy(rng.normal(1.0, 0.2, t.shape).astype(np.float32)))
            elif leaf.startswith("bias") or leaf == "running_mean":
                t.copy_(torch.from_numpy(rng.normal(0.0, 0.1, t.shape).astype(np.float32)))
            elif leaf == "running_var":
                t.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, t.shape).astype(np.float32)))


def build_waypoint_pair(name, seed=0, extra=(), img=WP_IMG):
    """The small waypoint policy of r2r_waypoint/<name>.yaml in both packages
    with the same weights: the port's seeded and perturbed weights go into
    the JAX parameter tree through the JAX package's own converter
    (`convert_waypoint_state_dict`, into the tree's shapes from
    `jax.eval_shape` of its init: no compile), and those JAX params come
    back into the port policy through `state_dict_from_jax_params`, loaded
    strictly and bit-equal to what went out. `img` is the frames' side (the
    configs' sensors must match it). Returns ((jax policy, params), port
    policy, (jax config, port config))."""
    from vlnce_tpu.models.convert import convert_waypoint_state_dict
    from vlnce_tpu.models.policy import observation_space_example
    from vlnce_tpu.models.waypoint_policy import WaypointPolicy as JaxWaypointPolicy
    from vlnce_torch.envs import spaces as port_spaces
    from vlnce_torch.models.waypoint_policy import WaypointPolicy

    jcfg, cfg = waypoint_configs(name, extra)
    policy = WaypointPolicy.from_config(cfg, waypoint_space(port_spaces, img))
    _perturb_state_dict(policy, np.random.RandomState(seed))
    sd = {k: v.numpy().copy() for k, v in policy.state_dict().items()}

    jax_policy = JaxWaypointPolicy.from_config(jcfg, waypoint_space(gym_spaces, img))
    B = 1
    shapes = jax.eval_shape(
        jax_policy.module.init, jax.random.PRNGKey(seed), observation_space_example(jax_policy.observation_space, B),
        jax_policy.initial_rnn_states(B), jax_policy.initial_prev_actions(B), np.zeros((B, 1), np.float32),
    )["params"]
    params = shapes  # nested plain dicts: the converter fills their leaves in place
    convert_waypoint_state_dict(sd, params)
    leaves = jax.tree_util.tree_leaves(params)
    assert not any(isinstance(x, jax.ShapeDtypeStruct) for x in leaves), "a JAX parameter was left unset"
    params = jax.tree_util.tree_map(np.asarray, params)
    jax_policy.params = params

    back = state_dict_from_jax_params(params, "WaypointPolicy")
    policy.load_state_dict(back, strict=True)
    assert all(torch.equal(back[k], torch.from_numpy(v)) for k, v in sd.items())
    return (jax_policy, params), policy, (jcfg, cfg)


def waypoint_observations(rng, B, img=WP_IMG, max_tokens=12):
    """Seeded observations as the waypoint policy takes them: u8 pano and
    history RGB, f32 depth, instruction tokens zero past ragged lengths, the
    angle features of the pano cameras."""
    tokens = np.zeros((B, 200), np.int32)
    for b in range(B):
        n = rng.randint(3, max_tokens + 1)
        tokens[b, :n] = rng.randint(2, 32, n)
    angles = np.arange(12) * (2 * np.pi / 12)
    features = np.stack([np.sin(angles), np.cos(angles), np.zeros(12), np.ones(12)], axis=1).astype(np.float32)
    return {
        "rgb": rng.randint(0, 256, (B, 12, img, img, 3)).astype(np.uint8),
        "depth": rng.rand(B, 12, img, img, 1).astype(np.float32),
        "rgb_history": rng.randint(0, 256, (B, img, img, 3)).astype(np.uint8),
        "depth_history": rng.rand(B, img, img, 1).astype(np.float32),
        "instruction": tokens,
        "angle_features": np.broadcast_to(features, (B, 12, 4)).copy(),
    }


def waypoint_prev_actions(rng, shape, wypt_cfg):
    """Seeded action components of `shape` + (1,) in the stored format:
    pano_stop in [0, 12] (12 is STOP), offset and distance in their head's
    range (continuous) or index range (discrete)."""
    lim = np.pi / 12
    offset = (rng.uniform(-lim, lim, shape + (1,)) if wypt_cfg.continuous_offset
              else rng.randint(0, wypt_cfg.discrete_offsets, shape + (1,)))
    distance = (rng.uniform(wypt_cfg.min_distance_prediction, wypt_cfg.max_distance_prediction, shape + (1,))
                if wypt_cfg.continuous_distance else rng.randint(0, wypt_cfg.discrete_distances, shape + (1,)))
    return {"pano": rng.randint(0, 13, shape + (1,)).astype(np.float32), "offset": offset.astype(np.float32),
            "distance": distance.astype(np.float32)}


# ---------------------------------------------------------------------------
# imported scene geometry (envs/scene_import.py)
# ---------------------------------------------------------------------------


def export_synthetic_geometry(geometry_dir, scene_ids, sizes=None):
    """An export for each scene id: a 1 m lattice from -2 m to -2 + size m on
    both axes, size 20 unless `sizes` maps the scene's stem to another (so
    every synthetic episode's integer start and goal lies on a node), in a
    frame whose grid origin is (-3, -3), not 0. Returns the stems."""
    import os

    from vlnce_torch.envs.scene_import import _scene_stem, save_scene_geometry, scene_from_graph
    from vlnce_torch.utils.nav_graph import LatticeGraph

    stems = sorted({_scene_stem(s) for s in scene_ids})
    for stem in stems:
        size = (sizes or {}).get(stem, 20.0)
        save_scene_geometry(os.path.join(geometry_dir, f"{stem}.npz"),
                            scene_from_graph(stem, LatticeGraph(-2.0, -2.0, size, size, 1.0)))
    return stems


def assert_imported(scene_ids):
    """The scenes the loops ran are imported, in a frame away from the origin
    (not the procedural scenes that a missing export falls back to)."""
    from vlnce_torch.envs.gridworld import get_scene
    from vlnce_torch.envs.scene_import import ImportedScene

    for scene_id in scene_ids:
        scene = get_scene(scene_id)
        assert isinstance(scene, ImportedScene) and scene.origin != (0.0, 0.0), (scene_id, type(scene).__name__)


class SceneRegistrySnapshot:
    """Scene registration is process-global in both packages: a snapshot of
    every registry, restored on exit, so that imported test scenes never
    leak into other tests' procedural scene ids."""

    def __enter__(self):
        from vlnce_torch.envs import device_sim, gridworld, scene_import
        from vlnce_tpu.envs import device_sim as jax_device_sim, gridworld as jax_gridworld, scene_import as jax_scene_import

        names = {"gridworld": ("_REGISTERED_SCENES", "_SCENE_PROVIDERS"),
                 "scene_import": ("_STEM_SCENES", "_GEOMETRY_DIRS", "_APPLIED_PICKLES", "_STEM_PROVIDER_INSTALLED"),
                 "device_sim": ("_NEAREST_FREE_CACHE",)}
        self.modules = [(m, names[kind]) for kind, ms in (("gridworld", (gridworld, jax_gridworld)),
                                                          ("scene_import", (scene_import, jax_scene_import)),
                                                          ("device_sim", (device_sim, jax_device_sim))) for m in ms]
        self.saved = [(m, name, copy.copy(getattr(m, name))) for m, names in self.modules for name in names]
        # the nearest-free-cell maps are cached by scene id: a procedural
        # scene's map would stand in for an import of the same id
        device_sim._NEAREST_FREE_CACHE.clear()
        jax_device_sim._NEAREST_FREE_CACHE.clear()
        return self

    def __exit__(self, *exc):
        for m, name, value in self.saved:
            current = getattr(m, name)
            if isinstance(current, dict):
                current.clear()
                current.update(value)
            elif isinstance(current, list):
                current[:] = value
            else:
                setattr(m, name, value)
        return False


def video_files(directory):
    """{episode file name without extension: frames} of an eval's videos (the
    JAX package's mp4 files read by OpenCV, the port's AVI files by
    `read_video`)."""
    import cv2

    from vlnce_torch.utils.video import read_video

    out = {}
    for name in sorted(os.listdir(directory)):
        stem, ext = os.path.splitext(name)
        path = os.path.join(directory, name)
        if ext == ".avi":
            out[stem] = read_video(path)
        else:
            cap, frames = cv2.VideoCapture(path), []
            while True:
                ok, img = cap.read()
                if not ok:
                    break
                frames.append(img)
            cap.release()
            out[stem] = np.stack(frames)
    return out


class EqualRanks(DataMesh):
    """A data mesh of `size` ranks that hold the same data, in one process:
    all_reduce SUM multiplies by `size`, MAX and broadcast leave the tensor.
    Build it as `EqualRanks(size, 0, torch.device("cpu"))`."""

    def all_reduce(self, tensor, op="sum"):
        return tensor.mul_(self.size) if op == "sum" else tensor

    def broadcast(self, tensor, src=0):
        return tensor
