"""Experiment-level default config tree.

The port's copy of the JAX package's tree: key-compatible with the reference
experiment config surface (reference vlnce_baselines/config/default.py:16-285
plus the habitat_baselines defaults it inherits), so reference experiment
YAMLs port 1:1. A `CUDA` subtree holds the device and precision settings.
"""

from __future__ import annotations

from typing import List, Optional, Union

import copy
import math
import os

from vlnce_torch.config.node import Config as CN
from vlnce_torch.tasks.config.default import get_extended_config as _get_task_config

CONFIG_FILE_SEPARATOR = ","

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _resolve_config_path(path: str) -> str:
    """Resolve a config path against cwd, then the repo root, so the CLI
    works from any directory."""
    if os.path.exists(path):
        return path
    rooted = os.path.join(_REPO_ROOT, path)
    if os.path.exists(rooted):
        return rooted
    return path


def get_task_config(config_paths=None, opts=None):
    if isinstance(config_paths, str):
        config_paths = _resolve_config_path(config_paths)
    return _get_task_config(config_paths, opts)

_C = CN()

# ---------------------------------------------------------------------------
# Core experiment settings (habitat_baselines-compatible surface)
# ---------------------------------------------------------------------------
_C.BASE_TASK_CONFIG_PATH = "vlnce_torch/tasks/config/vlnce_task.yaml"
_C.TASK_CONFIG = CN()  # filled by get_config from BASE_TASK_CONFIG_PATH
_C.CMD_TRAILING_OPTS = []
_C.TRAINER_NAME = "dagger"
_C.ENV_NAME = "VLNCEDaggerEnv"
_C.SIMULATOR_GPU_IDS = [0]  # kept for YAML compat; sims are CPU-side here
_C.TORCH_GPU_ID = 0  # kept for YAML compat; ignored (device = CUDA.DEVICE)
_C.NUM_ENVIRONMENTS = 4
_C.NUM_PROCESSES = -1  # deprecated alias of NUM_ENVIRONMENTS
_C.SENSORS = ["RGB_SENSOR", "DEPTH_SENSOR"]
_C.VIDEO_OPTION = []  # subset of {"disk", "tensorboard"}
_C.VIDEO_DIR = "data/videos/debug"
_C.TENSORBOARD_DIR = "data/tensorboard_dirs/debug"
_C.RESULTS_DIR = "data/checkpoints/pretrained/evals"
_C.EVAL_CKPT_PATH_DIR = "data/checkpoints"
_C.CHECKPOINT_FOLDER = "data/checkpoints"
_C.NUM_CHECKPOINTS = -1
_C.CHECKPOINT_INTERVAL = -1
_C.TOTAL_NUM_STEPS = -1.0
_C.LOG_INTERVAL = 10
_C.LOG_FILE = "train.log"
_C.FORCE_BLIND_POLICY = False
_C.VERBOSE = True

# ---------------------------------------------------------------------------
# CUDA runtime settings (the port's counterpart of the JAX package's TPU tree)
# ---------------------------------------------------------------------------
_C.CUDA = CN()
# device every entry point builds its modules and tensors on; "cpu" runs the
# kernels' plain PyTorch versions (the tests do this). No silent fallback.
# Under several ranks, "cuda" is each rank's own card (LOCAL_RANK).
_C.CUDA.DEVICE = "cuda"
# the data-parallel axis (parallel/mesh.py): the ranks of the process group,
# one process per card; -1 means all of them, k > 1 raises unless the group
# has exactly k ranks, 0 or 1 trains on one process. There is no model axis:
# MODEL must be 1.
_C.CUDA.MESH = CN()
_C.CUDA.MESH.DATA = -1
_C.CUDA.MESH.MODEL = 1
_C.CUDA.PRECISION = CN()
_C.CUDA.PRECISION.compute_dtype = "bfloat16"  # visual encoders' activations/convs
_C.CUDA.PRECISION.param_dtype = "float32"  # master weights
# DAgger collection in two env groups: while one group's simulators step, the
# card runs the other group's collect step
_C.CUDA.PIPELINED_COLLECTION = False
# torch.save + rename of a checkpoint on a background thread (the snapshot to
# host memory stays synchronous)
_C.CUDA.ASYNC_CHECKPOINT = True
# If set, training and on-card eval write a torch.profiler trace here. An
# eval's trace holds every kernel of every step replayed, so it grows with the
# split: about 1.6 MB a step of a 64-episode RxR CMA chunk at full size (set
# EVAL.EPISODE_COUNT to profile a few chunks).
_C.CUDA.PROFILE_DIR = ""
# DAgger collection on the card (trainers/device_dagger.py): render +
# frozen-encoder features + policy act + device expert + beta mix + step,
# one CUDA graph replay per step, one read-back of the done flags per
# segment of DAGGER_SEGMENT steps (requires GridWorldSim-v0)
_C.CUDA.ON_DEVICE_DAGGER = False
_C.CUDA.DAGGER_SEGMENT = 32  # env steps per segment in device collection
# collect->train on the card: collected frozen-encoder features stay in
# device memory as a DeviceTrajectoryBank feeding the IL train step directly,
# with no device->store->device round trip (data/device_bank.py). Requires
# ON_DEVICE_DAGGER (or preload_lmdb_features, which uploads the store once).
_C.CUDA.DAGGER_RESIDENT = False
# with DAGGER_RESIDENT: each run of an epoch's train steps (one padded
# length) is enqueued with its index matrix uploaded once and its losses
# read back once (data/device_bank.run_fused_epoch)
_C.CUDA.RESIDENT_EPOCH_SCAN = False
# with DAGGER_RESIDENT: also archive collected trajectories into the
# trajectory store after each round's collection; off by default, the store
# is only needed for preloading later runs
_C.CUDA.DAGGER_ARCHIVE_STORE = False
# precomputed per-(node, heading) visual feature bank directory
# (data/feature_bank.py; written with encode_scene_bank + save_scene_bank).
# When set, the loops on the card (EVAL / INFERENCE.ON_DEVICE_SCAN,
# ON_DEVICE_DAGGER) look the frozen features up in place of rendering, into
# the encoders' rgb_features / depth_features bypass: the route by which
# real scenes ride the loops on the card.
_C.CUDA.FEATURE_BANK_DIR = ""
# coverage guard for bank lookups (meters; 0 = off). Poses farther than this
# from every bank node receive ZERO features instead of the nearest node's
# wrong view, and episode starts outside coverage fail loudly at load
# (data/feature_bank.py lookup_features / check_bank_coverage). Lattice
# spacing s puts true poses up to s/sqrt(2) from a node: set this >= that.
_C.CUDA.FEATURE_BANK_MAX_DIST = 0.0
# recollection rendered on the card (data/device_recollect.py): the GT
# trajectories re-rendered along their actions, one CUDA graph replay per
# step, no env pool (requires GridWorldSim-v0); with RECOLLECT_RESIDENT the
# obs transforms run inside the render step and the batch stays on the card
_C.CUDA.ON_DEVICE_RECOLLECT = False
_C.CUDA.RECOLLECT_RESIDENT = False
# DD-PPO rollouts collected on the card (rl/device_rollout.py): one CUDA
# graph replay per env step, the PPO batch kept there for
# WDDPPO.update_device_scan
_C.CUDA.ON_DEVICE_ROLLOUT = False
# read by nothing: the on-card update is always WDDPPO.update_device_scan.
# The key stays only so that benchmark/configs/r2r_wpn_cc.json, which sets
# it, still loads; it leaves with the next change to the benchmark.
_C.CUDA.PPO_UPDATE_SCAN = False
# the on-device rollout uploads the whole train split once when it holds at
# most this many episodes (then a rollout uploads only a [B, T+1] index
# map); above it, each rollout uploads its episode queue
_C.CUDA.EPISODE_BANK_MAX = 8192

# ---------------------------------------------------------------------------
# EVAL
# ---------------------------------------------------------------------------
_C.EVAL = CN()
_C.EVAL.SPLIT = "val_seen"
_C.EVAL.EPISODE_COUNT = -1
_C.EVAL.LANGUAGES = ["en-US", "en-IN"]
_C.EVAL.SAMPLE = False
_C.EVAL.SAVE_RESULTS = True
_C.EVAL.USE_CKPT_CONFIG = True
# the closed loop on the card: the device-resident grid world and the
# policy, one CUDA graph replay per env step (trainers/scan_eval.py;
# requires GridWorldSim-v0)
_C.EVAL.ON_DEVICE_SCAN = False
_C.EVAL.SCAN_BATCH = 8  # episodes rolled out together (one chunk, the graph's B)
_C.EVAL.SCAN_SEGMENT = 64  # env steps per read-back (early exit between segments)
_C.EVAL.EVAL_NONLEARNING = False
_C.EVAL.NONLEARNING = CN()
_C.EVAL.NONLEARNING.AGENT = "RandomAgent"

# ---------------------------------------------------------------------------
# INFERENCE
# ---------------------------------------------------------------------------
_C.INFERENCE = CN()
_C.INFERENCE.SPLIT = "test"
_C.INFERENCE.LANGUAGES = ["en-US", "en-IN"]
_C.INFERENCE.SAMPLE = False
_C.INFERENCE.USE_CKPT_CONFIG = True
_C.INFERENCE.CKPT_PATH = "data/checkpoints/CMA_PM_DA_Aug.pth"
_C.INFERENCE.PREDICTIONS_FILE = "predictions.json"
_C.INFERENCE.INFERENCE_NONLEARNING = False
_C.INFERENCE.NONLEARNING = CN()
_C.INFERENCE.NONLEARNING.AGENT = "RandomAgent"
_C.INFERENCE.FORMAT = "rxr"  # either "rxr" or "r2r"
# the inference loop on the card (trainers/scan_eval.py)
_C.INFERENCE.ON_DEVICE_SCAN = False

# ---------------------------------------------------------------------------
# IMITATION LEARNING
# ---------------------------------------------------------------------------
_C.IL = CN()
_C.IL.lr = 2.5e-4
_C.IL.batch_size = 5
_C.IL.epochs = 4
_C.IL.use_iw = True
# inflection coefficient: 3.2 for R2R GT trajectories, 1.9 for RxR guide
_C.IL.inflection_weight_coef = 3.2
# batches decoded ahead by a background prefetch thread (the reference's 3
# DataLoader workers, dagger_trainer.py:539); 0 = inline
_C.IL.prefetch_batches = 3
_C.IL.load_from_ckpt = False
_C.IL.ckpt_to_load = "data/checkpoints/ckpt.0.pth"
_C.IL.is_requeue = False

_C.IL.RECOLLECT_TRAINER = CN()
_C.IL.RECOLLECT_TRAINER.preload_trajectories_file = False
_C.IL.RECOLLECT_TRAINER.trajectories_file = "data/trajectories_dirs/debug/trajectories.json.gz"
_C.IL.RECOLLECT_TRAINER.max_traj_len = -1
_C.IL.RECOLLECT_TRAINER.effective_batch_size = -1
_C.IL.RECOLLECT_TRAINER.preload_size = 30
_C.IL.RECOLLECT_TRAINER.gt_file = "data/datasets/RxR_VLNCE_v0/{split}/{split}_{role}_gt.json.gz"

_C.IL.DAGGER = CN()
_C.IL.DAGGER.iterations = 10
_C.IL.DAGGER.start_iteration = 0
_C.IL.DAGGER.update_size = 5000
_C.IL.DAGGER.p = 0.75
_C.IL.DAGGER.expert_policy_sensor = "SHORTEST_PATH_SENSOR"
_C.IL.DAGGER.expert_policy_sensor_uuid = "shortest_path_sensor"
# trajectory store settings ("lmdb_*" names kept for YAML compat)
_C.IL.DAGGER.lmdb_map_size = 1.2e12
_C.IL.DAGGER.lmdb_fp16 = False
_C.IL.DAGGER.lmdb_commit_frequency = 500
_C.IL.DAGGER.preload_lmdb_features = False
_C.IL.DAGGER.lmdb_features_dir = "data/trajectories_dirs/debug/trajectories.lmdb"
_C.IL.DAGGER.drop_existing_lmdb_features = True
# aliases kept because some published experiment YAMLs place these under
# DAGGER; IL.load_from_ckpt/ckpt_to_load are authoritative
_C.IL.DAGGER.load_from_ckpt = False
_C.IL.DAGGER.ckpt_to_load = ""

# ---------------------------------------------------------------------------
# RL / PPO / DD-PPO
# ---------------------------------------------------------------------------
_C.RL = CN()
_C.RL.REWARD_MEASURE = "waypoint_reward_measure"
_C.RL.SUCCESS_MEASURE = "success"
_C.RL.SLACK_REWARD = -0.01
_C.RL.SUCCESS_REWARD = 2.5
_C.RL.NUM_UPDATES = 200000
_C.RL.LOG_INTERVAL = 10
_C.RL.CHECKPOINT_INTERVAL = 250

_C.RL.POLICY = CN()
_C.RL.POLICY.name = "PointNavResNetPolicy"  # habitat compat; unused
_C.RL.POLICY.OBS_TRANSFORMS = CN()
_C.RL.POLICY.OBS_TRANSFORMS.ENABLED_TRANSFORMS = []
_C.RL.POLICY.OBS_TRANSFORMS.OBS_STACK = CN()
_C.RL.POLICY.OBS_TRANSFORMS.OBS_STACK.SENSOR_REWRITES = [
    ("rgb", ["rgb"] + [f"rgb_{i}" for i in range(1, 12)]),
    ("depth", ["depth"] + [f"depth_{i}" for i in range(1, 12)]),
]
_C.RL.POLICY.OBS_TRANSFORMS.CENTER_CROPPER_PER_SENSOR = CN()
_C.RL.POLICY.OBS_TRANSFORMS.CENTER_CROPPER_PER_SENSOR.SENSOR_CROPS = [
    ("rgb", (224, 224)),
    ("depth", (256, 256)),
]
_C.RL.POLICY.OBS_TRANSFORMS.RESIZE_SHORTEST_EDGE = CN()
_C.RL.POLICY.OBS_TRANSFORMS.RESIZE_SHORTEST_EDGE.SIZE = 256

_C.RL.PPO = CN()
_C.RL.PPO.clip_param = 0.2
_C.RL.PPO.ppo_epoch = 2
_C.RL.PPO.num_mini_batch = 4
_C.RL.PPO.value_loss_coef = 0.5
_C.RL.PPO.clip_value_loss = True
_C.RL.PPO.entropy_coef = 0.01
_C.RL.PPO.pano_entropy_coef = 1.0
_C.RL.PPO.offset_entropy_coef = 0.0
_C.RL.PPO.distance_entropy_coef = 0.0
_C.RL.PPO.lr = 2.0e-4
_C.RL.PPO.eps = 1e-5
_C.RL.PPO.max_grad_norm = 0.2
_C.RL.PPO.num_steps = 16
_C.RL.PPO.use_gae = True
_C.RL.PPO.use_linear_lr_decay = False
_C.RL.PPO.use_linear_clip_decay = False
_C.RL.PPO.gamma = 0.99
_C.RL.PPO.tau = 0.95
_C.RL.PPO.reward_window_size = 50
_C.RL.PPO.use_normalized_advantage = False
_C.RL.PPO.offset_regularize_coef = 0.1146
_C.RL.PPO.hidden_size = 512

_C.RL.DDPPO = CN()
_C.RL.DDPPO.sync_frac = 0.6
# torch.distributed backend of the process group when CUDA.DEVICE is a card
# (the CPU always takes gloo); two ranks on one card need GLOO, NCCL refuses
_C.RL.DDPPO.distrib_backend = "NCCL"
_C.RL.DDPPO.reset_critic = True
_C.RL.DDPPO.start_from_requeue = False
_C.RL.DDPPO.requeue_path = "data/interrupted_state.pth"
_C.RL.DDPPO.pretrained_weights = ""
_C.RL.DDPPO.pretrained = False

# ---------------------------------------------------------------------------
# MODEL
# ---------------------------------------------------------------------------
_C.MODEL = CN()
_C.MODEL.policy_name = "CMAPolicy"
_C.MODEL.normalize_rgb = False
_C.MODEL.ablate_depth = False
_C.MODEL.ablate_rgb = False
_C.MODEL.ablate_instruction = False

_C.MODEL.INSTRUCTION_ENCODER = CN()
_C.MODEL.INSTRUCTION_ENCODER.sensor_uuid = "instruction"
_C.MODEL.INSTRUCTION_ENCODER.vocab_size = 2504
_C.MODEL.INSTRUCTION_ENCODER.use_pretrained_embeddings = True
_C.MODEL.INSTRUCTION_ENCODER.embedding_file = "data/datasets/R2R_VLNCE_v1-3_preprocessed/embeddings.json.gz"
_C.MODEL.INSTRUCTION_ENCODER.dataset_vocab = "data/datasets/R2R_VLNCE_v1-3_preprocessed/train/train.json.gz"
_C.MODEL.INSTRUCTION_ENCODER.fine_tune_embeddings = False
_C.MODEL.INSTRUCTION_ENCODER.embedding_size = 50
_C.MODEL.INSTRUCTION_ENCODER.hidden_size = 128
_C.MODEL.INSTRUCTION_ENCODER.rnn_type = "LSTM"
_C.MODEL.INSTRUCTION_ENCODER.final_state_only = True
_C.MODEL.INSTRUCTION_ENCODER.bidirectional = False

_C.MODEL.RGB_ENCODER = CN()
_C.MODEL.RGB_ENCODER.cnn_type = "TorchVisionResNet50"
_C.MODEL.RGB_ENCODER.output_size = 256
_C.MODEL.RGB_ENCODER.trainable = False
# recompute the CNN in the backward pass (training slices; unused by act)
_C.MODEL.RGB_ENCODER.remat = False

_C.MODEL.DEPTH_ENCODER = CN()
_C.MODEL.DEPTH_ENCODER.cnn_type = "VlnResnetDepthEncoder"
_C.MODEL.DEPTH_ENCODER.output_size = 128
_C.MODEL.DEPTH_ENCODER.backbone = "resnet50"
_C.MODEL.DEPTH_ENCODER.ddppo_checkpoint = "data/ddppo-models/gibson-2plus-resnet50.pth"
_C.MODEL.DEPTH_ENCODER.trainable = False
_C.MODEL.DEPTH_ENCODER.remat = False

_C.MODEL.STATE_ENCODER = CN()
_C.MODEL.STATE_ENCODER.hidden_size = 512
_C.MODEL.STATE_ENCODER.rnn_type = "GRU"

_C.MODEL.PROGRESS_MONITOR = CN()
_C.MODEL.PROGRESS_MONITOR.use = False
_C.MODEL.PROGRESS_MONITOR.alpha = 1.0

_C.MODEL.SEQ2SEQ = CN()
_C.MODEL.SEQ2SEQ.use_prev_action = False

_C.MODEL.CMA = CN()  # key kept for YAML compat (reference test_set_inference)
_C.MODEL.CMA.use = False

_C.MODEL.WAYPOINT = CN()
_C.MODEL.WAYPOINT.predict_distance = True
_C.MODEL.WAYPOINT.continuous_distance = True
_C.MODEL.WAYPOINT.min_distance_var = 0.0625
_C.MODEL.WAYPOINT.max_distance_var = 3.52
_C.MODEL.WAYPOINT.max_distance_prediction = 2.75
_C.MODEL.WAYPOINT.min_distance_prediction = 0.25
_C.MODEL.WAYPOINT.discrete_distances = 6
_C.MODEL.WAYPOINT.predict_offset = True
_C.MODEL.WAYPOINT.continuous_offset = True
_C.MODEL.WAYPOINT.min_offset_var = 0.0110
_C.MODEL.WAYPOINT.max_offset_var = 0.0685
_C.MODEL.WAYPOINT.discrete_offsets = 7
_C.MODEL.WAYPOINT.offset_temperature = 1.0


def get_default_config() -> CN:
    return _C.clone()


def get_config(
    config_paths: Optional[Union[List[str], str]] = None,
    opts: Optional[list] = None,
) -> CN:
    """defaults <- YAML chain <- CLI opts; TASK_CONFIG reloaded whenever a
    YAML changes BASE_TASK_CONFIG_PATH (mirrors reference
    vlnce_baselines/config/default.py:294-334)."""
    config = _C.clone()
    config.TASK_CONFIG = get_task_config(config.BASE_TASK_CONFIG_PATH).clone().defrost()

    if config_paths:
        if isinstance(config_paths, str):
            config_paths = (
                config_paths.split(CONFIG_FILE_SEPARATOR)
                if CONFIG_FILE_SEPARATOR in config_paths
                else [config_paths]
            )
        import yaml as _yaml

        prev_task_config = ""
        for config_path in config_paths:
            config_path = _resolve_config_path(config_path)
            # reload the base task config BEFORE merging the file so
            # TASK_CONFIG overrides in the same YAML survive (the reference
            # reloads after, silently dropping them)
            with open(config_path) as f:
                peeked = _yaml.safe_load(f) or {}
            base_path = peeked.get("BASE_TASK_CONFIG_PATH", config.BASE_TASK_CONFIG_PATH)
            if base_path != prev_task_config:
                config.BASE_TASK_CONFIG_PATH = base_path
                config.TASK_CONFIG = get_task_config(base_path).clone().defrost()
                prev_task_config = base_path
            config.merge_from_file(config_path)

    if opts:
        config.CMD_TRAILING_OPTS = list(opts)
        opts = list(opts)
        # honor a BASE_TASK_CONFIG_PATH override before merging the rest so
        # later TASK_CONFIG.* opts land on the reloaded tree
        for k, v in zip(opts[0::2], opts[1::2]):
            if k == "BASE_TASK_CONFIG_PATH" and v != config.BASE_TASK_CONFIG_PATH:
                config.BASE_TASK_CONFIG_PATH = v
                config.TASK_CONFIG = get_task_config(v).clone().defrost()
        config.merge_from_list(opts)

    config.freeze()
    return config


def add_pano_sensors_to_config(config: CN) -> CN:
    """Clone the RGB/DEPTH sensor configs into PANO_ROTATIONS equiangular
    orientations (uuids rgb, rgb_1..rgb_{N-1}; same for depth). Mirrors
    reference vlnce_baselines/config/default.py:337-382."""
    num_cameras = config.TASK_CONFIG.TASK.PANO_ROTATIONS
    config.defrost()
    orientations = [(0.0, 2.0 * math.pi / num_cameras * i, 0.0) for i in range(num_cameras)]

    for kind in ("RGB", "DEPTH"):
        base_key = f"{kind}_SENSOR"
        if base_key not in config.TASK_CONFIG.SIMULATOR.AGENT_0.SENSORS:
            continue
        base = config.TASK_CONFIG.SIMULATOR[base_key]
        base.ORIENTATION = list(orientations[0])
        for camera_id in range(1, num_cameras):
            template = f"{kind}_{camera_id}"
            cam = copy.deepcopy(base)
            cam.ORIENTATION = list(orientations[camera_id])
            cam.UUID = template.lower()
            setattr(config.TASK_CONFIG.SIMULATOR, template, cam)
            config.TASK_CONFIG.SIMULATOR.AGENT_0.SENSORS.append(template)

    config.SENSORS = list(config.TASK_CONFIG.SIMULATOR.AGENT_0.SENSORS)
    config.freeze()
    return config
