"""Rank pairs of the production training steps (port of
vlnce_tpu/parallel/mp_smoke.py).

The reference trains DD-PPO over SLURM ranks (reference
ddppo_waypoint_trainer.py:310-370); the port's ranks are processes of one
`torch.distributed` group, one per card. This module starts such a group on
one machine (`_launch_ranks`: plain subprocesses with the rendezvous
environment torchrun would set, each with a timeout and its output kept for
the error) and runs, in every rank:

- `run_update`: the production `DaggerTrainer._update_agent` on the env
  slice [env_lo, env_hi) of one deterministic global IL batch, with the
  all_reduce'd gradients it applies saved beside the losses;
- `run_ppo_update`: `WDDPPO._grads_and_stats` (the summed gradients and
  stats) and then `WDDPPO.update_device` on the env slice of one
  deterministic PPO batch;
- the resident DAgger and the resident recollect `train()` (each rank
  collects or renders its `rank_slice` and trains data-parallel);
- the DD-PPO waypoint trainer's `train()`, one update with the rollout on
  the card (each rank collects its own, as the JAX trainer's do).

One process calling `run_update(0, N_GLOBAL)` or `run_ppo_update(0,
PPO_N_GLOBAL)` gives the whole batch's step, the reference of a rank pair.
`tests/test_torch_multiprocess_train.py` runs a pair with gloo on the CPU,
`chip_smoke.py` two ranks on one card (gloo: NCCL refuses two ranks on one
device).

A rank reads MP_SMOKE_MODE (modes separated by commas: il, ppo,
resident_recollect, resident_dagger, ddppo), MP_SMOKE_DEVICE (cpu or cuda),
MP_SMOKE_SIZE (small: the tests' narrow widths; full: the YAMLs' widths),
MP_SMOKE_BACKEND (gloo unless set), MP_SMOKE_T (the IL batch's T),
MP_SMOKE_PPO_T and MP_SMOKE_PPO_N (the PPO batch's), MP_SMOKE_IL_CKPT and MP_SMOKE_PPO_CKPT
(checkpoints of the weights; absent, the weights are the config's seeded
ones) and MP_SMOKE_OUT (where the gradients and the trainers' files go),
and prints one `MP_<MODE> {json}` line per mode.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

# the deterministic workloads (the JAX module's): a [T, N_GLOBAL] IL batch
# and a [PPO_T, PPO_N_GLOBAL] PPO batch, the env axis split over the ranks
T_STEPS = 4
N_GLOBAL = 6
IMG = 32
INSTR = 64
PPO_T = 2
PPO_N_GLOBAL = 6

IL_SMALL_OPTS = [
    "MODEL.DEPTH_ENCODER.backbone", "resnet18",
    "MODEL.RGB_ENCODER.cnn_type", "TorchVisionResNet18",
    "MODEL.INSTRUCTION_ENCODER.use_pretrained_embeddings", False,
    "MODEL.INSTRUCTION_ENCODER.bidirectional", True,
    "MODEL.PROGRESS_MONITOR.use", True,
]
IL_FULL_CONFIG = "vlnce_torch/config/experiments/r2r_baselines/cma_pm_da_aug_tune.yaml"
PPO_CONFIG = "vlnce_torch/config/experiments/r2r_waypoint/1-wpn-cc.yaml"
# the waypoint policy at the tests' small sizes (tests/torch_port_cases.py's
# WP_SMALL_OPTS): ResNet18s, a 64-d RGB head, H=64, a 64-word vocabulary
PPO_IMG = 32
PPO_SMALL_OPTS = [
    "MODEL.RGB_ENCODER.cnn_type", "TorchVisionResNet18",
    "MODEL.RGB_ENCODER.output_size", 64,
    "MODEL.DEPTH_ENCODER.backbone", "resnet18",
    "MODEL.STATE_ENCODER.hidden_size", 64,
    "MODEL.INSTRUCTION_ENCODER.vocab_size", 64,
    "MODEL.INSTRUCTION_ENCODER.use_pretrained_embeddings", False,
    "TASK_CONFIG.DATASET.TYPE", "Synthetic-VLN-v0",
    "TASK_CONFIG.SIMULATOR.RGB_SENSOR.HEIGHT", PPO_IMG,
    "TASK_CONFIG.SIMULATOR.RGB_SENSOR.WIDTH", PPO_IMG,
    "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.HEIGHT", PPO_IMG,
    "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.WIDTH", PPO_IMG,
    "TENSORBOARD_DIR", "",
]
# one epoch of one minibatch: each rank's minibatch is its whole slice, so a
# rank pair's update is the one-process update of the whole batch
PPO_ONE_MINIBATCH = ["RL.PPO.ppo_epoch", 1, "RL.PPO.num_mini_batch", 1]


def _device_opts(device: str) -> list:
    return ["CUDA.DEVICE", device, "CUDA.PRECISION.compute_dtype", "float32"]


# ------------------------------------------------------------------ IL mode
def il_config(size: str = "small", device: str = "cpu", ckpt: Optional[str] = None):
    """(config, observation space) of the IL workload: the small R2R CMA of
    the JAX module (32x32 frames, 64 tokens) or the full-width
    cma_pm_da_aug_tune.yaml (224² RGB, 256² depth, H=512), in f32."""
    from vlnce_torch.config import get_config
    from vlnce_torch.envs import spaces
    from vlnce_torch.envs.spaces import observation_space_from_config

    opts = _device_opts(device) + (["IL.ckpt_to_load", ckpt] if ckpt else [])
    if size == "small":
        cfg = get_config(opts=IL_SMALL_OPTS + opts)
        space = spaces.Dict({
            "rgb": spaces.Box(0, 255, (IMG, IMG, 3), np.uint8),
            "depth": spaces.Box(0, 1, (IMG, IMG, 1), np.float32),
            "instruction": spaces.Box(0, 10000, (INSTR,), np.int32),
            "progress": spaces.Box(0, 1, (1,), np.float32),
        })
        return cfg, space
    cfg = get_config(IL_FULL_CONFIG, opts)
    full = observation_space_from_config(cfg.TASK_CONFIG)
    return cfg, spaces.Dict({k: full[k] for k in ("rgb", "depth", "instruction", "progress")})


def global_batch(space, T: int = T_STEPS, N: int = N_GLOBAL):
    """The whole deterministic [T, N] IL batch (the same in every process):
    (obs {k: [T, N, ...]}, prev [T, N], masks [T, N], corrected [T, N],
    weights [T, N]). The last env has no weight at all and the second to
    last none after t = 1, so the ranks hold different counts of valid
    envs and rows; the last half of the envs has no weight in its final
    step, so a rank can cut its batch short (`run_update`)."""
    rng = np.random.RandomState(7)
    obs = {
        "rgb": rng.randint(0, 255, (T, N) + space["rgb"].shape).astype(np.uint8),
        "depth": rng.rand(T, N, *space["depth"].shape).astype(np.float32),
        "instruction": np.zeros((T, N) + space["instruction"].shape, space["instruction"].dtype),
        "progress": rng.rand(T, N, 1).astype(np.float32),
    }
    obs["instruction"][:, :, :6] = rng.randint(1, 50, (6,))
    prev = rng.randint(0, 4, (T, N)).astype(np.int64)
    masks = np.ones((T, N), np.float32)
    masks[0] = 0.0
    corrected = rng.randint(0, 4, (T, N)).astype(np.int64)
    weights = rng.rand(T, N).astype(np.float32) + 0.5
    weights[:, N - 1] = 0.0
    weights[2:, N - 2] = 0.0
    weights[T - 1, N // 2:] = 0.0
    return obs, prev, masks, corrected, weights


def run_update(env_lo: int, env_hi: int, size: str = "small", device: str = "cpu", ckpt: Optional[str] = None,
               T: int = T_STEPS, grads_out: Optional[str] = None) -> Dict:
    """The production DaggerTrainer update on the env slice [env_lo,
    env_hi) of `global_batch`, cut after its last weighted step (the ranks'
    time axes then differ and `prepare_global_batch` pads them back).
    Returns the losses, the slice's T and the agreed T; with `grads_out` the
    gradients the update applied (summed over the ranks) go there as npz,
    by parameter name."""
    from vlnce_torch.envs import spaces
    from vlnce_torch.parallel.il_step import global_max_time
    from vlnce_torch.parallel.optim import trainable_parameters
    from vlnce_torch.trainers.dagger_trainer import DaggerTrainer

    cfg, space = il_config(size, device, ckpt)
    trainer = DaggerTrainer(cfg)
    trainer._initialize_policy(cfg, load_from_ckpt=bool(ckpt), observation_space=space,
                               action_space=spaces.Discrete(4))
    obs, prev, masks, corrected, weights = global_batch(space, T)
    sl = slice(env_lo, env_hi)
    n = env_hi - env_lo
    t_local = int(np.nonzero(weights[:, sl].sum(axis=1))[0].max()) + 1
    applied = {}
    names = {id(p): name for name, p in trainer.policy.named_parameters()}

    def snapshot(opt, args, kwargs):
        applied.update({names[id(p)]: p.grad.detach().cpu().numpy().copy() for p in trainable_parameters(opt)})

    handle = trainer.optimizer.register_step_pre_hook(snapshot)
    loss = trainer._update_agent(
        {k: v[:t_local, sl].reshape((t_local * n,) + v.shape[2:]) for k, v in obs.items()},
        prev[:t_local, sl].reshape(-1, 1), masks[:t_local, sl].reshape(-1, 1),
        corrected[:t_local, sl], weights[:t_local, sl],
    )
    handle.remove()
    if grads_out:
        np.savez(grads_out, **applied)
    return {"loss": list(loss), "t_local": t_local, "t_global": global_max_time(trainer.mesh, t_local),
            "ranks": trainer.mesh.size if trainer.mesh else 1}


# ----------------------------------------------------------------- PPO mode
def ppo_config(size: str = "small", device: str = "cpu"):
    """(config, observation space) of the PPO workload: 1-wpn-cc.yaml, one
    epoch of one minibatch, at the tests' small sizes or at full width
    (12 pano frames of 224² RGB and 256² depth, H=256), in f32."""
    from vlnce_torch.config import get_config
    from vlnce_torch.envs import spaces

    cfg = get_config(PPO_CONFIG, (PPO_SMALL_OPTS if size == "small" else []) + PPO_ONE_MINIBATCH + _device_opts(device))
    sim = cfg.TASK_CONFIG.SIMULATOR
    rgb = (sim.RGB_SENSOR.HEIGHT, sim.RGB_SENSOR.WIDTH, 3)
    depth = (sim.DEPTH_SENSOR.HEIGHT, sim.DEPTH_SENSOR.WIDTH, 1)
    space = spaces.Dict({
        "rgb": spaces.Box(0, 255, (12,) + tuple(rgb), np.uint8),
        "depth": spaces.Box(0.0, 1.0, (12,) + tuple(depth), np.float32),
        "rgb_history": spaces.Box(0, 255, tuple(rgb), np.uint8),
        "depth_history": spaces.Box(0.0, 1.0, tuple(depth), np.float32),
        "instruction": spaces.Box(0, 2**31 - 1, (200,), np.int32),
        "angle_features": spaces.Box(-1.0, 1.0, (12, 4), np.float32),
    })
    return cfg, space


def ppo_agent(size: str = "small", device: str = "cpu", ckpt: Optional[str] = None, mesh=None):
    """The waypoint policy and WDDPPO as the ddppo-waypoint trainer builds
    them (`mesh`: the data axis, or None)."""
    from vlnce_torch.models.convert import load_policy_state_dict
    from vlnce_torch.models.waypoint_policy import WaypointPolicy
    from vlnce_torch.rl.ppo import WDDPPO
    from vlnce_torch.utils.checkpoints import load_checkpoint

    cfg, space = ppo_config(size, device)
    policy = WaypointPolicy.from_config(cfg, space)
    if ckpt:
        load_policy_state_dict(policy, load_checkpoint(ckpt)["state_dict"])
    ppo = cfg.RL.PPO
    return WDDPPO(policy, ppo, offset_regularize_coef=ppo.offset_regularize_coef,
                  pano_entropy_coef=ppo.pano_entropy_coef, offset_entropy_coef=ppo.offset_entropy_coef,
                  distance_entropy_coef=ppo.distance_entropy_coef, num_updates=int(cfg.RL.NUM_UPDATES), mesh=mesh)


def ppo_global_batch(agent, T: int = PPO_T, N: int = PPO_N_GLOBAL) -> Dict:
    """The whole deterministic PPO batch [T, N] in the update_device layout,
    numpy (the same in every process)."""
    rng = np.random.RandomState(11)
    space = agent.policy.observation_space
    obs = {}
    for k in ("rgb", "depth", "rgb_history", "depth_history"):
        box = space[k]
        obs[k] = (rng.randint(0, 255, (T, N) + box.shape).astype(np.uint8) if box.dtype == np.uint8
                  else rng.rand(T, N, *box.shape).astype(np.float32))
    obs["instruction"] = rng.randint(1, 30, (T, N, 200)).astype(np.int32)
    obs["instruction"][..., 16:] = 0
    obs["angle_features"] = rng.rand(T, N, 12, 4).astype(np.float32)

    def f(lo, hi):
        return rng.uniform(lo, hi, (T, N, 1)).astype(np.float32)

    zeros = np.zeros((T, N, 1), np.float32)
    return {
        "obs": obs,
        "hidden0": np.zeros((N, agent.policy.num_recurrent_layers, agent.policy.hidden_size), np.float32),
        "actions": {"pano": rng.randint(0, 12, (T, N, 1)).astype(np.float32), "offset": f(-0.1, 0.1),
                    "distance": f(0.3, 1.5)},
        "prev_actions": {"pano": zeros, "offset": zeros, "distance": zeros},
        "value_preds": f(-0.5, 0.5), "returns": f(0.0, 1.5), "masks": np.ones((T, N, 1), np.float32),
        "old_log_probs": f(-4.0, -2.0), "advantages": f(-0.5, 0.8),
    }


def run_ppo_update(env_lo: int, env_hi: int, size: str = "small", device: str = "cpu", ckpt: Optional[str] = None,
                   grads_out: Optional[str] = None, T: int = PPO_T, N: int = PPO_N_GLOBAL) -> Dict:
    """On the env slice [env_lo, env_hi) of `ppo_global_batch`: the
    minibatch gradients and stats summed over the ranks
    (`WDDPPO._grads_and_stats`; to `grads_out` as npz by parameter name),
    then the production `update_device`. Returns both stats."""
    from vlnce_torch.parallel.distributed import world_size
    from vlnce_torch.parallel.mesh import resolve_training_mesh
    from vlnce_torch.rl.ppo import STAT_KEYS

    cfg, _ = ppo_config(size, device)
    agent = ppo_agent(size, device, ckpt, mesh=resolve_training_mesh(cfg))
    batch = ppo_global_batch(agent, T, N)
    dev = torch.device(cfg.CUDA.DEVICE)

    def local(v, axis=1):
        if isinstance(v, dict):
            return {k: local(x, axis) for k, x in v.items()}
        return torch.from_numpy(np.ascontiguousarray(v[env_lo:env_hi] if axis == 0 else v[:, env_lo:env_hi])).to(dev)

    batch = {k: local(v, 0 if k == "hidden0" else 1) for k, v in batch.items()}
    sample = (batch["obs"], batch["hidden0"], batch["actions"], batch["prev_actions"],
              *(batch[k] for k in ("value_preds", "returns", "masks", "old_log_probs", "advantages")))
    agent.optimizer.zero_grad(set_to_none=True)
    stats = agent._grads_and_stats(sample, agent.clip_param(0), T)
    if grads_out:
        np.savez(grads_out, **{name: p.grad.detach().cpu().numpy() for name, p in agent.policy.named_parameters()
                               if p.grad is not None})
    agent.optimizer.zero_grad(set_to_none=True)
    update = agent.update_device(batch, np.random.RandomState(3))
    return {"grads_stats": dict(zip(STAT_KEYS, stats.tolist())), "update_stats": update, "ranks": world_size()}


# ------------------------------------------------------------ resident modes
# the episodes of a resident run: the DAgger plan's update_size, split over the ranks
RESIDENT_EPISODES = {"small": 4, "full": 8}


def resident_opts(tmp: str, device: str, trainer: str, size: str = "small") -> list:
    """The options of a resident run on the synthetic dataset, one epoch at
    batch 2: DAgger with the collection and the trajectory bank on the card,
    or the recollect trainer rendering on the card, resident. "small": 16x16
    frames, ResNet18s, a 64-word vocabulary, 2 envs, episodes of at most 6
    steps. "full" (DAgger, on `IL_FULL_CONFIG`): that YAML's widths and
    encoders (224² RGB, 256² depth, H=512), seeded weights, 2 envs per rank,
    episodes of at most 40 steps. Only depth is cut: the episode count, the
    rounds and epochs, the batch."""
    n_episodes = RESIDENT_EPISODES[size]
    opts = [
        "TASK_CONFIG.DATASET.TYPE", "Synthetic-VLN-v0",
        "TASK_CONFIG.DATASET.NUM_EPISODES", n_episodes,
        "NUM_ENVIRONMENTS", 2, "TENSORBOARD_DIR", "", "LOG_FILE", "",
        "CHECKPOINT_FOLDER", f"{tmp}/ckpts", "IL.epochs", 1, "IL.batch_size", 2, *_device_opts(device),
    ]
    if size == "small":
        img = 16
        opts += [
            "BASE_TASK_CONFIG_PATH", "vlnce_torch/tasks/config/vlnce_task.yaml",
            "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", 6,
            "TASK_CONFIG.SIMULATOR.RGB_SENSOR.HEIGHT", img, "TASK_CONFIG.SIMULATOR.RGB_SENSOR.WIDTH", img,
            "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.HEIGHT", img, "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.WIDTH", img,
            "MODEL.DEPTH_ENCODER.backbone", "resnet18", "MODEL.RGB_ENCODER.cnn_type", "TorchVisionResNet18",
            "MODEL.INSTRUCTION_ENCODER.use_pretrained_embeddings", False, "MODEL.INSTRUCTION_ENCODER.vocab_size", 64,
        ]
    elif trainer == "dagger":
        opts += ["TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", 40, "IL.load_from_ckpt", False]
    else:
        raise ValueError(f"a resident {trainer} run at size {size!r}: only DAgger has a full-width resident run")
    if trainer == "dagger":
        opts += ["TRAINER_NAME", "dagger", "IL.DAGGER.iterations", 1, "IL.DAGGER.update_size", n_episodes,
                 "IL.DAGGER.p", 1.0, "IL.DAGGER.lmdb_features_dir", f"{tmp}/traj",
                 "CUDA.ON_DEVICE_DAGGER", True, "CUDA.DAGGER_RESIDENT", True]
    else:
        opts += ["TRAINER_NAME", "recollect_trainer",
                 "IL.RECOLLECT_TRAINER.trajectories_file", f"{tmp}/trajectories.json.gz",
                 "IL.RECOLLECT_TRAINER.gt_file", f"{tmp}/missing_gt.json.gz",
                 "IL.RECOLLECT_TRAINER.preload_size", 2,
                 "CUDA.ON_DEVICE_RECOLLECT", True, "CUDA.RECOLLECT_RESIDENT", True]
    return opts


def _checkpoints(folder: str) -> List[str]:
    return sorted(os.listdir(folder)) if os.path.isdir(folder) else []


def run_resident(trainer_name: str, tmp: str, device: str, size: str = "small") -> Dict:
    """A full resident `train()` in this rank: its episode ids (its
    rank_slice), every train step's losses, and the checkpoints it wrote."""
    import vlnce_torch.models.cma_policy  # noqa: F401  (registers the policy)
    import vlnce_torch.tasks  # noqa: F401
    import vlnce_torch.trainers  # noqa: F401
    from vlnce_torch.config import get_config
    from vlnce_torch.data.recollection import TeacherRecollectionDataset
    from vlnce_torch.envs import ensure_registered, rl_envs  # noqa: F401
    from vlnce_torch.registry import registry

    ensure_registered()
    opts = resident_opts(tmp, device, trainer_name, size)
    cfg = get_config(IL_FULL_CONFIG, opts) if size == "full" else get_config(opts=opts)
    if trainer_name == "dagger":
        trainer = registry.get_trainer("dagger")(cfg)
        trainer.train()
        ids = [ep.episode_id for ep in trainer._collection_plan(1)[0]]
        losses = [h[2:] for h in trainer.loss_history]
        extra = {"bank_episodes": len(trainer._bank)}
    else:
        trainer = registry.get_trainer("recollect_trainer")(cfg)
        trainer.train()
        ds = TeacherRecollectionDataset(trainer.config)
        ids = [ep.episode_id for ep in ds._device_episodes]
        ds.close_sims()
        losses = [h[1:] for h in trainer.loss_history]
        extra = {}
    return {"ids": ids, "losses": losses, "checkpoints": _checkpoints(cfg.CHECKPOINT_FOLDER), **extra}


# --------------------------------------------------------------- DD-PPO mode
DDPPO_SMALL_CONFIG = "vlnce_torch/config/experiments/synthetic/smoke_waypoint.yaml"


def ddppo_opts(tmp: str, device: str, size: str = "small") -> list:
    """One update of the DD-PPO waypoint trainer with the rollout on the
    card and CUDA.PPO_UPDATE_SCAN (single-process, so the ranks take
    update_device): "small" is the synthetic smoke config (32x32 frames,
    ResNet18s, 2 envs, T=2); "full" is `PPO_CONFIG` at its widths (12 pano
    frames of 224² RGB and 256² depth, H=256) with its 4 envs per rank and
    T=16. Depth is cut to one update and the synthetic dataset."""
    opts = ["TASK_CONFIG.DATASET.TYPE", "Synthetic-VLN-v0", "RL.NUM_UPDATES", 1, "RL.CHECKPOINT_INTERVAL", 1,
            "RL.LOG_INTERVAL", 1, "CHECKPOINT_FOLDER", f"{tmp}/ckpts", "TENSORBOARD_DIR", "", "LOG_FILE", "",
            "CUDA.ON_DEVICE_ROLLOUT", True, "CUDA.PPO_UPDATE_SCAN", True, *_device_opts(device)]
    if size == "small":
        return opts + ["RL.PPO.num_steps", 2, "TASK_CONFIG.DATASET.NUM_EPISODES", 4]
    return opts + ["TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", 40]


def run_ddppo(tmp: str, device: str, size: str = "small") -> Dict:
    """The DD-PPO waypoint trainer's `train()` in this rank: the update's
    stats, a digest of the parameters it ends with, and its checkpoints."""
    import hashlib

    import vlnce_torch.trainers  # noqa: F401
    from vlnce_torch.config import get_config
    from vlnce_torch.envs import ensure_registered
    from vlnce_torch.registry import registry

    ensure_registered()
    cfg = get_config(DDPPO_SMALL_CONFIG if size == "small" else PPO_CONFIG, ddppo_opts(tmp, device, size))
    trainer = registry.get_trainer("ddppo-waypoint")(cfg)
    trainer.train()
    digest = hashlib.sha256()
    for _, p in sorted(trainer.policy.state_dict().items()):
        digest.update(p.detach().cpu().contiguous().numpy().tobytes())
    return {"ranks": trainer.mesh.size if trainer.mesh else 1, "updates": trainer.update_history,
            "n_envs": int(cfg.NUM_ENVIRONMENTS), "params": digest.hexdigest(),
            "checkpoints": _checkpoints(cfg.CHECKPOINT_FOLDER)}


# ------------------------------------------------------------------- a rank
def _launches() -> Dict[str, int]:
    from vlnce_torch.ops.preprocess import fused_resize_normalize
    from vlnce_torch.ops.rnn import gru_sequence, gru_sequence_backward, gru_weight_gradient

    return {"gru_sequence": gru_sequence.launches, "gru_sequence_backward": gru_sequence_backward.launches,
            "gru_weight_gradient": gru_weight_gradient.launches,
            "fused_resize_normalize": fused_resize_normalize.launches}


def _delta(before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before[k] for k, v in _launches().items()}


def worker_main() -> None:
    """Entry of a rank process (see `_launch_ranks`)."""
    from vlnce_torch.parallel.distributed import init_distributed, world_rank, world_size

    device = os.environ.get("MP_SMOKE_DEVICE", "cpu")
    size = os.environ.get("MP_SMOKE_SIZE", "small")
    out = os.environ.get("MP_SMOKE_OUT") or tempfile.mkdtemp()
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    backend = os.environ.get("MP_SMOKE_BACKEND", "gloo")
    assert init_distributed(backend=backend), "expected a process group from the environment"
    rank, nproc = world_rank(), world_size()
    for mode in os.environ["MP_SMOKE_MODE"].split(","):
        t0 = time.perf_counter()
        before = _launches()
        if mode == "il":
            per = N_GLOBAL // nproc
            result = run_update(rank * per, (rank + 1) * per, size, device, os.environ.get("MP_SMOKE_IL_CKPT"),
                                int(os.environ.get("MP_SMOKE_T", T_STEPS)), os.path.join(out, f"il_grads_rank{rank}.npz"))
        elif mode == "ppo":
            T, N = int(os.environ.get("MP_SMOKE_PPO_T", PPO_T)), int(os.environ.get("MP_SMOKE_PPO_N", PPO_N_GLOBAL))
            per = N // nproc
            result = run_ppo_update(rank * per, (rank + 1) * per, size, device, os.environ.get("MP_SMOKE_PPO_CKPT"),
                                    os.path.join(out, f"ppo_grads_rank{rank}.npz"), T, N)
        elif mode in ("resident_dagger", "resident_recollect"):
            tmp = os.path.join(out, f"{mode}_rank{rank}")
            result = run_resident(mode.split("_", 1)[1], tmp, device, size)
        elif mode == "ddppo":
            result = run_ddppo(os.path.join(out, f"ddppo_rank{rank}"), device, size)
        else:
            raise ValueError(f"unknown MP_SMOKE_MODE {mode!r}")
        result.update(rank=rank, seconds=time.perf_counter() - t0, launches=_delta(before))
        print(f"MP_{mode.upper()} {json.dumps(result)}", flush=True)


# ------------------------------------------------------------- the launcher
def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch_ranks(modes: str, nproc: int = 2, timeout: float = 300.0, extra_env: Optional[Dict[str, str]] = None,
                  repo_root: Optional[str] = None) -> List[str]:
    """Start `nproc` rank processes of `python -m vlnce_torch.parallel.mp_smoke`
    with torchrun's rendezvous variables set, wait for all of them (at most
    `timeout` seconds in all; a rank still running then is killed), and
    return each rank's output. Raises with every rank's output when one
    fails or hangs."""
    if repo_root is None:
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    port = _free_port()
    logs, procs = [], []
    for rank in range(nproc):
        env = dict(os.environ)
        env.update(
            RANK=str(rank), WORLD_SIZE=str(nproc), LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
            MASTER_PORT=str(port), MP_SMOKE_MODE=modes,
            PYTHONPATH=repo_root + os.pathsep + env.get("PYTHONPATH", ""),
        )
        env.update(extra_env or {})
        if env.get("MP_SMOKE_DEVICE", "cpu") == "cpu":
            env["OMP_NUM_THREADS"] = "1"
        log = tempfile.TemporaryFile()
        logs.append(log)
        procs.append(subprocess.Popen([sys.executable, "-m", "vlnce_torch.parallel.mp_smoke"], env=env, cwd=repo_root,
                                      stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    hung = False
    for p in procs:
        try:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            hung = True
            break
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read().decode(errors="replace"))
        log.close()
    failed = [rank for rank, p in enumerate(procs) if p.returncode != 0]
    if hung or failed:
        detail = "\n".join(f"--- rank {rank} (exit {p.returncode}):\n{out}" for rank, (p, out) in enumerate(zip(procs, outs)))
        raise RuntimeError(f"mp_smoke ranks {'hung past ' + str(timeout) + ' s' if hung else 'failed'} "
                           f"(ranks {failed}):\n{detail}")
    return outs


def launch(modes: str, nproc: int = 2, timeout: float = 300.0, extra_env: Optional[Dict[str, str]] = None,
           repo_root: Optional[str] = None) -> Dict[str, List[Dict]]:
    """Run `modes` (comma-separated) in a group of `nproc` ranks; returns
    {mode: [each rank's result]}."""
    outs = _launch_ranks(modes, nproc, timeout, extra_env, repo_root)
    results: Dict[str, List[Dict]] = {m: [None] * nproc for m in modes.split(",")}
    for out in outs:
        for line in out.splitlines():
            for m in results:
                if line.startswith(f"MP_{m.upper()} "):
                    r = json.loads(line.split(" ", 1)[1])
                    results[m][r["rank"]] = r
    missing = [m for m, rs in results.items() if any(r is None for r in rs)]
    if missing:
        raise RuntimeError(f"mp_smoke: no result of {missing} from some rank:\n" + "\n".join(outs))
    return results


if __name__ == "__main__":
    worker_main()
