"""DD-PPO waypoint trainer, on one card or across ranks (port of
vlnce_tpu/trainers/ddppo_waypoint_trainer.py; reference
vlnce_baselines/ddppo_waypoint_trainer.py:54-986).

One host process drives the whole env pool (forked simulator workers) and
the card: per env step one act step of the WaypointPolicy on the stacked
pano observations (two GRUs, each one B1 launch), the env steps, and the
rollout storage's insert on the host; per update the bootstrap value, GAE,
and `rl/ppo.WDDPPO.update` over `ppo_epoch x num_mini_batch` minibatches
(sequence forward, autograd with B1's backward kernel, masked Adam). With
`CUDA.PIPELINED_COLLECTION` the envs are split into two groups: while one
group's simulators step, the card runs the other group's act step. The
rollout storage stays on the host, as in the JAX package; each minibatch
is uploaded through pinned copies.

Preemption and requeue as the reference's: SIGUSR1 sets EXIT and REQUEUE,
SIGTERM sets EXIT (handlers installed in the main thread after the workers
have forked, so the workers keep the default handlers, and restored when
`train` returns); on REQUEUE the training state (weights, optimizer, update
counter) is written to `RL.DDPPO.requeue_path` and restored on a restart
with `RL.DDPPO.start_from_requeue`.

With `CUDA.ON_DEVICE_ROLLOUT` no worker is forked: one probe env gives the
spaces and closes, and `rl/device_rollout.DeviceRolloutCollector` runs each
rollout on the card (the grid world, the act step, the reward and the
auto-reset; one CUDA graph replay per env step, the bootstrap value and GAE
in a second graph, one read-back of the episode stats). The PPO batch stays
on the card for `WDDPPO.update_device_scan` (its minibatch step captured in
a CUDA graph on one process, eager across ranks). One such update is
`train_update_on_device`, which `train` calls once per update after
`start_device_rollout` (the benchmark drives the same two methods).
`train` builds the spaces, the policy and WDDPPO by `_get_spaces` and
`_initialize_policy`, which the benchmark calls too.

Across ranks (the reference's DD-PPO ranks; `CUDA.MESH.DATA`, one process
per card, `parallel/mesh.resolve_training_mesh`) each rank collects its own
rollout, host or on the card, and `WDDPPO` sums the minibatch gradients and
stats over the ranks. Only rank 0 writes checkpoints; every rank writes the
requeue state (a node-local path every rank must find again). As in the JAX
trainer, the ranks share `TASK_CONFIG.SEED`.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
from collections import defaultdict, deque
from typing import Dict, List, Optional

import numpy as np
import torch

from vlnce_torch.config.default import add_pano_sensors_to_config
from vlnce_torch.envs import spaces
from vlnce_torch.envs.batch import stack_obs, to_device
from vlnce_torch.envs.env_utils import construct_envs, construct_envs_auto_reset_false, get_env_class
from vlnce_torch.models.convert import load_policy_state_dict
from vlnce_torch.models.waypoint_policy import WaypointPolicy
from vlnce_torch.ops.obs_transforms import (
    apply_obs_transforms_batch,
    apply_obs_transforms_obs_space,
    get_active_obs_transforms,
)
from vlnce_torch.parallel.mesh import resolve_training_mesh
from vlnce_torch.parallel.optim import load_optim_state
from vlnce_torch.registry import registry
from vlnce_torch.rl.ppo import WDDPPO
from vlnce_torch.rl.rollout_storage import ActionDictRolloutStorage
from vlnce_torch.trainers.base_trainer import BaseVLNCETrainer
from vlnce_torch.utils.checkpoints import load_checkpoint, save_checkpoint, wait_for_pending
from vlnce_torch.utils.logging import logger
from vlnce_torch.utils.profiling import StepClock, annotate, maybe_profile
from vlnce_torch.utils.progress import tqdm
from vlnce_torch.utils.tensorboard import TensorboardWriter
from vlnce_torch.utils.video import generate_video, waypoint_observations_to_image

EXIT = {"flag": False}
REQUEUE = {"flag": False}
_ACTION_KEYS = ("pano", "offset", "distance")


def _signal_handler(signum, frame):
    EXIT["flag"] = True
    if signum == signal.SIGUSR1:
        REQUEUE["flag"] = True


def add_signal_handlers() -> Dict[int, object]:
    """Install the EXIT/REQUEUE handlers (main thread only) and return the
    handlers they replace."""
    EXIT["flag"] = REQUEUE["flag"] = False
    if threading.current_thread() is not threading.main_thread():
        return {}
    return {sig: signal.signal(sig, _signal_handler) for sig in (signal.SIGUSR1, signal.SIGTERM)}


def _video_readback(out) -> Dict[str, np.ndarray]:
    """What a waypoint eval frame shows of one act step, for the whole batch
    in one read-back: r, theta, the pano, offset and distance actions, their
    modes, stop, and the pano-stop distribution (a host softmax)."""
    cols = [out["r"], out["theta"], out["action_elements"]["pano"], out["action_elements"]["offset"],
            out["modes"]["offset"], out["action_elements"]["distance"], out["modes"]["distance"], out["stop"]]
    n = out["pano_stop_logits"].shape[0]
    host = torch.cat([c.reshape(n, -1).float() for c in cols] + [out["pano_stop_logits"].reshape(n, -1).float()], 1).cpu().numpy()
    names = ("r", "theta", "pano", "offset", "offset_mode", "distance", "distance_mode", "stop")
    step = {k: host[:, j] for j, k in enumerate(names)}
    logits = host[:, len(names):] - host[:, len(names):].max(axis=-1, keepdims=True)
    probs = np.exp(logits)
    step["probs"] = probs / probs.sum(axis=-1, keepdims=True)
    step["pano"] = step["pano"].astype(np.int64)
    step["stop"] = step["stop"] != 0
    return step


@registry.register_trainer(name="ddppo-waypoint")
class DDPPOWaypointTrainer(BaseVLNCETrainer):
    # set before `train()` to have every PPO minibatch step split by the
    # device's clock into `step_clock` (upload, forward, backward, optimizer)
    time_train_steps = False

    def __init__(self, config):
        config = add_pano_sensors_to_config(config)
        self._interrupted_state = None
        requeue_path = config.RL.DDPPO.requeue_path
        if config.RL.DDPPO.start_from_requeue and os.path.exists(requeue_path):
            self._interrupted_state = load_checkpoint(requeue_path)
        super().__init__(config)
        self.agent: Optional[WDDPPO] = None
        self.envs = None
        # per update: {update, count_steps, stats...}; and the rollout's clocks
        self.update_history: List[Dict[str, float]] = []
        self.rollout_stats: Dict[str, float] = {}
        self.collector = None  # the rollout on the card, with CUDA.ON_DEVICE_ROLLOUT
        # the on-card path's episode statistics, made by start_device_rollout
        self.current_episode_reward: Optional[np.ndarray] = None
        self.running_episode_stats: Dict[str, np.ndarray] = {}

    # ----------------------------------------------------------------- spaces
    def _get_spaces(self, config, envs=None):
        """The observation space (the transformed pano sensors and the
        history frames) and the action space, of `envs` or of one probe env. `config` is the trainer's own: its pano sensors
        were added by the constructor."""
        if envs is not None:
            env_space, action_space = envs.observation_spaces[0], envs.action_spaces[0]
        else:
            probe = get_env_class(config.ENV_NAME)(config.clone())
            try:
                env_space, action_space = probe.observation_space, probe.action_space
            finally:
                probe.close()
        self._set_observation_space(env_space)
        return self.observation_space, action_space

    def _initialize_policy(self, config, load_from_ckpt: bool, observation_space, action_space) -> None:
        """The waypoint policy and WDDPPO over `observation_space`
        (`_get_spaces`'), from the trainer's config; with `load_from_ckpt`,
        the weights of `config.IL.ckpt_to_load`."""
        self.observation_space = observation_space
        self._initialize_policy_rl(load_from_ckpt, config.IL.ckpt_to_load if load_from_ckpt else "")

    def _set_observation_space(self, env_space) -> None:
        """Transformed obs space + per-frame history spaces from one env's
        observation space (reference:73-100)."""
        self.obs_transforms = get_active_obs_transforms(self.config)
        observation_space = apply_obs_transforms_obs_space(env_space, self.obs_transforms)
        single_rgb, single_depth = observation_space["rgb"], observation_space["depth"]
        new = dict(observation_space.spaces)
        new["rgb_history"] = spaces.Box(0, 255, single_rgb.shape[1:], single_rgb.dtype)
        new["depth_history"] = spaces.Box(0.0, 1.0, single_depth.shape[1:], single_depth.dtype)
        self.observation_space = spaces.Dict(new)

    def _initialize_policy_rl(self, load_from_ckpt: bool, ckpt_path: str = "") -> None:
        config = self.config
        self.policy = WaypointPolicy.from_config(config, self.observation_space)
        self.generator = torch.Generator(device=self.policy.device).manual_seed(int(config.TASK_CONFIG.SEED))
        if load_from_ckpt:
            load_policy_state_dict(self.policy, load_checkpoint(ckpt_path)["state_dict"])
            logger.info(f"Loaded waypoint policy from {ckpt_path}")
        # the data-parallel axis per CUDA.MESH.DATA (-1 auto, k > 1 raises
        # unless the process group has k ranks); each rank collects locally
        self.mesh = resolve_training_mesh(config)
        ppo = config.RL.PPO
        self.agent = WDDPPO(
            self.policy, ppo,
            offset_regularize_coef=ppo.offset_regularize_coef,
            pano_entropy_coef=ppo.pano_entropy_coef,
            offset_entropy_coef=ppo.offset_entropy_coef,
            distance_entropy_coef=ppo.distance_entropy_coef,
            num_updates=int(config.RL.NUM_UPDATES),
            mesh=self.mesh,
        )
        self.optimizer = self.agent.optimizer
        logger.info(f"Initialized WaypointPolicy on {self.policy.device}: {self.policy.num_params()} params "
                    f"(data-parallel over {self.mesh.size if self.mesh else 1} ranks)")

    # ---------------------------------------------------------------- helpers
    @staticmethod
    def _extract_scalars_from_infos(infos: List[Dict]) -> Dict[str, List[float]]:
        out = defaultdict(list)
        for info in infos:
            for k, v in info.items():
                if np.isscalar(v) and not isinstance(v, str):
                    out[k].append(float(v))
        return out

    def _prepare_batch(self, observations: List[Dict], obs_history: Dict[str, np.ndarray]):
        """The stacked observations uploaded (pinned) and transformed on the
        card once, with the history frames; returns (device batch, host
        batch): act() reads the device copy, the rollout storage the host
        one (the transformed sensors downloaded, the history as given)."""
        device = self.policy.device
        dev = apply_obs_transforms_batch(to_device(stack_obs(observations), device), self.obs_transforms)
        host = {k: v.cpu().numpy() for k, v in dev.items()}
        history = {"rgb_history": obs_history["rgb"], "depth_history": obs_history["depth"]}
        dev.update(to_device(history, device))
        host.update({k: np.array(v) for k, v in history.items()})
        return dev, host

    @staticmethod
    def _history_frames(out, rgb_np: np.ndarray, depth_np: np.ndarray) -> Dict[str, np.ndarray]:
        """The next history frames: the pano frame each env moved toward
        (reference ddppo_waypoint_trainer.py:190-200), zeros on STOP."""
        pano = out["action_elements"]["pano"].reshape(-1).long().cpu().numpy()
        stop = out["stop"].reshape(-1).cpu().numpy()
        hist = {"rgb": np.zeros_like(rgb_np[:, 0]), "depth": np.zeros_like(depth_np[:, 0])}
        for i in range(len(stop)):
            if not stop[i]:
                idx = int(pano[i]) % rgb_np.shape[1]
                hist["rgb"][i] = rgb_np[i, idx]
                hist["depth"][i] = depth_np[i, idx]
        return hist

    # ------------------------------------------------------------------ train
    def train(self) -> None:
        config = self.config
        if bool(config.CUDA.ON_DEVICE_ROLLOUT):
            # no env pool: the grid world steps on the card
            # (rl/device_rollout.py); `_get_spaces` probes one env
            self.envs = None
        else:
            # the workers fork before the handlers are installed: they keep
            # the default handlers, so close() can still end them
            self.envs = construct_envs(config, get_env_class(config.ENV_NAME))
        previous_handlers = add_signal_handlers()
        try:
            self._train(config)
        finally:
            for sig, handler in previous_handlers.items():
                signal.signal(sig, handler)
            if self.envs is not None:
                self.envs.close()
            # join any in-flight async checkpoint write before returning
            wait_for_pending()

    def _train(self, config) -> None:
        on_device = self.envs is None
        N = int(config.NUM_ENVIRONMENTS) if on_device else self.envs.num_envs
        observation_space, action_space = self._get_spaces(config, self.envs)
        self._initialize_policy(config, False, observation_space, action_space)
        self.step_clock = StepClock(self.policy.device) if self.time_train_steps else None
        ppo_cfg = config.RL.PPO
        rollouts = None
        if on_device:
            self.start_device_rollout()
            current_episode_reward, running_episode_stats = self.current_episode_reward, self.running_episode_stats
        else:
            rollouts = ActionDictRolloutStorage(
                ppo_cfg.num_steps, N, self.observation_space, config.MODEL.STATE_ENCODER.hidden_size,
                num_recurrent_layers=self.policy.num_recurrent_layers,
            )
            observations = self.envs.reset()
            obs_history = {
                "rgb": np.zeros_like(rollouts.observations["rgb_history"][0]),
                "depth": np.zeros_like(rollouts.observations["depth_history"][0]),
            }
            # two-group pipelined rollout collection: group A's simulators
            # step while the card runs group B's act step; the device batch
            # is carried per group, so no observation is uploaded twice
            pipelined = bool(config.CUDA.PIPELINED_COLLECTION) and N >= 2
            self._group_bounds = [(0, N // 2), (N // 2, N)] if pipelined else [(0, N)]
            self._dev_batches = []
            host_parts = []
            for lo, hi in self._group_bounds:
                dev_g, host_g = self._prepare_batch(observations[lo:hi], {k: v[lo:hi] for k, v in obs_history.items()})
                self._dev_batches.append(dev_g)
                host_parts.append(host_g)
            for k in host_parts[0]:
                rollouts.observations[k][0] = np.concatenate([p[k] for p in host_parts], axis=0)

            current_episode_reward = np.zeros((N, 1), np.float32)
            running_episode_stats = {"count": np.zeros((N, 1), np.float32), "reward": np.zeros((N, 1), np.float32)}
        window_episode_stats = defaultdict(lambda: deque(maxlen=ppo_cfg.reward_window_size))

        start_update = count_steps = 0
        if self._interrupted_state is not None:
            load_policy_state_dict(self.policy, self._interrupted_state["state_dict"])
            if self._interrupted_state.get("optim_state"):
                load_optim_state(self.optimizer, self.policy, self._interrupted_state["optim_state"])
            extra = self._interrupted_state.get("extra_state") or {}
            start_update = int(extra.get("update", 0))
            count_steps = int(extra.get("count_steps", 0))
            self.agent.optimizer_steps = start_update * ppo_cfg.ppo_epoch * ppo_cfg.num_mini_batch
            logger.info(f"Resumed from requeue state at update {start_update}")

        rng_np = np.random.RandomState(config.TASK_CONFIG.SEED)
        t_start = time.time()
        timing = {"rollout_time": 0.0, "act_time": 0.0, "first_act_time": 0.0, "env_time": 0.0, "update_time": 0.0,
                  "first_rollout_time": 0.0, "first_update_time": 0.0, "act_steps": 0, "env_steps": 0}

        os.makedirs(config.CHECKPOINT_FOLDER, exist_ok=True)
        update = start_update
        with TensorboardWriter(config.TENSORBOARD_DIR) as writer, maybe_profile(config.CUDA.PROFILE_DIR):
            for update in range(start_update, config.RL.NUM_UPDATES):
                if EXIT["flag"]:
                    break
                if on_device:
                    stats, spent = self.train_update_on_device(update, rng_np)
                    count_steps += spent["env_steps"]
                    timing["env_steps"] += spent["env_steps"]
                    rollout_s, update_s = spent["rollout_s"], spent["update_s"]
                else:
                    t0 = time.time()
                    with annotate("ppo.rollout"):
                        for _step in range(ppo_cfg.num_steps):
                            self._collect_rollout_step(rollouts, current_episode_reward, running_episode_stats, timing)
                            count_steps += N
                    rollout_s = time.time() - t0
                    t0 = time.time()
                    stats = self._update_from_storage(rollouts, rng_np, update)
                    update_s = time.time() - t0
                timing["rollout_time"] += rollout_s
                timing["update_time"] += update_s
                if update == start_update:  # the kernels' build, the graphs' capture, the libraries' warm-up
                    timing["first_update_time"] = update_s
                    if on_device:
                        timing["first_rollout_time"] = rollout_s

                # one cumulative snapshot per update; logging takes the delta
                # between the newest and oldest snapshots in the window
                for k, v in running_episode_stats.items():
                    window_episode_stats[k].append(v.copy())

                self.update_history.append({"update": update, "count_steps": count_steps, **stats})

                if update % config.RL.LOG_INTERVAL == 0:
                    fps = count_steps / max(time.time() - t_start, 1e-6)
                    deltas = {
                        k: (np.sum(w[-1] - w[0]) if len(w) > 1 else np.sum(w[0]))
                        for k, w in window_episode_stats.items()
                    }
                    reward_mean = deltas.get("reward", 0.0) / max(deltas.get("count", 0.0), 1.0)
                    logger.info(
                        f"update {update}\tfps {fps:.1f}\treward {reward_mean:.3f}\t"
                        + "\t".join(f"{k} {v:.4f}" for k, v in stats.items())
                    )
                    writer.add_scalar("reward", reward_mean, count_steps)
                    for k, v in stats.items():
                        writer.add_scalar(f"losses/{k}", v, count_steps)

                if update % config.RL.CHECKPOINT_INTERVAL == 0:
                    self.save_rl_checkpoint(f"ckpt.{update // config.RL.CHECKPOINT_INTERVAL}.ckpt", update, count_steps)

            if REQUEUE["flag"]:
                self._save_interrupted_state(update, count_steps)
        self.rollout_stats = timing

    def start_device_rollout(self, episodes=None) -> None:
        """The rollout on the card (`rl/device_rollout.DeviceRolloutCollector`)
        for NUM_ENVIRONMENTS slots over the train split (the configured
        dataset's, or `episodes`): its episode bank built, its slots at their
        first episodes, the episode statistics at zero."""
        from vlnce_torch.rl.device_rollout import DeviceRolloutCollector

        N = int(self.config.NUM_ENVIRONMENTS)
        self.collector = DeviceRolloutCollector(self.policy, self.obs_transforms, self.config, N, episodes=episodes)
        self.collector.initial_carry_and_obs()
        self.current_episode_reward = np.zeros((N, 1), np.float32)
        self.running_episode_stats = {"count": np.zeros((N, 1), np.float32), "reward": np.zeros((N, 1), np.float32)}

    def train_update_on_device(self, update_idx: int, rng: np.random.RandomState):
        """One update of the on-card path: a rollout of T steps
        (`collect_device`; its episode statistics added into
        `current_episode_reward` and `running_episode_stats`), then the PPO
        update of the batch it left on the card, `update_device_scan` (which
        joins the ranks). The bootstrap value and GAE ran in the rollout's
        second graph. Returns (the six PPO stats, {"env_steps", "rollout_s",
        "update_s"})."""
        if self.collector is None:
            self.start_device_rollout()
        t0 = time.time()
        batch, n_steps = self.collector.collect_device(self.current_episode_reward, self.running_episode_stats,
                                                       self.generator)
        t1 = time.time()
        stats = self.agent.update_device_scan(batch, rng, update_idx=update_idx, clock=self.step_clock)
        return stats, {"env_steps": n_steps, "rollout_s": t1 - t0, "update_s": time.time() - t1}

    def _update_from_storage(self, rollouts, rng_np, update: int) -> Dict[str, float]:
        """The bootstrap value of the last observations, the returns on the
        host, and `WDDPPO.update` over the rollout storage."""
        ppo_cfg = self.config.RL.PPO
        last_obs = {k: torch.cat([b[k] for b in self._dev_batches]) for k in self._dev_batches[0]}
        rest = to_device({
            "hidden": rollouts.recurrent_hidden_states[rollouts.step],
            "masks": rollouts.masks[rollouts.step],
            **{k: v[rollouts.step] for k, v in rollouts.prev_actions.items()},
        }, self.policy.device)
        next_value = self.policy.get_value(last_obs, rest["hidden"], {k: rest[k] for k in _ACTION_KEYS}, rest["masks"])
        rollouts.compute_returns(next_value.cpu().numpy(), ppo_cfg.use_gae, ppo_cfg.gamma, ppo_cfg.tau)
        stats = self.agent.update(rollouts, rng_np, update_idx=update, clock=self.step_clock)
        rollouts.after_update()
        return stats

    def _rl_state(self, update: int, count_steps: int) -> Dict:
        return dict(config=self.config, optim_state=self.optimizer.state_dict(),
                    extra_state={"update": update, "count_steps": count_steps})

    def save_rl_checkpoint(self, name: str, update: int, count_steps: int) -> None:
        save_checkpoint(
            os.path.join(self.config.CHECKPOINT_FOLDER, name), self.policy.state_dict(),
            async_write=bool(self.config.CUDA.ASYNC_CHECKPOINT), **self._rl_state(update, count_steps),
        )

    def _save_interrupted_state(self, update: int, count_steps: int) -> None:
        # synchronous: the process exits for requeue right after this write;
        # every rank writes it (the path is typically node-local)
        save_checkpoint(self.config.RL.DDPPO.requeue_path, self.policy.state_dict(), all_ranks=True,
                        **self._rl_state(update, count_steps))
        logger.info("Saved interrupted state for requeue")

    # --------------------------------------------------------- rollout step
    def _collect_rollout_step(self, rollouts, current_episode_reward, running_episode_stats, timing) -> None:
        N = self.envs.num_envs
        step = rollouts.step
        device = self.policy.device
        rgb_np = rollouts.observations["rgb"][step]
        depth_np = rollouts.observations["depth"][step]

        # phase 1, per group: the act step on the carried device batch, then
        # dispatch the env steps without waiting: while group A's simulators
        # run, the card runs group B's act step
        outs: List[Dict] = []
        hist_groups: List[Dict[str, np.ndarray]] = []
        for gi, (lo, hi) in enumerate(self._group_bounds):
            t0 = time.time()
            rest = to_device({
                "hidden": rollouts.recurrent_hidden_states[step][lo:hi], "masks": rollouts.masks[step][lo:hi],
                **{k: v[step][lo:hi] for k, v in rollouts.prev_actions.items()},
            }, device)
            out = self.policy.act(
                self._dev_batches[gi], rest["hidden"], {k: rest[k] for k in _ACTION_KEYS}, rest["masks"],
                deterministic=False, generator=self.generator,
            )
            actions = WaypointPolicy.actions_to_env(out)  # the download synchronises with the card
            hist_groups.append(self._history_frames(out, rgb_np[lo:hi], depth_np[lo:hi]))
            timing["act_time"] += time.time() - t0
            if timing["act_steps"] == 0:
                timing["first_act_time"] = timing["act_time"]  # holds the libraries' warm-up and the kernels' build
            timing["act_steps"] += 1
            self.envs.step_at_async(list(range(lo, hi)), actions)
            outs.append(out)

        # phase 2, per group: receive the env results and prepare the next
        # device batch (its upload overlaps the other group's simulators)
        observations: List = [None] * N
        rewards: List = [0.0] * N
        dones: List = [False] * N
        infos: List = [{}] * N
        host_parts: List[Dict[str, np.ndarray]] = []
        for gi, (lo, hi) in enumerate(self._group_bounds):
            t1 = time.time()
            stepped = self.envs.recv_at(list(range(lo, hi)))
            timing["env_time"] += time.time() - t1
            for i, (obs, reward, done, info) in zip(range(lo, hi), stepped):
                observations[i], rewards[i], dones[i], infos[i] = obs, reward, done, info
            self._dev_batches[gi], host_g = self._prepare_batch(observations[lo:hi], hist_groups[gi])
            host_parts.append(host_g)
        timing["env_steps"] += N

        batch = {k: np.concatenate([p[k] for p in host_parts], axis=0) for k in host_parts[0]}
        out = {
            k: np.concatenate([o[k].detach().cpu().numpy() for o in outs], axis=0)
            for k in ("rnn_states", "action_log_probs", "value")
        }
        action_elements = {
            k: np.concatenate([o["action_elements"][k].cpu().numpy() for o in outs], axis=0) for k in _ACTION_KEYS
        }
        rewards_np = np.asarray(rewards, np.float32).reshape(N, 1)
        masks_np = np.asarray([[0.0] if d else [1.0] for d in dones], np.float32)

        current_episode_reward += rewards_np
        done_mask = 1.0 - masks_np
        running_episode_stats["reward"] += done_mask * current_episode_reward
        running_episode_stats["count"] += done_mask
        for k, v in self._extract_scalars_from_infos(infos).items():
            if k not in running_episode_stats:
                running_episode_stats[k] = np.zeros((N, 1), np.float32)
            running_episode_stats[k] += done_mask * np.asarray(v, np.float32).reshape(N, 1)
        current_episode_reward *= masks_np

        rollouts.insert(batch, out["rnn_states"], action_elements, out["action_log_probs"], out["value"],
                        rewards_np, masks_np)

    # ------------------------------------------------------------------ eval
    def _eval_checkpoint(self, checkpoint_path: str, writer, checkpoint_index: int = 0) -> Optional[Dict[str, float]]:
        """Waypoint eval loop: dict prev_actions + per-step pano history
        (reference:710-986), the env batch kept at a fixed size with an
        active mask."""
        logger.info(f"checkpoint_path: {checkpoint_path}")
        config = self.config.clone()
        split = config.EVAL.SPLIT
        config.defrost()
        config.TASK_CONFIG.DATASET.SPLIT = split
        config.TASK_CONFIG.TASK.NDTW.SPLIT = split
        config.TASK_CONFIG.ENVIRONMENT.ITERATOR_OPTIONS.SHUFFLE = False
        config.TASK_CONFIG.ENVIRONMENT.ITERATOR_OPTIONS.MAX_SCENE_REPEAT_STEPS = -1
        config.freeze()

        fname = None
        if config.EVAL.SAVE_RESULTS:
            os.makedirs(config.RESULTS_DIR, exist_ok=True)
            fname = os.path.join(config.RESULTS_DIR, f"stats_ckpt_{checkpoint_index}_{split}.json")
            if os.path.exists(fname):
                logger.info("skipping -- evaluation exists.")
                return None

        envs = construct_envs_auto_reset_false(config, get_env_class(config.ENV_NAME))
        self.envs = envs
        N = envs.num_envs
        self._set_observation_space(envs.observation_spaces[0])
        self._initialize_policy_rl(load_from_ckpt=os.path.exists(checkpoint_path), ckpt_path=checkpoint_path)
        device = self.policy.device

        observations = envs.reset()
        obs_history = {
            "rgb": np.zeros((N,) + self.observation_space["rgb_history"].shape, self.observation_space["rgb_history"].dtype),
            "depth": np.zeros((N,) + self.observation_space["depth_history"].shape, self.observation_space["depth_history"].dtype),
        }
        dev_batch, batch = self._prepare_batch(observations, obs_history)
        rnn_states = self.policy.initial_rnn_states(N)
        prev_actions = self.policy.initial_prev_actions(N)
        not_done_masks = torch.zeros(N, 1, device=device)
        active = [True] * N

        stats_episodes: Dict[str, Dict] = {}
        video = len(config.VIDEO_OPTION) > 0
        rgb_frames: List[List] = [[] for _ in range(N)]
        if video:
            os.makedirs(config.VIDEO_DIR, exist_ok=True)
        num_eps = sum(envs.number_of_episodes)
        if config.EVAL.EPISODE_COUNT > -1:
            num_eps = min(config.EVAL.EPISODE_COUNT, num_eps)

        timing = {"act_steps": 0, "env_steps": 0, "pth_time": 0.0, "env_time": 0.0}
        t_start = time.time()
        pbar = tqdm(total=num_eps, desc=f"eval wpn ckpt {checkpoint_index}")
        while any(active) and len(stats_episodes) < num_eps:
            current_episodes = envs.current_episodes()
            t0 = time.time()
            out = self.policy.act(
                dev_batch, rnn_states, prev_actions, not_done_masks,
                deterministic=not config.EVAL.SAMPLE, generator=self.generator,
            )
            rnn_states = out["rnn_states"]
            prev_actions = out["action_elements"]
            actions = WaypointPolicy.actions_to_env(out)
            hist = self._history_frames(out, batch["rgb"], batch["depth"])
            obs_history["rgb"][:], obs_history["depth"][:] = hist["rgb"], hist["depth"]
            timing["pth_time"] += time.time() - t0
            timing["act_steps"] += 1

            active_ids = [i for i in range(N) if active[i]]
            t0 = time.time()
            stepped = envs.step_at(active_ids, [actions[i] for i in active_ids])
            timing["env_time"] += time.time() - t0
            timing["env_steps"] += len(active_ids)
            masks_np = np.ones((N, 1), np.float32)
            new_obs = list(observations)
            if video:
                step_np = _video_readback(out)
            for i, (obs, _, done, info) in zip(active_ids, stepped):
                new_obs[i] = obs
                if video:
                    # the full debug frame (reference utils.py:380-543): the
                    # per-pano probability row, the stop gauge, the offset and
                    # distance stats with their modes, the instruction panel
                    frame = waypoint_observations_to_image(
                        {"rgb": batch["rgb"][i], "depth": batch["depth"][i]}, info,
                        pano=int(step_np["pano"][i]) if not step_np["stop"][i] else None,
                        r=float(step_np["r"][i]), theta=float(step_np["theta"][i]),
                        pano_distribution=step_np["probs"][i],
                        offset=float(step_np["offset"][i]), offset_mode=float(step_np["offset_mode"][i]),
                        distance=float(step_np["distance"][i]), distance_mode=float(step_np["distance_mode"][i]),
                        instruction_text=current_episodes[i].instruction.instruction_text,
                    )
                    rgb_frames[i].append(frame)
                if done:
                    ep_id = current_episodes[i].episode_id
                    stats_episodes[ep_id] = {k: v for k, v in info.items() if np.isscalar(v) and not isinstance(v, str)}
                    masks_np[i] = 0.0
                    pbar.update()
                    if video:
                        generate_video(
                            video_option=config.VIDEO_OPTION, video_dir=config.VIDEO_DIR,
                            images=rgb_frames[i], episode_id=ep_id, checkpoint_idx=checkpoint_index,
                            metrics={"spl": stats_episodes[ep_id].get("spl", 0.0)}, tb_writer=writer,
                        )
                        rgb_frames[i] = []
                    new_obs[i] = envs.reset_at(i)[0]
                    obs_history["rgb"][i] = 0
                    obs_history["depth"][i] = 0
                    next_ep = envs.call_at(i, "current_episode")
                    if next_ep.episode_id in stats_episodes:
                        active[i] = False
            observations = new_obs
            dev_batch, batch = self._prepare_batch(observations, obs_history)
            not_done_masks = torch.from_numpy(masks_np).to(device)

        pbar.close()
        envs.close()
        self.envs = None
        self._last_eval_episode_stats = stats_episodes
        self.last_loop_timing = {**timing, "total_time": time.time() - t_start}

        aggregated_stats = {}
        if stats_episodes:
            for k in next(iter(stats_episodes.values())).keys():
                aggregated_stats[k] = float(np.mean([v[k] for v in stats_episodes.values()]))
        if config.EVAL.SAVE_RESULTS and stats_episodes:
            with open(fname, "w") as f:
                json.dump(aggregated_stats, f, indent=4)
        logger.info(f"Episodes evaluated: {len(stats_episodes)}")
        for k, v in aggregated_stats.items():
            logger.info(f"{k}: {v:.6f}")
            writer.add_scalar(f"eval_{split}_{k}", v, checkpoint_index + 1)
        return aggregated_stats
