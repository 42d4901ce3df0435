"""Base trainer: shared policy init, checkpointing, eval, and inference.

Port of vlnce_tpu/trainers/base_trainer.py (reference
vlnce_baselines/common/base_il_trainer.py:37-630). The eval and inference
loops keep the env batch at a FIXED size with an active mask: finished env
slots stop being stepped on the host but keep their slot on the card, so the
act step sees one shape for the whole loop and can be captured later (the
reference instead shrinks every tensor in _pause_envs,
base_il_trainer.py:182-217).

Per env step the loops make one upload of the stacked observations (from the
pinned buffers of `envs.batch.ObsSlots`), one upload of the [N, 1] masks, and
one download of the actions, which is the loop's only synchronisation with
the card. `prev_actions` and the recurrent state stay on the card.

`_initialize_policy` also resolves the data-parallel axis (`self.mesh`,
`parallel/mesh.resolve_training_mesh`: the ranks of the process group, or
None on one process), builds the optimizer (Adam over the trainable
parameters only; across ranks it broadcasts rank 0's weights) and, for a
requeued job, restores it. `_il_update` passes each rank's batch through
`parallel/il_step.prepare_global_batch`; only rank 0 writes checkpoints. The training loops
are `trainers/dagger_trainer.py` and `trainers/recollect_trainer.py`.
`EVAL.ON_DEVICE_SCAN` and `INFERENCE.ON_DEVICE_SCAN` hand the loop to
`trainers/scan_eval.py` (the grid world and the policy on the card).
`VIDEO_OPTION` adds the TOP_DOWN_MAP_VLNCE measure and writes one video per
episode (`utils/video.py`), composed on the host from each step's
observations.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from vlnce_torch.envs.batch import ObsSlots, to_device
from vlnce_torch.envs.env_utils import construct_envs_auto_reset_false, get_env_class
from vlnce_torch.models.convert import (
    load_ddppo_depth_checkpoint,
    load_policy_state_dict,
    load_pretrained_embeddings,
)
from vlnce_torch.ops.obs_transforms import (
    apply_obs_transforms_batch,
    apply_obs_transforms_obs_space,
    get_active_obs_transforms,
)
from vlnce_torch.parallel.il_step import prepare_global_batch
from vlnce_torch.parallel.mesh import resolve_training_mesh
from vlnce_torch.parallel.optim import load_optim_state, masked_adam
from vlnce_torch.registry import registry
from vlnce_torch.utils.checkpoints import (
    config_from_checkpoint,
    load_checkpoint,
    poll_checkpoint_folder,
    save_checkpoint,
    wait_for_pending,
)
from vlnce_torch.utils.logging import logger
from vlnce_torch.utils.profiling import annotate
from vlnce_torch.utils.progress import tqdm
from vlnce_torch.utils.tensorboard import TensorboardWriter
from vlnce_torch.utils.video import append_text_to_image, generate_video, observations_to_image


def is_slurm_batch_job() -> bool:
    """Progress bars are off under SLURM batch jobs (the JAX package's rule,
    reference base_il_trainer.py:251,310 via habitat's is_slurm_batch_job):
    a job id without an interactive pty."""
    return bool(os.environ.get("SLURM_JOB_ID")) and os.environ.get("SLURM_PTY_PORT") is None


def make_fused_act_step(policy, transforms):
    """Obs transforms followed by `policy.act`, the counterpart of
    BaseVLNCETrainer._make_fused_act_step. The returned function takes the
    batched observations on the policy's device and returns (action [B, 1],
    new rnn_states, logits)."""

    @torch.no_grad()
    def act_step(observations, rnn_states, prev_actions, masks, deterministic: bool = False,
                 generator: Optional[torch.Generator] = None):
        batch = apply_obs_transforms_batch(observations, transforms)
        return policy.act(batch, rnn_states, prev_actions, masks, deterministic, generator)

    return act_step


class _ActLoop:
    """What the eval and inference loops carry from one env step to the next:
    the observation slots on the host, and recurrent state, previous actions
    and not-done masks on the policy's device; plus the loop's clocks."""

    def __init__(self, trainer: "BaseVLNCETrainer", observations, deterministic: bool):
        policy = trainer.policy
        n = len(observations)
        self.device = policy.device
        self.slots = ObsSlots(observations, self.device)
        self.rnn_states = policy.initial_rnn_states(n)
        self.prev_actions = torch.zeros(n, 1, dtype=torch.long, device=self.device)
        self.not_done_masks = torch.zeros(n, 1, device=self.device)
        self.deterministic = deterministic
        self._act_step = make_fused_act_step(policy, trainer.obs_transforms)
        self._generator = trainer.generator
        self.act_steps = 0
        self.env_steps = 0
        self.pth_time = self.env_time = self.first_act_time = 0.0
        self.start_time = time.time()

    def act(self) -> np.ndarray:
        """One act step on the current slots; returns the actions [N] on the
        host. The download is the loop's synchronisation with the card."""
        t0 = time.time()
        actions, self.rnn_states, _ = self._act_step(
            self.slots.to_device(), self.rnn_states, self.prev_actions, self.not_done_masks,
            self.deterministic, self._generator,
        )
        self.prev_actions = actions
        actions_np = actions.reshape(-1).cpu().numpy()
        self.pth_time += time.time() - t0
        if self.act_steps == 0:
            self.first_act_time = self.pth_time  # holds the warm-up of the libraries and the kernels' build
        self.act_steps += 1
        return actions_np

    def step_envs(self, envs, active_ids, actions_np):
        """Step only the active envs, host-side (pipelined across workers)."""
        t0 = time.time()
        stepped = envs.step_at(active_ids, [int(actions_np[i]) for i in active_ids])
        self.env_time += time.time() - t0
        self.env_steps += len(active_ids)
        return stepped

    def set_masks(self, masks_np: np.ndarray) -> None:
        self.not_done_masks = torch.from_numpy(masks_np).to(self.device)

    def timing(self) -> Dict[str, float]:
        return {
            "act_steps": self.act_steps, "env_steps": self.env_steps, "pth_time": self.pth_time,
            "first_act_time": self.first_act_time, "env_time": self.env_time, "total_time": time.time() - self.start_time,
        }


class BaseVLNCETrainer:
    def __init__(self, config):
        self.config = config
        self.policy = None
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.mesh = None  # the data-parallel axis across ranks; set by _initialize_policy
        self.obs_transforms = []
        self.start_epoch = 0
        self.step_id = 0
        # one generator on the policy's device, seeded from TASK_CONFIG.SEED,
        # draws every sampled action; made by _initialize_policy
        self.generator: Optional[torch.Generator] = None
        # clocks and counts of the last eval or inference loop (_ActLoop.timing)
        self.last_loop_timing: Dict[str, float] = {}
        # the IL trainers' train step: its clock (a StepClock when the
        # trainer times its steps, else None) and the padded lengths seen
        self.step_clock = None
        self.train_lengths: Dict[int, int] = {}

    # -- spaces ---------------------------------------------------------------
    def _get_spaces(self, config, envs=None) -> Tuple[Any, Any]:
        if envs is not None:
            observation_space = envs.observation_spaces[0]
            action_space = envs.action_spaces[0]
        else:
            env_class = get_env_class(config.ENV_NAME)
            env = env_class(config.clone())
            observation_space = env.observation_space
            action_space = env.action_space
            env.close()
        observation_space = apply_obs_transforms_obs_space(observation_space, self.obs_transforms)
        return observation_space, action_space

    # -- policy ---------------------------------------------------------------
    def _initialize_policy(self, config, load_from_ckpt: bool, observation_space, action_space) -> None:
        policy_cls = registry.get_policy(config.MODEL.policy_name)
        self.policy = policy_cls.from_config(config, observation_space, action_space)
        self.generator = torch.Generator(device=self.policy.device).manual_seed(int(config.TASK_CONFIG.SEED))

        ie = config.MODEL.INSTRUCTION_ENCODER
        if ie.use_pretrained_embeddings and ie.sensor_uuid == "instruction":
            if load_pretrained_embeddings(self.policy, ie.embedding_file):
                logger.info(f"Loaded pretrained instruction embeddings from {ie.embedding_file}")

        # load DDPPO PointGoal depth weights when the checkpoint is on disk
        ddppo_ckpt = config.MODEL.DEPTH_ENCODER.ddppo_checkpoint
        if ddppo_ckpt not in ("", "NONE") and os.path.exists(ddppo_ckpt):
            load_ddppo_depth_checkpoint(self.policy, load_checkpoint(ddppo_ckpt))
            logger.info(f"Loaded DDPPO depth encoder weights from {ddppo_ckpt}")

        # Adam over the trainable parameters only: the frozen ResNets and the
        # frozen token table get no gradient and hold no moments (the
        # reference's torch-Adam-skips-None-grads, base_il_trainer.py:69-70);
        # across ranks (CUDA.MESH.DATA) rank 0's weights are broadcast first
        self.mesh = resolve_training_mesh(config)
        if self.mesh is not None:
            logger.info(f"Data-parallel training over {self.mesh.size} ranks (this is rank {self.mesh.rank})")
        self.optimizer = masked_adam(config.IL.lr, self.policy, config.MODEL, mesh=self.mesh)

        if load_from_ckpt:
            ckpt_path = config.IL.ckpt_to_load
            ckpt = load_checkpoint(ckpt_path)
            load_policy_state_dict(self.policy, ckpt["state_dict"])
            if config.IL.is_requeue and "optim_state" in ckpt:
                # load_state_dict moves the moments to their parameters' device;
                # a JAX checkpoint's optax moments are carried across by name
                load_optim_state(self.optimizer, self.policy, ckpt["optim_state"])
                extra = ckpt.get("extra_state") or {}
                self.start_epoch = int(extra.get("epoch", -1)) + 1
                self.step_id = int(extra.get("step_id", 0))
            logger.info(f"Loaded weights from checkpoint: {ckpt_path}")
        logger.info(
            f"Initialized policy {config.MODEL.policy_name} on {self.policy.device}: {self.policy.num_params()} params"
        )

    def _il_update(self, step, observations, prev_actions, masks, corrected, weights) -> Tuple[float, float, float]:
        """One IL step on a collated batch (numpy: observations [T*N, ...],
        prev_actions and masks [T*N, 1], corrected and weights [T, N]): one
        pinned, asynchronous upload per array, the obs transforms on the flat
        [T*N, ...] observations, the reshape to time-major [T, N, ...], then
        `step(obs_tn, prev, masks, corrected, weights)`, whose (loss,
        action_loss, aux_loss) come back in the step's one synchronisation
        with the device. Tensors are taken as they are: observations given as
        tensors are the step's time-major inputs on the device already
        (rendered there and transformed, or gathered from the trajectory
        bank), and so is any of the [T, N] rest given as a tensor; only numpy
        arrays are uploaded. `step_clock` (if any) gets the "upload" mark."""
        clock = self.step_clock
        T, N = corrected.shape
        self.train_lengths[T] = self.train_lengths.get(T, 0) + 1
        device = self.policy.device
        if clock:
            clock.start()
        with annotate("train.upload"):
            if all(torch.is_tensor(v) for v in observations.values()):
                obs_tn = observations
            else:
                obs_dev = apply_obs_transforms_batch(to_device(observations, device), self.obs_transforms)
                obs_tn = {k: v.reshape((T, N) + tuple(v.shape[1:])) for k, v in obs_dev.items()}
            rest = {"prev": prev_actions, "masks": masks, "corrected": corrected, "weights": weights}
            rest.update(to_device({k: v for k, v in rest.items() if not torch.is_tensor(v)}, device))
            if clock:
                clock.mark("upload")
            # across ranks: the time axis padded to the longest rank's
            batch = prepare_global_batch(
                self.mesh, obs_tn, rest["prev"].reshape(T, N), rest["masks"].reshape(T, N), rest["corrected"],
                rest["weights"],
            )
        with annotate("train.step"):
            losses = step(*batch)
        loss, action_loss, aux_loss = torch.stack(losses).tolist()
        return loss, action_loss, aux_loss

    def save_checkpoint(self, file_name: str, extra_state: Optional[Dict] = None) -> None:
        path = os.path.join(self.config.CHECKPOINT_FOLDER, file_name)
        save_checkpoint(
            path, self.policy.state_dict(), config=self.config,
            optim_state=self.optimizer.state_dict() if self.optimizer is not None else None,
            extra_state=extra_state,
            # torch.save and the rename overlap the next train steps; the
            # snapshot to host memory is synchronous (the next step changes
            # the parameters in place)
            async_write=bool(self.config.CUDA.ASYNC_CHECKPOINT),
        )

    @staticmethod
    def load_checkpoint(checkpoint_path: str, **kwargs) -> Dict:
        wait_for_pending()  # a checkpoint this process has just saved may still be on its way to the disk
        return load_checkpoint(checkpoint_path)

    # -- entry points ---------------------------------------------------------
    def train(self) -> None:
        raise NotImplementedError

    def eval(self) -> None:
        """Evaluate either a single checkpoint or every checkpoint in
        EVAL_CKPT_PATH_DIR (reference README.md:251 behavior)."""
        os.makedirs(self.config.RESULTS_DIR, exist_ok=True)
        with TensorboardWriter(self.config.TENSORBOARD_DIR) as writer:
            ckpt_dir = self.config.EVAL_CKPT_PATH_DIR
            if not ckpt_dir:
                raise ValueError(
                    "EVAL_CKPT_PATH_DIR is empty: point it at a checkpoint "
                    "file or a directory of checkpoints to evaluate"
                )
            if os.path.isfile(ckpt_dir) or not os.path.isdir(ckpt_dir):
                self._eval_checkpoint(ckpt_dir, writer, checkpoint_index=0)
                return
            prev_index = -1
            while True:
                ckpt_path = poll_checkpoint_folder(ckpt_dir, prev_index)
                if ckpt_path is None:
                    break
                prev_index += 1
                self._eval_checkpoint(ckpt_path, writer, checkpoint_index=prev_index)

    def _setup_eval_config(self, ckpt: Dict):
        config = None
        if self.config.EVAL.USE_CKPT_CONFIG:
            config = config_from_checkpoint(ckpt)
        if config is None:
            return self.config.clone()
        config = config.defrost() if config.is_frozen() else config
        # overlay current eval/runtime settings on the training-time config
        for key in ("EVAL", "RESULTS_DIR", "VIDEO_OPTION", "VIDEO_DIR", "TENSORBOARD_DIR", "NUM_ENVIRONMENTS", "CUDA"):
            if key in self.config:
                config[key] = self.config[key].clone() if hasattr(self.config[key], "clone") else self.config[key]
        return config

    # -- eval -----------------------------------------------------------------
    def _eval_checkpoint(self, checkpoint_path: str, writer, checkpoint_index: int = 0) -> Optional[Dict[str, float]]:
        logger.info(f"checkpoint_path: {checkpoint_path}")
        config = self.config.clone()
        if self.config.EVAL.USE_CKPT_CONFIG and os.path.exists(checkpoint_path):
            try:
                ckpt = load_checkpoint(checkpoint_path)
                config = self._setup_eval_config(ckpt)
            except Exception:
                pass

        split = config.EVAL.SPLIT
        config.defrost()
        config.TASK_CONFIG.DATASET.SPLIT = split
        config.TASK_CONFIG.DATASET.ROLES = ["guide"]
        config.TASK_CONFIG.DATASET.LANGUAGES = config.EVAL.LANGUAGES
        config.TASK_CONFIG.TASK.NDTW.SPLIT = split
        config.TASK_CONFIG.ENVIRONMENT.ITERATOR_OPTIONS.SHUFFLE = False
        config.TASK_CONFIG.ENVIRONMENT.ITERATOR_OPTIONS.MAX_SCENE_REPEAT_STEPS = -1
        config.IL.ckpt_to_load = checkpoint_path
        if len(config.VIDEO_OPTION) > 0 and "TOP_DOWN_MAP_VLNCE" not in config.TASK_CONFIG.TASK.MEASUREMENTS:
            config.TASK_CONFIG.TASK.MEASUREMENTS.append("TOP_DOWN_MAP_VLNCE")
        config.freeze()

        fname = None
        if config.EVAL.SAVE_RESULTS:
            os.makedirs(config.RESULTS_DIR, exist_ok=True)
            fname = os.path.join(config.RESULTS_DIR, f"stats_ckpt_{checkpoint_index}_{split}.json")
            if os.path.exists(fname):
                logger.info("skipping -- evaluation exists.")
                return None

        if config.EVAL.ON_DEVICE_SCAN:
            # videos are rendered during the metrics replay (host cameras,
            # only for this checkpoint's episodes): scan_eval.metrics_from_actions
            from vlnce_torch.trainers.scan_eval import eval_checkpoint_on_device

            return eval_checkpoint_on_device(self, config, checkpoint_path, writer, checkpoint_index, fname)

        # the envs fork before the policy is built, so on a first checkpoint
        # the workers start before CUDA does
        envs = construct_envs_auto_reset_false(config, get_env_class(config.ENV_NAME))
        self.obs_transforms = get_active_obs_transforms(config)
        observation_space, action_space = self._get_spaces(config, envs=envs)

        load = os.path.exists(checkpoint_path)
        self._initialize_policy(
            config, load_from_ckpt=load,
            observation_space=observation_space, action_space=action_space,
        )

        N = envs.num_envs
        loop = _ActLoop(self, envs.reset(), deterministic=not config.EVAL.SAMPLE)
        active = [True] * N

        stats_episodes: Dict[str, Dict] = {}
        video = len(config.VIDEO_OPTION) > 0
        rgb_frames: List[List] = [[] for _ in range(N)]
        if video:
            os.makedirs(config.VIDEO_DIR, exist_ok=True)

        num_eps = sum(envs.number_of_episodes)
        if config.EVAL.EPISODE_COUNT > -1:
            num_eps = min(config.EVAL.EPISODE_COUNT, num_eps)

        pbar = tqdm(total=num_eps, desc=f"eval ckpt {checkpoint_index}", disable=is_slurm_batch_job())
        while any(active) and len(stats_episodes) < num_eps:
            current_episodes = envs.current_episodes()
            actions_np = loop.act()

            active_ids = [i for i in range(N) if active[i]]
            stepped = loop.step_envs(envs, active_ids, actions_np)

            masks_np = np.ones((N, 1), np.float32)
            for i, (obs, _, done, info) in zip(active_ids, stepped):
                if video:
                    frame = observations_to_image(obs, info)
                    frame = append_text_to_image(frame, current_episodes[i].instruction.instruction_text)
                    rgb_frames[i].append(frame)
                if done:
                    ep_id = current_episodes[i].episode_id
                    stats_episodes[ep_id] = {k: v for k, v in info.items() if np.isscalar(v) or isinstance(v, (int, float))}
                    masks_np[i] = 0.0
                    pbar.update()
                    if video:
                        generate_video(
                            video_option=config.VIDEO_OPTION, video_dir=config.VIDEO_DIR,
                            images=rgb_frames[i], episode_id=ep_id, checkpoint_idx=checkpoint_index,
                            metrics={"spl": stats_episodes[ep_id].get("spl", 0.0)}, tb_writer=writer,
                        )
                        rgb_frames[i] = []

                    # advance env i; deactivate if its next episode is already done
                    obs = envs.reset_at(i)[0]
                    next_ep = envs.call_at(i, "current_episode")
                    if next_ep.episode_id in stats_episodes:
                        active[i] = False
                loop.slots.update(i, obs)

            loop.set_masks(masks_np)

        pbar.close()
        envs.close()

        # per-episode stats and loop clocks retained for tests and diagnostics
        self._last_eval_episode_stats = stats_episodes
        self.last_loop_timing = timing = loop.timing()

        aggregated_stats = {}
        if stats_episodes:
            for k in next(iter(stats_episodes.values())).keys():
                aggregated_stats[k] = float(np.mean([v[k] for v in stats_episodes.values()]))

        if config.EVAL.SAVE_RESULTS and stats_episodes:
            with open(fname, "w") as f:
                json.dump(aggregated_stats, f, indent=4)

        logger.info(f"Episodes evaluated: {len(stats_episodes)}")
        logger.info(
            f"pth_time: {timing['pth_time']:.1f}s env_time: {timing['env_time']:.1f}s "
            f"total: {timing['total_time']:.1f}s act_steps: {timing['act_steps']} env_steps: {timing['env_steps']}"
        )
        for k, v in aggregated_stats.items():
            logger.info(f"{k}: {v:.6f}")
            writer.add_scalar(f"eval_{split}_{k}", v, checkpoint_index + 1)
        return aggregated_stats

    # -- inference ------------------------------------------------------------
    def inference(self) -> None:
        """Run a checkpoint on the inference split and write predictions
        (reference base_il_trainer.py:433-630; r2r JSON / rxr JSONL)."""
        config = self.config.clone()
        ckpt_path = config.INFERENCE.CKPT_PATH
        if config.INFERENCE.USE_CKPT_CONFIG and os.path.exists(ckpt_path):
            try:
                ckpt = load_checkpoint(ckpt_path)
                cfg = config_from_checkpoint(ckpt)
                if cfg is not None:
                    inference_cfg = config.INFERENCE.clone()
                    config = cfg.defrost() if cfg.is_frozen() else cfg
                    config.INFERENCE = inference_cfg
            except Exception:
                pass
        config.defrost()
        config.TASK_CONFIG.DATASET.SPLIT = config.INFERENCE.SPLIT
        config.TASK_CONFIG.DATASET.ROLES = ["guide"]
        config.TASK_CONFIG.DATASET.LANGUAGES = config.INFERENCE.LANGUAGES
        config.TASK_CONFIG.ENVIRONMENT.ITERATOR_OPTIONS.SHUFFLE = False
        config.TASK_CONFIG.ENVIRONMENT.ITERATOR_OPTIONS.MAX_SCENE_REPEAT_STEPS = -1
        config.IL.ckpt_to_load = ckpt_path
        config.TASK_CONFIG.TASK.MEASUREMENTS = []
        config.TASK_CONFIG.TASK.SENSORS = [
            s for s in config.TASK_CONFIG.TASK.SENSORS if "INSTRUCTION" in s
        ]
        config.ENV_NAME = "VLNCEInferenceEnv"
        config.freeze()

        if config.INFERENCE.ON_DEVICE_SCAN:
            from vlnce_torch.trainers.scan_eval import inference_on_device

            inference_on_device(self, config)
            return

        envs = construct_envs_auto_reset_false(config, get_env_class(config.ENV_NAME))
        self.obs_transforms = get_active_obs_transforms(config)
        observation_space, action_space = self._get_spaces(config, envs=envs)
        self._initialize_policy(
            config, load_from_ckpt=os.path.exists(ckpt_path),
            observation_space=observation_space, action_space=action_space,
        )

        N = envs.num_envs
        loop = _ActLoop(self, envs.reset(), deterministic=not config.INFERENCE.SAMPLE)
        active = [True] * N

        episode_predictions = defaultdict(list)
        # episode ID --> instruction ID for rxr predictions format
        instruction_ids: Dict[str, str] = {}

        def start_episode(i, episode) -> None:
            """Record env i's starting pose as the first entry of its episode."""
            ep_id = episode.episode_id
            episode_predictions[ep_id].append(envs.call_at(i, "get_info", [None]))
            if config.INFERENCE.FORMAT == "rxr":
                k = getattr(episode.instruction, "instruction_id", None) or ep_id
                instruction_ids[ep_id] = int(k) if str(k).isdigit() else k

        for i, episode in enumerate(envs.current_episodes()):
            start_episode(i, episode)

        with tqdm(total=sum(envs.number_of_episodes), desc="inference", disable=is_slurm_batch_job()) as pbar:
            while any(active):
                current_episodes = envs.current_episodes()
                actions_np = loop.act()

                masks_np = np.ones((N, 1), np.float32)
                active_ids = [j for j in range(N) if active[j]]
                stepped = loop.step_envs(envs, active_ids, actions_np)
                for i, (obs, _, done, info) in zip(active_ids, stepped):
                    episode_predictions[current_episodes[i].episode_id].append(info)
                    if done:
                        masks_np[i] = 0.0
                        pbar.update()
                        obs = envs.reset_at(i)[0]
                        next_ep = envs.call_at(i, "current_episode")
                        if next_ep.episode_id in episode_predictions and len(episode_predictions[next_ep.episode_id]) > 1:
                            active[i] = False
                        else:
                            start_episode(i, next_ep)
                    loop.slots.update(i, obs)
                loop.set_masks(masks_np)

        envs.close()
        self.last_loop_timing = loop.timing()
        self._write_predictions(config, episode_predictions, instruction_ids)

    def _write_predictions(self, config, episode_predictions, instruction_ids) -> None:
        out_path = config.INFERENCE.PREDICTIONS_FILE
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        if config.INFERENCE.FORMAT == "r2r":
            with open(out_path, "w") as f:
                json.dump({k: v for k, v in episode_predictions.items()}, f, indent=2)
        else:  # rxr jsonl guide format
            predictions_out = []
            for ep_id, preds in episode_predictions.items():
                path = [p["position"] for p in preds]
                # RxR format: no consecutive duplicates
                deduped = [path[0]]
                for p in path[1:]:
                    if p != deduped[-1]:
                        deduped.append(p)
                predictions_out.append(
                    {"instruction_id": instruction_ids.get(ep_id, ep_id), "path": deduped}
                )
            with open(out_path, "w") as f:
                for entry in predictions_out:
                    f.write(json.dumps(entry) + "\n")
        logger.info(f"Predictions saved to: {out_path}")
