"""DAgger / teacher-forcing imitation trainer.

Port of vlnce_tpu/trainers/dagger_trainer.py (reference
vlnce_baselines/dagger_trainer.py:234-610):

- Collection: one collect step per env step (obs transforms,
  `act_with_features`, and the beta mix `where(rand < beta, expert, policy)`
  on the policy's device, under `no_grad`) returns the action AND the frozen
  encoders' features, which are stored in place of the frames (the reference
  reads them with forward hooks, :294-314); episodes go into the trajectory
  store with periodic commits. With `CUDA.PIPELINED_COLLECTION` the envs are
  split into two groups: while one group's simulators step, the device runs
  the other group's collect step.
- Training: per batch one upload of the collated arrays from pinned memory,
  then the IL step of `parallel/il_step.py` (sequence forward,
  inflection-weighted CE, aux losses, backward, masked Adam), eagerly.
- The env batch stays fixed-size with an active mask (no tensor shrinking).

With `CUDA.ON_DEVICE_DAGGER` the collection runs on the card instead
(`trainers/device_dagger.py`: the device-resident grid world, the device
expert and the policy, one CUDA graph replay per env step) and its episodes
go into the same store. With `CUDA.DAGGER_RESIDENT` as well they stay on the
card in a trajectory bank (`data/device_bank.py`) that the train step
gathers its batches from, with no store between them (the store only as an
archive, `CUDA.DAGGER_ARCHIVE_STORE`); with `IL.DAGGER.preload_lmdb_features`
the bank is the store uploaded once. `CUDA.RESIDENT_EPOCH_SCAN` then
enqueues each run of an epoch's train steps with one read-back per run.
Bank batches need no prefetch thread: they have no host work to hide.

Across ranks (`self.mesh`, one process per card, `CUDA.MESH.DATA`) each
rank collects its own episodes into a rank-local store (`<dir>.rank<k>`;
on the card, its `rank_slice` of the collection plan), banks its own slice
of a preloaded store, and the IL step sums the ranks' gradients
(`parallel/il_step.py`). The resident collection runs unsharded on each
rank (the JAX trainer's `_resident_mesh` is None under several processes),
and the enqueued epoch falls back to per-batch updates there, as the JAX trainer's
fused epoch does.
"""

from __future__ import annotations

import gc
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from vlnce_torch.data.collate import TrajectoryBatchIterator
from vlnce_torch.data.prefetch import PrefetchIterator
from vlnce_torch.data.trajectory_store import TrajectoryStoreReader, TrajectoryStoreWriter, store_length
from vlnce_torch.envs.batch import ObsSlots
from vlnce_torch.envs.env_utils import construct_envs, get_env_class
from vlnce_torch.ops.obs_transforms import apply_obs_transforms_batch, get_active_obs_transforms
from vlnce_torch.parallel.distributed import rank_slice, world_rank, world_size
from vlnce_torch.parallel.il_step import build_il_train_step
from vlnce_torch.registry import registry
from vlnce_torch.trainers.base_trainer import BaseVLNCETrainer
from vlnce_torch.utils.checkpoints import wait_for_pending
from vlnce_torch.utils.logging import logger
from vlnce_torch.utils.profiling import SectionTimers, StepClock, annotate, maybe_profile
from vlnce_torch.utils.progress import tqdm, trange
from vlnce_torch.utils.tensorboard import TensorboardWriter


def make_collect_step(policy, transforms, expert_uuid: str) -> Callable:
    """Obs transforms, `policy.act_with_features` (a sampled action) and the
    beta mix with the expert's action, as one function on the policy's
    device. Returns fn(observations, rnn_states, prev_actions, masks, beta,
    generator) -> (actions [B, 1], new rnn_states, features, expert [B, 1],
    policy_actions [B, 1], draws [B, 1]): `actions` is the expert's where
    draws < beta and the policy's elsewhere; the last two are what it was
    mixed from."""

    @torch.no_grad()
    def collect_step(observations, rnn_states, prev_actions, masks, beta: float, generator: torch.Generator):
        batch = apply_obs_transforms_batch(observations, transforms)
        policy_actions, states, feats = policy.act_with_features(
            batch, rnn_states, prev_actions, masks, deterministic=False, generator=generator
        )
        expert = observations[expert_uuid].to(torch.long).reshape(-1, 1)
        draws = torch.rand(policy_actions.shape, generator=generator, device=policy_actions.device)
        actions = torch.where(draws < beta, expert, policy_actions)
        return actions, states, feats, expert, policy_actions, draws

    return collect_step


@registry.register_trainer(name="dagger")
class DaggerTrainer(BaseVLNCETrainer):
    # set before `train()` (on the class, or on an instance) to have every
    # train step split by the device's clock into `step_clock` (upload,
    # forward, backward, optimizer: four event records per step); off, a
    # step records nothing
    time_train_steps = False

    def __init__(self, config):
        self.features_dir = config.IL.DAGGER.lmdb_features_dir.format(split=config.TASK_CONFIG.DATASET.SPLIT)
        if world_size() > 1 and not config.IL.DAGGER.preload_lmdb_features:
            # each rank collects its own episodes into its own store: the
            # store has one writer. A preloaded store stays shared, read-only
            # (each rank banks its rank_slice of it).
            self.features_dir = f"{self.features_dir}.rank{world_rank()}"
            logger.info(f"multi-process DAgger: rank-local store {self.features_dir}")
        super().__init__(config)
        self._train_step = None  # built lazily once the policy exists
        self._bank = None  # the DeviceTrajectoryBank (CUDA.DAGGER_RESIDENT), joined across rounds
        # every batch's (dagger_it, epoch, loss, action_loss, aux_loss), and
        # each collection round's counts and clocks
        self.loss_history: List[Tuple[int, int, float, float, float]] = []
        self.collection_stats: List[Dict[str, float]] = []

    # ------------------------------------------------------------------ train
    def _setup_training(self):
        """What `train` does before its first collection round: the store, the
        config the rounds run under, the policy and its optimizer. Returns
        that config."""
        if self.config.IL.DAGGER.preload_lmdb_features:
            if store_length(self.features_dir) == 0:
                raise RuntimeError(f"no preloaded trajectories at {self.features_dir}")
        elif self.config.IL.DAGGER.drop_existing_lmdb_features:
            TrajectoryStoreWriter(self.features_dir, drop_existing=True).close()

        config = self.config.defrost()
        eps = config.IL.DAGGER.expert_policy_sensor
        if eps not in config.TASK_CONFIG.TASK.SENSORS:
            config.TASK_CONFIG.TASK.SENSORS.append(eps)
        if config.IL.DAGGER.p == 1.0:
            # teacher forcing: don't switch scenes mid-collection
            config.TASK_CONFIG.ENVIRONMENT.ITERATOR_OPTIONS.MAX_SCENE_REPEAT_STEPS = -1
        config.freeze()
        self.config = config

        self.obs_transforms = get_active_obs_transforms(config)
        observation_space, action_space = self._get_spaces(config)
        self._initialize_policy(
            config,
            load_from_ckpt=config.IL.load_from_ckpt,
            observation_space=observation_space,
            action_space=action_space,
        )
        os.makedirs(config.CHECKPOINT_FOLDER, exist_ok=True)
        self.step_clock = StepClock(self.policy.device) if self.time_train_steps else None
        return config

    def train(self) -> None:
        config = self._setup_training()
        resident = bool(config.CUDA.DAGGER_RESIDENT)
        fused = resident and self._fused_epoch_ok()
        with TensorboardWriter(config.TENSORBOARD_DIR, purge_step=0) as writer, maybe_profile(config.CUDA.PROFILE_DIR):
            for dagger_it in range(config.IL.DAGGER.iterations):
                step_id = 0
                reader = None
                data_it = dagger_it + (1 if config.IL.load_from_ckpt else 0)
                if resident:
                    diter = self._resident_iterator(data_it, seed=config.TASK_CONFIG.SEED + dagger_it)
                else:
                    if not config.IL.DAGGER.preload_lmdb_features:
                        self._update_dataset(data_it)
                    gc.collect()

                    reader = TrajectoryStoreReader(self.features_dir)
                    diter = TrajectoryBatchIterator(
                        reader,
                        batch_size=config.IL.batch_size,
                        use_iw=config.IL.use_iw,
                        inflection_weight_coef=config.IL.inflection_weight_coef,
                        seed=config.TASK_CONFIG.SEED + dagger_it,
                    )
                    # store read + decode + collate run in a background thread,
                    # overlapping the train step (IL.prefetch_batches)
                    diter = PrefetchIterator(diter, depth=config.IL.prefetch_batches)

                for epoch in trange(config.IL.epochs, dynamic_ncols=True):
                    loss = action_loss = aux_loss = float("nan")
                    if fused:
                        triples = self._run_fused_epoch(diter)
                    else:
                        triples = (self._update_agent(*batch)
                                   for batch in tqdm(diter, total=len(diter), leave=False, dynamic_ncols=True))
                    for loss, action_loss, aux_loss in triples:
                        self.loss_history.append((dagger_it, epoch, loss, action_loss, aux_loss))
                        writer.add_scalar(f"train_loss_iter_{dagger_it}", loss, step_id)
                        writer.add_scalar(f"train_action_loss_iter_{dagger_it}", action_loss, step_id)
                        writer.add_scalar(f"train_aux_loss_iter_{dagger_it}", aux_loss, step_id)
                        step_id += 1
                    logger.info(
                        f"[dagger it {dagger_it} epoch {epoch}] loss={loss:.4f} action={action_loss:.4f} aux={aux_loss:.4f}"
                    )
                    self.save_checkpoint(
                        f"ckpt.{dagger_it * config.IL.epochs + epoch}.ckpt",
                        extra_state={"epoch": epoch, "step_id": step_id, "dagger_it": dagger_it},
                    )
                if reader is not None:
                    reader.close()
        # join any in-flight async checkpoint write: callers may load the
        # last checkpoint the moment train() returns
        wait_for_pending()

    # ------------------------------------------------------------- the update
    def _get_train_step(self):
        if self._train_step is None:
            clock = self.step_clock
            self._train_step = build_il_train_step(self.policy, self.optimizer, mesh=self.mesh,
                                                   **({"mark": clock.mark} if clock else {}))
        return self._train_step

    def _update_agent(self, observations, prev_actions, masks, corrected, weights) -> Tuple[float, float, float]:
        """One IL step on a collated batch, or on a bank batch already on the
        card (see `_il_update`)."""
        return self._il_update(self._get_train_step(), observations, prev_actions, masks, corrected, weights)

    def _fused_epoch_ok(self) -> bool:
        """Whether the enqueued epoch (CUDA.RESIDENT_EPOCH_SCAN) runs: the
        key, on one process. Under several ranks it falls back to per-batch
        updates (whose batches `prepare_global_batch` pads to the ranks'
        longest), as the JAX trainer's fused epoch does."""
        if not bool(self.config.CUDA.RESIDENT_EPOCH_SCAN):
            return False
        if world_size() > 1:
            logger.warning("CUDA.RESIDENT_EPOCH_SCAN: multi-process run — falling back to per-batch resident updates")
            return False
        return True

    def _run_fused_epoch(self, riter) -> List[Tuple[float, float, float]]:
        """One epoch over the bank with each run of batches enqueued and read
        back once (data/device_bank.run_fused_epoch); batch composition and
        order are the per-batch path's. Returns (loss, action_loss,
        aux_loss) per batch."""
        from vlnce_torch.data.device_bank import run_fused_epoch

        return run_fused_epoch(riter, self._get_train_step())

    # ----------------------------------------------------- resident pipeline
    def _resident_iterator(self, data_it: int, seed: int):
        """The batches of a round with CUDA.DAGGER_RESIDENT: collection keeps
        the frozen-encoder features on the card (a DeviceTrajectoryBank) and
        the iterator gathers the train batches there; the store is bypassed,
        or written as an archive. Banks are joined across rounds, as the
        store accumulates. With preload_lmdb_features the bank is the store,
        uploaded once."""
        from vlnce_torch.data.device_bank import DeviceTrajectoryBank, ResidentBatchIterator

        config = self.config
        instr_uuid = str(config.MODEL.INSTRUCTION_ENCODER.sensor_uuid)
        if config.IL.DAGGER.preload_lmdb_features:
            if self._bank is None:
                reader = TrajectoryStoreReader(self.features_dir)
                # each rank banks its slice of the shared store
                self._bank = DeviceTrajectoryBank.from_store(reader, instr_uuid=instr_uuid, device=self.policy.device,
                                                             indices=rank_slice(range(len(reader))))
                reader.close()
                logger.info(f"uploaded trajectory store to device bank: {len(self._bank)} episodes, "
                            f"{self._bank.nbytes() / 2**20:.1f} MiB")
        else:
            if not bool(config.CUDA.ON_DEVICE_DAGGER):
                raise RuntimeError(
                    "CUDA.DAGGER_RESIDENT needs CUDA.ON_DEVICE_DAGGER (device collection) or "
                    "IL.DAGGER.preload_lmdb_features (one-time store upload); the host env-pool collector cannot "
                    "feed the device bank directly"
                )
            from vlnce_torch.trainers.device_dagger import collect_episodes_resident

            t_start = time.perf_counter()
            episodes, beta = self._collection_plan(data_it)
            stats: Dict[str, float] = {}
            pbar = tqdm(total=len(episodes), dynamic_ncols=True)
            new_bank = collect_episodes_resident(self.policy, self.obs_transforms, config, episodes, beta,
                                                 self.generator, progress_cb=pbar.update, stats=stats)
            pbar.close()
            self.collection_stats.append({
                **stats, "data_it": data_it, "beta": beta, "episodes": len(new_bank),
                "bank_bytes": new_bank.nbytes(), "total_time": time.perf_counter() - t_start,
            })
            logger.info(f"[collection it {data_it}] {len(new_bank)} episodes resident, {new_bank.num_steps} steps in "
                        f"{time.perf_counter() - t_start:.1f}s ({stats.get('segments', 0)} segments)")
            if bool(config.CUDA.DAGGER_ARCHIVE_STORE):
                writer = TrajectoryStoreWriter(self.features_dir, drop_existing=False)
                new_bank.write_to_store(writer, fp16=bool(config.IL.DAGGER.lmdb_fp16))
                writer.close()
            self._bank = new_bank if self._bank is None else self._bank.extend(new_bank)
        return ResidentBatchIterator(
            self._bank,
            batch_size=config.IL.batch_size,
            use_iw=config.IL.use_iw,
            inflection_weight_coef=config.IL.inflection_weight_coef,
            seed=seed,
            time_major=True,  # the train step's layout, straight from the gather
        )

    # --------------------------------------------------------- collection
    def _collection_plan(self, data_it: int):
        """The episodes and beta of a round of device collection: beta follows
        p ** iteration (reference dagger_trainer.py:414-418), the episodes
        are the first update_size of the split in dataset order. Under
        several ranks each rank takes its strided, wrap-padded `rank_slice`
        (equal counts, so every rank runs as many train batches)."""
        from vlnce_torch.tasks.datasets import make_dataset

        config = self.config
        p = config.IL.DAGGER.p
        beta = 0.0 if p == 0.0 else p**data_it
        dataset = make_dataset(config.TASK_CONFIG.DATASET.TYPE, config.TASK_CONFIG.DATASET)
        return rank_slice(list(dataset.episodes)[: int(config.IL.DAGGER.update_size)]), beta

    def _update_dataset_on_device(self, data_it: int) -> None:
        """A round of collection on the card (CUDA.ON_DEVICE_DAGGER): one
        graph replay per env step, the done flags read back once per
        segment, the episodes' rows once per chunk, then into the store."""
        from vlnce_torch.trainers.device_dagger import collect_episodes_on_device

        t_start = time.perf_counter()
        episodes, beta = self._collection_plan(data_it)
        stats: Dict[str, float] = {}
        pbar = tqdm(total=len(episodes), dynamic_ncols=True)
        results = collect_episodes_on_device(
            self.policy, self.obs_transforms, self.config, episodes, beta, self.generator, progress_cb=pbar.update,
            stats=stats,
        )
        writer = TrajectoryStoreWriter(self.features_dir, drop_existing=False)
        for payload in results:
            writer.put(list(payload))
        writer.commit()
        writer.close()
        pbar.close()
        self.collection_stats.append({
            **stats, "data_it": data_it, "beta": beta, "episodes": len(results),
            "total_time": time.perf_counter() - t_start,
        })
        logger.info(
            f"[collection it {data_it}] {len(results)} episodes on device, {stats.get('env_steps', 0)} steps in "
            f"{time.perf_counter() - t_start:.1f}s ({stats.get('segments', 0)} segments)"
        )

    def _update_dataset(self, data_it: int) -> None:
        if bool(self.config.CUDA.ON_DEVICE_DAGGER):
            self._update_dataset_on_device(data_it)
            return
        timers = SectionTimers()
        t_start = time.perf_counter()
        config = self.config
        envs = construct_envs(config, get_env_class(config.ENV_NAME))
        expert_uuid = config.IL.DAGGER.expert_policy_sensor_uuid
        device = self.policy.device

        N = envs.num_envs
        observations = envs.reset()
        per_env_obs = observations

        episodes: List[List] = [[] for _ in range(N)]
        skips = [False] * N
        dones = [False] * N
        active = [True] * N

        # two-group pipelined collection: while one group's sims execute, the
        # device runs the other group's collect step. One group = the serial
        # path with identical semantics.
        pipelined = bool(config.CUDA.PIPELINED_COLLECTION) and N >= 2
        bounds = [(0, N // 2), (N // 2, N)] if pipelined else [(0, N)]
        g_slots = [ObsSlots(observations[lo:hi], device) for lo, hi in bounds]
        g_rnn = [self.policy.initial_rnn_states(hi - lo) for lo, hi in bounds]
        g_prev = [torch.zeros(hi - lo, 1, dtype=torch.long, device=device) for lo, hi in bounds]
        g_masks = [torch.zeros(hi - lo, 1, device=device) for lo, hi in bounds]

        p = config.IL.DAGGER.p
        beta = 0.0 if p == 0.0 else p**data_it
        ensure_unique_episodes = beta == 1.0

        cache_rgb = not config.MODEL.RGB_ENCODER.trainable
        cache_depth = not config.MODEL.DEPTH_ENCODER.trainable
        collect_step = make_collect_step(self.policy, self.obs_transforms, expert_uuid)

        writer = TrajectoryStoreWriter(self.features_dir, drop_existing=False)
        collected_eps = 0
        collect_steps = env_steps = 0
        ep_ids_collected = None
        if ensure_unique_episodes:
            ep_ids_collected = {ep.episode_id for ep in envs.current_episodes()}

        pbar = tqdm(total=config.IL.DAGGER.update_size, dynamic_ncols=True)
        store_dtype = torch.float16 if config.IL.DAGGER.lmdb_fp16 else torch.float32

        def flush_episode(i: int) -> None:
            """Write env i's finished episode to the store; deactivate the
            slot when its next episode is a duplicate (ensure_unique)."""
            nonlocal collected_eps
            if dones[i] and not skips[i]:
                ep = episodes[i]
                traj_obs: Dict[str, np.ndarray] = {}
                for k in ep[0][0].keys():
                    if k == expert_uuid:
                        continue
                    arr = np.stack([np.asarray(step[0][k]) for step in ep], axis=0)
                    if config.IL.DAGGER.lmdb_fp16 and arr.dtype == np.float32:
                        arr = arr.astype(np.float16)
                    traj_obs[k] = arr
                writer.put(
                    [
                        traj_obs,
                        np.array([step[1] for step in ep], dtype=np.int64),
                        np.array([step[2] for step in ep], dtype=np.int64),
                    ]
                )
                collected_eps += 1
                pbar.update()
                if collected_eps % config.IL.DAGGER.lmdb_commit_frequency == 0:
                    writer.commit()
                if ensure_unique_episodes:
                    new_ep = envs.call_at(i, "current_episode")
                    if new_ep.episode_id in ep_ids_collected:
                        active[i] = False
                    else:
                        ep_ids_collected.add(new_ep.episode_id)
            if dones[i]:
                episodes[i] = []

        pending: List[Optional[List[int]]] = [None] * len(bounds)
        stop = False
        while not stop:
            for gi, (lo, hi) in enumerate(bounds):
                # receive this group's in-flight env steps (none on cycle 0)
                if pending[gi] is not None:
                    with timers.time("env_time"):
                        stepped = envs.recv_at(pending[gi])
                    for i, (obs, _, done, _) in zip(pending[gi], stepped):
                        per_env_obs[i] = obs
                        dones[i] = done
                        g_slots[gi].update(i - lo, obs)
                    g_masks[gi] = torch.tensor(
                        [[0.0] if dones[i] else [1.0] for i in range(lo, hi)], dtype=torch.float32
                    ).to(device)
                    pending[gi] = None

                for i in range(lo, hi):
                    if active[i]:
                        flush_episode(i)
                if collected_eps >= config.IL.DAGGER.update_size or not any(active):
                    stop = True
                    break
                if not any(active[lo:hi]):
                    continue

                # transforms + act + mix on this group's slice, while the
                # OTHER group's sims are stepping (pipelined overlap)
                with timers.time("pth_time"), annotate("collect_step"):
                    actions, g_rnn[gi], feats, expert_actions, _, _ = collect_step(
                        g_slots[gi].to_device(), g_rnn[gi], g_prev[gi], g_masks[gi], beta, self.generator,
                    )
                    # bf16 device features -> a serializable dtype for the
                    # store; the downloads synchronise with the device
                    rgb_feats = (
                        feats["rgb_features"].to(store_dtype).cpu().numpy()
                        if cache_rgb and "rgb_features" in feats else None
                    )
                    depth_feats = (
                        feats["depth_features"].to(store_dtype).cpu().numpy()
                        if cache_depth and "depth_features" in feats else None
                    )
                    expert_np = expert_actions.reshape(-1).cpu().numpy()
                    prev_np = g_prev[gi].reshape(-1).cpu().numpy()
                    actions_np = actions.reshape(-1).cpu().numpy().copy()
                collect_steps += 1

                for i in range(lo, hi):
                    if not active[i]:
                        continue
                    step_obs = dict(per_env_obs[i])
                    if rgb_feats is not None:
                        step_obs["rgb_features"] = rgb_feats[i - lo]
                        step_obs.pop("rgb", None)
                    if depth_feats is not None:
                        step_obs["depth_features"] = depth_feats[i - lo]
                        step_obs.pop("depth", None)
                    episodes[i].append((step_obs, int(prev_np[i - lo]), int(expert_np[i - lo])))

                # skip episodes where the expert has no path (expert == -1)
                group_skips = [bool(expert_np[i - lo] == -1) for i in range(lo, hi)]
                skips[lo:hi] = group_skips
                actions_np[np.asarray(group_skips)] = 0
                g_prev[gi] = torch.from_numpy(actions_np.reshape(-1, 1)).to(device)

                active_ids = [i for i in range(lo, hi) if active[i]]
                envs.step_at_async(active_ids, [int(actions_np[i - lo]) for i in active_ids])
                pending[gi] = active_ids
                env_steps += len(active_ids)

        # drain in-flight steps so workers aren't mid-message at close
        for ids in pending:
            if ids:
                envs.recv_at(ids)

        writer.close()
        envs.close()
        pbar.close()
        self.collection_stats.append({
            "data_it": data_it, "beta": beta, "episodes": collected_eps, "collect_steps": collect_steps,
            "env_steps": env_steps, "pth_time": timers.totals["pth_time"], "env_time": timers.totals["env_time"],
            "total_time": time.perf_counter() - t_start,
        })
        logger.info(f"[collection it {data_it}] {collected_eps} episodes, {timers.summary()}")
