"""Teacher-recollection dataset: re-simulate GT trajectories every epoch.

Port of the host path of vlnce_tpu/data/recollection.py (reference
vlnce_baselines/common/recollection_dataset.py:22-272): GT action sequences
come from {split}_{role}_gt.json.gz (or a preloaded trajectories file); a
vector env restricted to those episode ids replays the GT actions, buffering
whole episodes into a preload deque; episodes are yielded as (obs,
prev_actions, oracle_actions, weights) for the shared collate. No disk
cache: frames are re-rendered every epoch.

Synthetic fallback: when no GT file exists on disk (procedural GridWorld
runs), GT actions are derived once by rolling out the shortest-path oracle.

The preload deque holds whole episodes of raw observations on the host. An
RxR observation (u8 RGB and f32 depth at 480x640, [512, 768] f32
instruction features) is 3.72 MB, so `preload_size` episodes of up to
`max_traj_len` steps bound the host memory it takes.

With `CUDA.ON_DEVICE_RECOLLECT` there is no env pool (`initialize_device`:
one probe env gives the spaces and closes): chunks of NUM_ENVIRONMENTS
episodes are rendered on the card along their GT actions
(`trainers/device_recollect.render_gt_episodes_on_device`) and read back,
and the episodes go through the same collate. With `CUDA.RECOLLECT_RESIDENT`
as well, `batches` renders each training batch on the card with the obs
transforms inside the render step and keeps it there
(`render_gt_batch_resident`). Under several ranks each rank renders its
strided, wrap-padded `rank_slice` of the episodes on its own card (equal
counts, so every rank runs as many accumulation steps), as in the JAX
package; the resident render runs unsharded on each rank (the JAX
package's resident mesh is None under several processes).
"""

from __future__ import annotations

import gzip
import json
import os
import time
from collections import defaultdict, deque
from typing import Dict, Iterator, List, Tuple

import numpy as np

from vlnce_torch.data.collate import collate_episodes, inflection_weights
from vlnce_torch.envs.env_utils import construct_envs, get_env_class
from vlnce_torch.envs.scene_import import apply_scene_geometry
from vlnce_torch.envs.sim import SimulatorActions
from vlnce_torch.ops.obs_transforms import apply_obs_transforms_obs_space, get_active_obs_transforms
from vlnce_torch.parallel.distributed import rank_slice
from vlnce_torch.utils.logging import logger
from vlnce_torch.utils.progress import tqdm


class TeacherRecollectionDataset:
    def __init__(self, config):
        self.config = config
        self._preload: deque = deque()
        assert config.IL.RECOLLECT_TRAINER.preload_size >= config.IL.batch_size
        self.envs = None
        self._env_observations = None
        self.coef = config.IL.inflection_weight_coef if config.IL.use_iw else 1.0
        # what the re-simulation did: envs stepped, episodes buffered, and the
        # wall time of `_load_next_episodes` (on the trainer's prefetch thread)
        self.sim_stats = {"env_steps": 0, "episodes": 0, "seconds": 0.0}

        if config.IL.RECOLLECT_TRAINER.preload_trajectories_file:
            with gzip.open(config.IL.RECOLLECT_TRAINER.trajectories_file, "rt") as f:
                self.trajectories = json.load(f)
        else:
            self.trajectories = self.collect_dataset()
        self._on_device = bool(config.CUDA.ON_DEVICE_RECOLLECT)
        # resident: each batch is rendered on the card and stays there,
        # time-major, its obs transforms applied (requires ON_DEVICE_RECOLLECT)
        self.resident = self._on_device and bool(config.CUDA.RECOLLECT_RESIDENT)
        self._render_cache: Dict = {}  # the render loops on the card, by shape
        if self._on_device:
            self.initialize_device()
        else:
            self.initialize_sims()

    # -- GT collection -------------------------------------------------------
    def collect_dataset(self) -> Dict[str, List[List[int]]]:
        trajectories = defaultdict(list)
        split = self.config.TASK_CONFIG.DATASET.SPLIT
        gt_file = self.config.IL.RECOLLECT_TRAINER.gt_file
        max_traj_len = self.config.IL.RECOLLECT_TRAINER.max_traj_len

        gt_data: Dict = {}
        if "{role}" in gt_file:
            for role in ("guide", "follower"):
                roles = self.config.TASK_CONFIG.DATASET.ROLES
                if "*" not in roles and role not in roles:
                    continue
                path = gt_file.format(split=split, role=role)
                if os.path.exists(path):
                    with gzip.open(path, "rt") as f:
                        gt_data.update(json.load(f))
        else:
            path = gt_file.format(split=split)
            if os.path.exists(path):
                with gzip.open(path, "rt") as f:
                    gt_data = json.load(f)

        if not gt_data:
            logger.info("No GT file found; deriving GT actions from the shortest-path oracle")
            gt_data = self._derive_gt_with_oracle()

        for episode_id, trajectory in tqdm(gt_data.items(), "GT Collection"):
            actions = trajectory["actions"]
            if max_traj_len != -1 and len(actions) > max_traj_len:
                continue
            for i, action in enumerate(actions):
                prev_action = trajectories[episode_id][i - 1][1] if i else SimulatorActions.STOP
                trajectories[episode_id].append([prev_action, action, action])
        logger.info(f"GT collection: {len(trajectories)} of {len(gt_data)} trajectories kept")

        out_path = self.config.IL.RECOLLECT_TRAINER.trajectories_file
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with gzip.open(out_path, "wt") as f:
            f.write(json.dumps(trajectories))
        return trajectories

    def _derive_gt_with_oracle(self) -> Dict[str, Dict]:
        """Roll the shortest-path follower through every episode once."""
        from vlnce_torch.envs.env import Env
        from vlnce_torch.tasks.shortest_path_follower import ShortestPathFollower

        cfg = self.config.TASK_CONFIG.clone().defrost()
        cfg.TASK.SENSORS = []
        cfg.TASK.MEASUREMENTS = []
        cfg.ENVIRONMENT.ITERATOR_OPTIONS.SHUFFLE = False
        cfg.ENVIRONMENT.ITERATOR_OPTIONS.CYCLE = False
        env = Env(cfg)
        follower = ShortestPathFollower(env.sim, goal_radius=0.5, return_one_hot=False)
        gt = {}
        for _ in range(env.number_of_episodes):
            try:
                env.reset()
            except StopIteration:
                break
            ep = env.current_episode
            actions, locations = [], [list(map(float, env.sim.get_agent_state().position))]
            while not env.episode_over:
                a = follower.get_next_action(ep.goals[0].position)
                a = SimulatorActions.STOP if a is None else int(a)
                actions.append(a)
                env.step(a)
                locations.append(list(map(float, env.sim.get_agent_state().position)))
            gt[ep.episode_id] = {"actions": actions, "locations": locations}
        env.close()
        return gt

    # -- live simulation -----------------------------------------------------
    def initialize_sims(self) -> None:
        config = self.config.clone().defrost()
        config.TASK_CONFIG.TASK.MEASUREMENTS = []
        config.freeze()
        self.envs = construct_envs(
            config, get_env_class(config.ENV_NAME),
            episodes_allowed=list(self.trajectories.keys()),
        )
        self.length = sum(self.envs.number_of_episodes)
        self.obs_transforms = get_active_obs_transforms(self.config)
        self._observation_space = apply_obs_transforms_obs_space(
            self.envs.observation_spaces[0], self.obs_transforms
        )
        self.env_step = [0 for _ in range(self.envs.num_envs)]
        self._env_observations = [[] for _ in range(self.envs.num_envs)]
        observations = self.envs.reset()
        for i, ep in enumerate(self.envs.current_episodes()):
            path_step = self.trajectories[ep.episode_id][0]
            self._env_observations[i].append((observations[i], path_step[0], path_step[2]))

    def initialize_device(self) -> None:
        """Recollection rendered on the card (CUDA.ON_DEVICE_RECOLLECT): no
        env pool. A probe env gives the spaces, then closes."""
        from vlnce_torch.tasks.datasets import make_dataset

        config = self.config.clone().defrost()
        config.TASK_CONFIG.TASK.MEASUREMENTS = []
        config.freeze()
        sim_type = config.TASK_CONFIG.SIMULATOR.TYPE
        if sim_type != "GridWorldSim-v0":
            raise ValueError(f"CUDA.ON_DEVICE_RECOLLECT requires SIMULATOR.TYPE=GridWorldSim-v0 (got {sim_type!r})")
        apply_scene_geometry(config.TASK_CONFIG.SIMULATOR)  # real-scene grids, if configured
        probe = get_env_class(config.ENV_NAME)(config.clone())
        try:
            self.obs_transforms = get_active_obs_transforms(self.config)
            self._observation_space = apply_obs_transforms_obs_space(probe.observation_space, self.obs_transforms)
            self._action_space = probe.action_space
        finally:
            probe.close()
        wanted = set(self.trajectories.keys())
        dataset = make_dataset(config.TASK_CONFIG.DATASET.TYPE, config.TASK_CONFIG.DATASET)
        # each rank re-renders its strided, wrap-padded shard (unequal shards
        # would give ranks different batch counts and deadlock the step's
        # all_reduce)
        self._device_episodes = rank_slice([ep for ep in dataset.episodes if ep.episode_id in wanted])
        self.length = len(self._device_episodes)
        self._instr_uuid = str(getattr(self.config.MODEL.INSTRUCTION_ENCODER, "sensor_uuid", "instruction"))

    def _device_episode_iter(self) -> Iterator[Tuple]:
        from vlnce_torch.trainers.device_recollect import render_gt_episodes_on_device

        B = max(1, int(self.config.NUM_ENVIRONMENTS))
        order = list(self._device_episodes)
        while True:
            for lo in range(0, len(order), B):
                chunk = order[lo : lo + B]
                t0 = time.perf_counter()
                episodes = render_gt_episodes_on_device(self.config, chunk, self.trajectories, self.coef,
                                                        instr_uuid=self._instr_uuid, cache=self._render_cache)
                self._count(chunk, t0)
                yield from episodes

    def _count(self, chunk, t0: float) -> None:
        """The render's counts: GT steps, episodes, host seconds, and per
        render graph its replays and the kernel launches its capture holds."""
        self.sim_stats["env_steps"] += sum(len(self.trajectories[ep.episode_id]) for ep in chunk)
        self.sim_stats["episodes"] += len(chunk)
        self.sim_stats["seconds"] += time.perf_counter() - t0
        graphs = [steps.step for steps in self._render_cache.values()]
        self.sim_stats["replays"] = sum(g.replays for g in graphs)
        self.sim_stats["capture_launches"] = [dict(g.capture_launches) for g in graphs]

    @property
    def batch_size(self) -> int:
        return self.config.IL.batch_size

    @property
    def observation_space(self):
        return self._observation_space

    @property
    def action_space(self):
        if self.envs is None:
            return self._action_space
        return self.envs.action_spaces[0]

    def close_sims(self) -> None:
        if self.envs is not None:
            self.envs.close()
        self.envs = None
        self._env_observations = None

    def _load_next_episodes(self) -> None:
        """Step the envs with GT actions until preload_size episodes buffer
        (reference recollection_dataset.py:167-228)."""
        t0 = time.perf_counter()
        preload_size = self.config.IL.RECOLLECT_TRAINER.preload_size
        episodes = []
        while len(episodes) < preload_size:
            current_episodes = self.envs.current_episodes()
            # next GT action per env
            actions = []
            for i, ep in enumerate(current_episodes):
                traj = self.trajectories[ep.episode_id]
                actions.append(traj[self.env_step[i]][1])

            outputs = self.envs.step(actions)
            self.sim_stats["env_steps"] += len(actions)
            for i, (obs, _, done, _) in enumerate(outputs):
                self.env_step[i] += 1
                if done:
                    ep_obs = self._env_observations[i]
                    traj = self.trajectories[current_episodes[i].episode_id]
                    assert len(ep_obs) == len(traj), (
                        f"episode length mismatch: {len(ep_obs)} obs vs {len(traj)} GT steps"
                    )
                    episodes.append(ep_obs)
                    self._env_observations[i] = []
                    self.env_step[i] = 0
                    # envs auto-reset; record the first step of the new episode
                    new_ep = self.envs.call_at(i, "current_episode")
                    path_step = self.trajectories[new_ep.episode_id][0]
                    self._env_observations[i].append((obs, path_step[0], path_step[2]))
                else:
                    traj = self.trajectories[current_episodes[i].episode_id]
                    step = min(self.env_step[i], len(traj) - 1)
                    self._env_observations[i].append((obs, traj[step][0], traj[step][2]))
                    assert len(self._env_observations[i]) <= self.config.TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS
        self._preload.extend(episodes)
        self.sim_stats["episodes"] += len(episodes)
        self.sim_stats["seconds"] += time.perf_counter() - t0

    def episodes(self) -> Iterator[Tuple]:
        """Infinite iterator of (obs_dict[T], prev[T], oracle[T], weights[T])."""
        if self._on_device:
            yield from self._device_episode_iter()
            return
        while True:
            if not self._preload:
                self._load_next_episodes()
            ep = self._preload.popleft()
            obs = {k: np.stack([np.asarray(step[0][k]) for step in ep]) for k in ep[0][0]}
            prev = np.asarray([step[1] for step in ep], np.int64)
            oracle = np.asarray([step[2] for step in ep], np.int64)
            yield (obs, prev, oracle, inflection_weights(oracle, self.coef))

    def batches(self, num_batches: int) -> Iterator:
        """num_batches collated batches: (observations [T*N, ...], prev
        [T*N, 1], masks [T*N, 1], corrected [T, N], weights [T, N]). With
        CUDA.RECOLLECT_RESIDENT each batch is rendered on the card and stays
        there: (observations {k: [T, N, ...]} transformed, prev, masks,
        corrected, weights [T, N]), the episodes in the dataset's order,
        wrapping, as the episode iterators take them."""
        if self.resident:
            from vlnce_torch.trainers.device_recollect import render_gt_batch_resident

            def cycle():
                while True:
                    yield from self._device_episodes

            episodes = cycle()
            for _ in range(num_batches):
                group = [next(episodes) for _ in range(self.batch_size)]
                t0 = time.perf_counter()
                batch = render_gt_batch_resident(self.config, group, self.trajectories, self.coef,
                                                 instr_uuid=self._instr_uuid, transforms=self.obs_transforms,
                                                 cache=self._render_cache)
                self._count(group, t0)
                yield batch
            return
        it = self.episodes()
        for _ in range(num_batches):
            batch = [next(it) for _ in range(self.batch_size)]
            yield collate_episodes(batch)
