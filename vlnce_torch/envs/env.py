"""Single-environment wrapper: episode iterator + simulator + task.

habitat.Env equivalent. Handles episode cycling/shuffling per
ENVIRONMENT.ITERATOR_OPTIONS, episode step limits, and exposes
observation/action spaces assembled from the simulator cameras and task
sensors (the reference relies on habitat core Env).
"""

from __future__ import annotations

import random
from typing import Any, Dict, List, Union

import numpy as np
from vlnce_torch.envs import spaces

from vlnce_torch.registry import registry
from vlnce_torch.envs.sim import Observations, Simulator
from vlnce_torch.tasks.datasets import make_dataset
from vlnce_torch.tasks.task import VLNTask


class EpisodeIterator:
    """Episode cycling with habitat's iterator options: CYCLE, SHUFFLE,
    GROUP_BY_SCENE, NUM_EPISODE_SAMPLE, MAX_SCENE_REPEAT_EPISODES and
    MAX_SCENE_REPEAT_STEPS (scene rotation once a scene has been played too
    long, to decorrelate scene exposure during collection)."""

    def __init__(self, episodes: List, options, seed: int = 0):
        self.episodes = list(episodes)
        self.cycle = bool(getattr(options, "CYCLE", True))
        self.shuffle = bool(getattr(options, "SHUFFLE", True))
        self.group_by_scene = bool(getattr(options, "GROUP_BY_SCENE", True))
        self.max_scene_repeat_episodes = int(getattr(options, "MAX_SCENE_REPEAT_EPISODES", -1))
        self.max_scene_repeat_steps = int(getattr(options, "MAX_SCENE_REPEAT_STEPS", -1))
        num_sample = int(getattr(options, "NUM_EPISODE_SAMPLE", -1))
        self._rng = random.Random(seed)
        if 0 < num_sample < len(self.episodes):
            self.episodes = self._rng.sample(self.episodes, num_sample)
        self._order = list(range(len(self.episodes)))
        self._idx = 0
        self._scene_eps = 0
        self._scene_steps = 0
        self._current_scene = None
        self._prepare()

    def _prepare(self) -> None:
        if self.shuffle:
            self._rng.shuffle(self._order)
        if self.group_by_scene:
            self._order.sort(key=lambda i: self.episodes[i].scene_id)

    def step_taken(self) -> None:
        self._scene_steps += 1

    def _should_rotate_scene(self) -> bool:
        if self._current_scene is None:
            return False
        if 0 < self.max_scene_repeat_episodes <= self._scene_eps:
            return True
        if 0 < self.max_scene_repeat_steps <= self._scene_steps:
            return True
        return False

    def _rotate_scene(self) -> None:
        """Move the remaining episodes of the current scene to the back."""
        remaining = self._order[self._idx:]
        same = [i for i in remaining if self.episodes[i].scene_id == self._current_scene]
        other = [i for i in remaining if self.episodes[i].scene_id != self._current_scene]
        if other:
            self._order = self._order[: self._idx] + other + same

    def __iter__(self) -> "EpisodeIterator":
        return self

    def __next__(self):
        if self._idx >= len(self._order):
            if not self.cycle:
                raise StopIteration
            self._idx = 0
            self._prepare()
        if self.group_by_scene and self._should_rotate_scene():
            self._rotate_scene()
            self._scene_eps = 0
            self._scene_steps = 0
        ep = self.episodes[self._order[self._idx]]
        self._idx += 1
        if ep.scene_id != self._current_scene:
            self._current_scene = ep.scene_id
            self._scene_eps = 0
            self._scene_steps = 0
        self._scene_eps += 1
        return ep


class Env:
    def __init__(self, config, dataset=None):
        """config is a task config (the TASK_CONFIG subtree)."""
        self._config = config
        self._dataset = dataset if dataset is not None else make_dataset(config.DATASET.TYPE, config.DATASET)
        sim_cls = registry.get_simulator(config.SIMULATOR.TYPE)
        self._sim: Simulator = sim_cls(config.SIMULATOR)
        self.task = VLNTask(config.TASK, self._sim)
        self._max_episode_steps = int(config.ENVIRONMENT.MAX_EPISODE_STEPS)
        self._episode_iterator = EpisodeIterator(
            self._dataset.episodes, config.ENVIRONMENT.ITERATOR_OPTIONS, seed=config.SEED
        )
        self.current_episode = None
        self._elapsed_steps = 0
        self._episode_over = False

    # -- properties ----------------------------------------------------------
    @property
    def sim(self) -> Simulator:
        return self._sim

    @property
    def episodes(self) -> List:
        return self._dataset.episodes

    @episodes.setter
    def episodes(self, eps: List) -> None:
        self._dataset.episodes = eps
        self._episode_iterator = EpisodeIterator(
            eps, self._config.ENVIRONMENT.ITERATOR_OPTIONS, seed=self._config.SEED
        )

    @property
    def number_of_episodes(self) -> int:
        return len(self._dataset.episodes)

    @property
    def episode_over(self) -> bool:
        return self._episode_over

    @property
    def observation_space(self) -> spaces.Dict:
        space: Dict[str, spaces.Space] = {}
        # camera observations come from the simulator config
        sim_cfg = self._config.SIMULATOR
        for name in sim_cfg.AGENT_0.SENSORS:
            cam = getattr(sim_cfg, name, None)
            if cam is None:
                continue
            if "DEPTH" in name:
                space[cam.UUID] = spaces.Box(0.0, 1.0, shape=(cam.HEIGHT, cam.WIDTH, 1), dtype=np.float32)
            else:
                space[cam.UUID] = spaces.Box(0, 255, shape=(cam.HEIGHT, cam.WIDTH, 3), dtype=np.uint8)
        space.update(self.task.sensor_observation_spaces())
        return spaces.Dict(space)

    @property
    def action_space(self) -> spaces.Discrete:
        return self.task.action_space

    # -- lifecycle -----------------------------------------------------------
    def seed(self, seed: int) -> None:
        self._sim.seed(seed)
        self._episode_iterator._rng.seed(seed)

    def reset(self) -> Observations:
        self.current_episode = next(self._episode_iterator)
        self._sim.reconfigure(self.current_episode.scene_id)
        self._sim.reset()
        self._sim.set_agent_state(self.current_episode.start_position, self.current_episode.start_rotation)
        self._elapsed_steps = 0
        self._episode_over = False
        return self.task.reset(self.current_episode)

    def step(self, action: Union[int, str, Dict[str, Any]]) -> Observations:
        assert not self._episode_over, "episode over; call reset()"
        obs = self.task.step(action, self.current_episode)
        self._elapsed_steps += 1
        self._episode_iterator.step_taken()
        if self.task.is_stop_called or self._elapsed_steps >= self._max_episode_steps:
            self._episode_over = True
        return obs

    def get_metrics(self) -> Dict[str, Any]:
        return self.task.measurements.get_metrics()

    def close(self) -> None:
        self._sim.close()


# simulator registration (import side effect, after Env is defined so the
# lazy package __init__ can't recurse)
from vlnce_torch.envs import gridworld as _gridworld  # noqa: E402,F401
from vlnce_torch.envs import replay_sim as _replay_sim  # noqa: E402,F401
from vlnce_torch.envs import habitat_adapter as _habitat_adapter  # noqa: E402,F401  (registers only if habitat_sim imports)
