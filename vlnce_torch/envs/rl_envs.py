"""RLEnv adapters over the base Env.

Parity with reference vlnce_baselines/common/environments.py:15-59: the
DAgger env (zero reward, full metric info) and the inference env (pose info).
The two waypoint envs of the JAX package are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Tuple

from vlnce_torch.registry import registry
from vlnce_torch.envs.env import Env
from vlnce_torch.tasks.geometry import heading_from_quaternion


class RLEnv:
    def __init__(self, config, dataset=None):
        """config is the full experiment config; the task config sits at
        config.TASK_CONFIG."""
        self.config = config
        self._env = Env(config.TASK_CONFIG, dataset=dataset)

    # -- habitat RLEnv surface ----------------------------------------------
    @property
    def habitat_env(self) -> Env:
        return self._env

    @property
    def current_episode(self):
        return self._env.current_episode

    @property
    def number_of_episodes(self) -> int:
        return self._env.number_of_episodes

    @property
    def episode_over(self) -> bool:
        return self._env.episode_over

    @property
    def observation_space(self):
        return self._env.observation_space

    @property
    def action_space(self):
        return self._env.action_space

    def reset(self):
        return self._env.reset()

    def get_metrics(self):
        return self._env.get_metrics()

    def seed(self, seed: int) -> None:
        self._env.seed(seed)

    def close(self) -> None:
        self._env.close()

    def step(self, action) -> Tuple[Dict, float, bool, Dict]:
        observations = self._env.step(action)
        return (
            observations,
            self.get_reward(observations),
            self.get_done(observations),
            self.get_info(observations),
        )

    def get_reward(self, observations) -> float:
        raise NotImplementedError

    def get_done(self, observations) -> bool:
        raise NotImplementedError

    def get_info(self, observations) -> Dict:
        raise NotImplementedError


@registry.register_env(name="VLNCEDaggerEnv")
class VLNCEDaggerEnv(RLEnv):
    """reference environments.py:15-32."""

    def get_reward(self, observations) -> float:
        return 0.0

    def get_done(self, observations) -> bool:
        return self._env.episode_over

    def get_info(self, observations) -> Dict:
        return self._env.get_metrics()


@registry.register_env(name="VLNCEInferenceEnv")
class VLNCEInferenceEnv(RLEnv):
    """reference environments.py:35-59: info carries agent pose + stop."""

    def get_reward(self, observations) -> float:
        return 0.0

    def get_done(self, observations) -> bool:
        return self._env.episode_over

    def get_info(self, observations) -> Dict:
        state = self._env.sim.get_agent_state()
        heading = heading_from_quaternion(state.rotation)
        return {
            "position": [float(x) for x in state.position],
            "heading": heading,
            "stop": self._env.task.is_stop_called,
        }
