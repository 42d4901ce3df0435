"""RLEnv adapters over the base Env.

Parity with reference vlnce_baselines/common/environments.py:15-198: the
DAgger env (zero reward, full metric info), the inference env (pose info),
the waypoint RL env (reward from the waypoint reward measure, done on
success), and the discretized-navigator waypoint env (plans each waypoint
into TURN/FORWARD sequences through the discrete simulator). The
discretized env's in-env video (`VIDEO_OPTION`) is not ported yet and
raises.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

from vlnce_torch.registry import registry
from vlnce_torch.envs.env import Env
from vlnce_torch.tasks.discrete_planner import DiscretePathPlanner
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


@registry.register_env(name="VLNCEWaypointEnv")
class VLNCEWaypointEnv(RLEnv):
    """reference environments.py:62-91: shaped reward, done on stop/success."""

    def __init__(self, config, dataset=None):
        self._reward_measure = config.RL.REWARD_MEASURE
        self._success_measure = config.RL.SUCCESS_MEASURE
        super().__init__(config, dataset=dataset)

    def get_reward(self, observations) -> float:
        return float(self._env.get_metrics()[self._reward_measure])

    def _episode_success(self) -> bool:
        return bool(self._env.get_metrics()[self._success_measure])

    def get_done(self, observations) -> bool:
        return self._env.episode_over or self._episode_success()

    def get_info(self, observations) -> Dict:
        return self._env.get_metrics()


@registry.register_env(name="VLNCEWaypointEnvDiscretized")
class VLNCEWaypointEnvDiscretized(VLNCEWaypointEnv):
    """Zero-shot eval of waypoint policies through discrete actions
    (reference environments.py:94-198): each GO_TOWARD_POINT is planned as an
    obstacle-free TURN/FORWARD sequence and executed step by step. The JAX
    env's in-env navigator video (`VIDEO_OPTION`) is not ported yet: the env
    raises when it is set."""

    def __init__(self, config, dataset=None):
        if len(getattr(config, "VIDEO_OPTION", []) or []) > 0:
            raise NotImplementedError(
                "VIDEO_OPTION of VLNCEWaypointEnvDiscretized (utils/video.py) is not ported to vlnce_torch yet "
                "(ROADMAP.md section A, 'Left by the serving slice')"
            )
        super().__init__(config, dataset=dataset)
        sim_cfg = config.TASK_CONFIG.SIMULATOR
        step_size = float(sim_cfg.FORWARD_STEP_SIZE)
        self._planner = DiscretePathPlanner(
            forward_distance=step_size,
            turn_angle=math.radians(float(sim_cfg.TURN_ANGLE)),
            # 0.13 m for the 0.25 m step (reference environments.py:107)
            goal_radius=round(step_size / 2, 2) + 0.01,
        )

    def get_reward(self, observations) -> float:
        # reference environments.py:111: the discretized navigator is an
        # eval-only env; no reward measure is required in the task config
        return 0.0

    def step(self, action) -> Tuple[Dict, float, bool, Dict]:
        if isinstance(action, dict) and isinstance(action.get("action"), dict):
            action = action["action"]  # unwrap habitat-style nested spec
        if isinstance(action, dict) and action.get("action") == "GO_TOWARD_POINT":
            r = float(action["action_args"]["r"])
            theta = float(action["action_args"]["theta"])
            # planner theta convention: 0 = forward, increasing counterclockwise
            plan = self._planner.plan(r, theta)
            observations = None
            for discrete_action in plan:
                observations = self._env.step({"action": int(discrete_action)})
                if self._env.episode_over:
                    break
            if observations is None:
                # Empty plan: the waypoint is already within the goal radius.
                # Re-fetch observations at the current pose and continue the
                # episode (reference environments.py:146-151): stepping STOP
                # here would wrongly end the episode.
                state = self._env.sim.get_agent_state()
                observations = self._env.sim.get_observations_at(state.position, state.rotation)
        else:
            observations = self._env.step(action)
        return observations, self.get_reward(observations), self.get_done(observations), self.get_info(observations)
