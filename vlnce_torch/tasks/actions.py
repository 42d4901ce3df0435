"""Task actions, including the continuous waypoint action.

Discrete actions map directly to simulator steps; GoTowardPoint implements
the polar-coordinate teleport-with-collision semantics of
reference habitat_extensions/actions.py:15-74.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
from vlnce_torch.envs import spaces

from vlnce_torch.registry import registry
from vlnce_torch.envs.sim import Observations, Simulator, SimulatorActions
from vlnce_torch.tasks.geometry import (
    compute_heading_to,
    heading_from_quaternion,
    rtheta_to_global_coordinates,
)

# world-coordinate bound used to size the (r, theta) action space, mirroring
# habitat's TeleportAction COORDINATE_MIN/MAX
COORDINATE_MIN = -120.3241
COORDINATE_MAX = 120.0399


class TaskAction:
    name: str = ""

    def __init__(self, *args: Any, config=None, sim: Simulator = None, task=None, **kwargs: Any):
        self._config = config
        self._sim = sim
        self._task = task

    def step(self, *args: Any, **kwargs: Any) -> Observations:
        raise NotImplementedError

    @property
    def action_space(self):
        return spaces.Discrete(1)


@registry.register_task_action(name="StopAction")
class StopAction(TaskAction):
    name = "STOP"

    def step(self, *args: Any, **kwargs: Any) -> Observations:
        self._task.is_stop_called = True
        return self._sim.get_observations_at()


class _DiscreteSimAction(TaskAction):
    sim_action: int = 0

    def step(self, *args: Any, **kwargs: Any) -> Observations:
        return self._sim.step(self.sim_action)


@registry.register_task_action(name="MoveForwardAction")
class MoveForwardAction(_DiscreteSimAction):
    name = "MOVE_FORWARD"
    sim_action = SimulatorActions.MOVE_FORWARD


@registry.register_task_action(name="TurnLeftAction")
class TurnLeftAction(_DiscreteSimAction):
    name = "TURN_LEFT"
    sim_action = SimulatorActions.TURN_LEFT


@registry.register_task_action(name="TurnRightAction")
class TurnRightAction(_DiscreteSimAction):
    name = "TURN_RIGHT"
    sim_action = SimulatorActions.TURN_RIGHT


@registry.register_task_action(name="LookUpAction")
class LookUpAction(_DiscreteSimAction):
    name = "LOOK_UP"
    sim_action = SimulatorActions.LOOK_UP


@registry.register_task_action(name="LookDownAction")
class LookDownAction(_DiscreteSimAction):
    name = "LOOK_DOWN"
    sim_action = SimulatorActions.LOOK_DOWN


@registry.register_task_action(name="TeleportAction")
class TeleportAction(TaskAction):
    name = "TELEPORT"

    def step(self, *args: Any, position=None, rotation=None, **kwargs: Any) -> Observations:
        if position is not None and self._sim.is_navigable(position):
            return self._sim.get_observations_at(
                position=position, rotation=rotation, keep_agent_at_new_pose=True
            )
        return self._sim.get_observations_at()

    @property
    def action_space(self) -> spaces.Dict:
        return spaces.Dict(
            {
                "position": spaces.Box(low=COORDINATE_MIN, high=COORDINATE_MAX, shape=(3,), dtype=np.float32),
                "rotation": spaces.Box(low=-1.0, high=1.0, shape=(4,), dtype=np.float32),
            }
        )


@registry.register_task_action(name="GoTowardPoint")
class GoTowardPoint(TaskAction):
    """(r, theta) -> global target -> collision-filtered straight-line move
    -> navigability check -> snap; optionally rotate the agent toward the
    target. One sim call, matching reference habitat_extensions/actions.py:
    26-56.
    """

    name = "GO_TOWARD_POINT"

    def __init__(self, *args: Any, config=None, sim: Simulator = None, task=None, **kwargs: Any):
        super().__init__(config=config, sim=sim, task=task)
        self._rotate_agent = bool(config.rotate_agent)

    def step(self, *args: Any, r: float, theta: float, **kwargs: Any) -> Observations:
        y_delta = kwargs.get("y_delta", 0.0)
        state = self._sim.get_agent_state()
        heading = heading_from_quaternion(state.rotation)
        pos = np.array(
            rtheta_to_global_coordinates(state.position, heading, r, theta, y_delta=y_delta, dimensionality=3)
        )

        agent_pos = state.position
        new_pos = np.array(self._sim.step_filter(agent_pos, pos))
        new_rot = state.rotation
        if np.any(np.isnan(new_pos)) or not self._sim.is_navigable(new_pos):
            new_pos = agent_pos
            if self._rotate_agent:
                new_rot, _ = compute_heading_to(agent_pos, pos)
        else:
            new_pos = np.array(self._sim.snap_point(new_pos))
            if np.any(np.isnan(new_pos)) or not self._sim.is_navigable(new_pos):
                new_pos = agent_pos
            if self._rotate_agent:
                new_rot, _ = compute_heading_to(agent_pos, pos)

        assert np.all(np.isfinite(new_pos))
        return self._sim.get_observations_at(position=new_pos, rotation=new_rot, keep_agent_at_new_pose=True)

    @property
    def action_space(self) -> spaces.Dict:
        coord_range = COORDINATE_MAX - COORDINATE_MIN
        return spaces.Dict(
            {
                "r": spaces.Box(
                    low=np.array([0.0]), high=np.array([math.sqrt(2 * coord_range**2)]), dtype=np.float64
                ),
                "theta": spaces.Box(low=np.array([0.0]), high=np.array([2 * math.pi]), dtype=np.float64),
            }
        )


def build_actions(action_names, task_config, sim: Simulator, task) -> Dict[str, TaskAction]:
    out = {}
    for name in action_names:
        cfg = getattr(task_config.ACTIONS, name)
        cls = registry.get_task_action(cfg.TYPE)
        out[name] = cls(config=cfg, sim=sim, task=task)
    return out
