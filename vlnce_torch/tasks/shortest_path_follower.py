"""Shortest-path followers (the oracle/expert action source).

Two implementations, matching the reference's pair:

- ``ShortestPathFollower``: the modern geodesic follower (habitat-lab
  ShortestPathFollower equivalent) — steer toward the next polyline point,
  turn when off-heading, step forward otherwise.
- ``ShortestPathFollowerCompat``: the v0.1.4-compatible expert used for
  dataset-generation parity (reference habitat_extensions/
  shortest_path_follower.py:25-199), with both its geodesic_path quaternion
  steering and its greedy sim-step-and-rollback heading sweep. Selected by
  TASK.SHORTEST_PATH_SENSOR.USE_ORIGINAL_FOLLOWER.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import numpy as np

from vlnce_torch.envs.sim import Simulator, SimulatorActions
from vlnce_torch.tasks.geometry import heading_from_quaternion

EPSILON = 1e-6


class ShortestPathFollower:
    def __init__(self, sim: Simulator, goal_radius: float, return_one_hot: bool = True):
        self._sim = sim
        self._goal_radius = goal_radius
        self._return_one_hot = return_one_hot
        self._max_delta = 0.25  # path point advance radius

    def _one_hot(self, action: int) -> np.ndarray:
        out = np.zeros(4, dtype=np.float32)
        out[action] = 1.0
        return out

    def get_next_action(self, goal_pos: Sequence[float]) -> Optional[Union[int, np.ndarray]]:
        """None is returned by convention when already within the goal radius
        (callers map it to STOP, reference habitat_extensions/sensors.py:
        149-153)."""
        state = self._sim.get_agent_state()
        agent_pos = state.position
        d_goal = self._sim.geodesic_distance(list(agent_pos), list(goal_pos))
        if d_goal <= self._goal_radius or not np.isfinite(d_goal):
            return None

        points = self._sim.get_straight_shortest_path_points(list(agent_pos), list(goal_pos))
        # first path point sufficiently ahead of the agent
        target = None
        for p in points[1:]:
            if np.linalg.norm(np.array(p)[[0, 2]] - agent_pos[[0, 2]]) > 0.5 * self._max_delta:
                target = np.array(p)
                break
        if target is None:
            target = np.asarray(goal_pos, dtype=np.float64)

        heading = heading_from_quaternion(state.rotation)
        to_target = target[[0, 2]] - agent_pos[[0, 2]]
        desired = math.atan2(-to_target[0], -to_target[1]) % (2 * math.pi)
        delta = (desired - heading + math.pi) % (2 * math.pi) - math.pi

        turn_threshold = math.radians(self._turn_angle_deg()) / 2.0 + EPSILON
        if abs(delta) <= turn_threshold:
            action = SimulatorActions.MOVE_FORWARD
        elif delta > 0:
            action = SimulatorActions.TURN_LEFT
        else:
            action = SimulatorActions.TURN_RIGHT

        if self._return_one_hot:
            return self._one_hot(action)
        return action

    def _turn_angle_deg(self) -> float:
        return float(getattr(getattr(self._sim, "config", None), "TURN_ANGLE", 15))


class ShortestPathFollowerCompat:
    """v0.1.4-compatible expert for dataset-generation parity (reference
    habitat_extensions/shortest_path_follower.py:25-199, selected by
    TASK.SHORTEST_PATH_SENSOR.USE_ORIGINAL_FOLLOWER).

    Two modes, matching the reference semantics:

    - ``geodesic_path``: steer toward the first segment of the straight
      shortest-path polyline via quaternion steering — FORWARD when the
      rotation angle to the gradient direction is within TURN_ANGLE,
      otherwise probe TURN_LEFT by stepping the sim and rolling back
      (reference:86-112).
    - ``greedy``: sweep all 360/TURN_ANGLE headings, stepping the sim
      FORWARD at each and measuring the geodesic-distance decrease, rolling
      back between probes; early-exit when the decrease is within
      (1 - cos(TURN_ANGLE)) of a full step (reference:137-172).
    """

    def __init__(self, sim: Simulator, goal_radius: float, return_one_hot: bool = True):
        assert getattr(sim, "geodesic_distance", None) is not None
        self._sim = sim
        self._goal_radius = goal_radius
        self._return_one_hot = return_one_hot
        sim_cfg = getattr(sim, "config", None)
        self._step_size = float(getattr(sim_cfg, "FORWARD_STEP_SIZE", 0.25))
        self._turn_angle_deg = float(getattr(sim_cfg, "TURN_ANGLE", 15))
        self._max_delta = self._step_size - EPSILON
        self._mode = (
            "geodesic_path"
            if getattr(sim, "get_straight_shortest_path_points", None) is not None
            else "greedy"
        )

    # -- mode ------------------------------------------------------------
    @property
    def mode(self) -> str:
        return self._mode

    @mode.setter
    def mode(self, new_mode: str) -> None:
        assert new_mode in {"geodesic_path", "greedy"}
        if new_mode == "geodesic_path":
            assert getattr(self._sim, "get_straight_shortest_path_points", None) is not None
        self._mode = new_mode

    # -- helpers ----------------------------------------------------------
    def _get_return_value(self, action: int) -> Union[int, np.ndarray]:
        if self._return_one_hot:
            out = np.zeros(4, dtype=np.float32)
            out[action] = 1.0
            return out
        return action

    def _reset_agent_state(self, state) -> None:
        self._sim.set_agent_state(state.position, state.rotation)

    def _geo_dist(self, goal_pos) -> float:
        return self._sim.geodesic_distance(
            list(self._sim.get_agent_state().position), list(goal_pos)
        )

    # -- core -------------------------------------------------------------
    def get_next_action(self, goal_pos: Sequence[float]) -> Optional[Union[int, np.ndarray]]:
        if self._geo_dist(goal_pos) <= self._goal_radius:
            return None
        max_grad_dir = self._est_max_grad_dir(goal_pos)
        if max_grad_dir is None:
            return self._get_return_value(SimulatorActions.MOVE_FORWARD)
        return self._step_along_grad(max_grad_dir)

    def _step_along_grad(self, grad_dir: np.ndarray) -> Union[int, np.ndarray]:
        from vlnce_torch.tasks.geometry import angle_between_quaternions

        current_state = self._sim.get_agent_state()
        alpha = angle_between_quaternions(grad_dir, current_state.rotation)
        if alpha <= math.radians(self._turn_angle_deg) + EPSILON:
            return self._get_return_value(SimulatorActions.MOVE_FORWARD)
        # probe: turn left in the sim, compare angles, roll back
        self._sim.step(SimulatorActions.TURN_LEFT)
        best_turn = (
            SimulatorActions.TURN_LEFT
            if angle_between_quaternions(grad_dir, self._sim.get_agent_state().rotation) < alpha
            else SimulatorActions.TURN_RIGHT
        )
        self._reset_agent_state(current_state)
        return self._get_return_value(best_turn)

    def _est_max_grad_dir(self, goal_pos) -> Optional[np.ndarray]:
        from vlnce_torch.tasks.geometry import FRONT, UP, quat_from_two_vectors

        current_state = self._sim.get_agent_state()
        current_pos = current_state.position

        if self.mode == "geodesic_path":
            points = self._sim.get_straight_shortest_path_points(
                list(current_pos), list(goal_pos)
            )
            if len(points) < 2:
                return None
            # small offset avoids degenerate anti-parallel directions
            direction = (
                np.asarray(points[1], dtype=np.float64)
                - np.asarray(points[0], dtype=np.float64)
                + EPSILON * np.cross(UP, FRONT)
            )
            max_grad_dir = quat_from_two_vectors(FRONT, direction)
            max_grad_dir[0] = 0.0  # project out pitch (x component)
            max_grad_dir = max_grad_dir / np.linalg.norm(max_grad_dir)
            return max_grad_dir

        # greedy: probe every heading by actually stepping the sim
        current_dist = self._geo_dist(goal_pos)
        best_geodesic_delta = -2 * self._max_delta
        best_rotation = current_state.rotation
        for _ in range(0, 360, int(self._turn_angle_deg)):
            self._sim.step(SimulatorActions.MOVE_FORWARD)
            new_delta = current_dist - self._geo_dist(goal_pos)
            if new_delta > best_geodesic_delta:
                best_rotation = self._sim.get_agent_state().rotation
                best_geodesic_delta = new_delta

            # almost certainly the max-gradient direction: a full-step-size
            # decrease within (1 - cos(TURN_ANGLE)) relative tolerance
            if np.isclose(
                best_geodesic_delta,
                self._max_delta,
                rtol=1 - math.cos(math.radians(self._turn_angle_deg)),
            ):
                break

            self._sim.set_agent_state(
                current_pos, self._sim.get_agent_state().rotation
            )
            self._sim.step(SimulatorActions.TURN_LEFT)

        self._reset_agent_state(current_state)
        return np.asarray(best_rotation, dtype=np.float64)
