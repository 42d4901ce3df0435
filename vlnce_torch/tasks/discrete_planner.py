"""Obstacle-free discrete path planner for waypoint actions.

Converts a relative polar waypoint (r, theta) into a TURN_LEFT/TURN_RIGHT/
MOVE_FORWARD sequence by greedily minimizing euclidean distance to the goal
in an empty plane, then aligning the final heading away from the start.
Behavioral parity with reference habitat_extensions/discrete_planner.py:
16-111; used by the discretized-navigator eval env.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np

from vlnce_torch.envs.sim import SimulatorActions


class DiscretePathPlanner:
    def __init__(
        self,
        forward_distance: float = 0.25,
        turn_angle: float = math.radians(15.0),
        goal_radius: float = 0.13,
        step_limit: int = 200,
    ) -> None:
        assert np.isclose((2 * math.pi) % turn_angle, 0.0), "turn_angle must divide 2*pi"
        self._forward_distance = forward_distance
        self.turn_angle = turn_angle
        self.num_turns_in_circle = int(round(2 * math.pi / turn_angle))
        self.goal_radius = goal_radius
        self.step_limit = step_limit

    @staticmethod
    def _pol2cart(rho: float, phi: float) -> np.ndarray:
        # habitat frame: heading phi moves along (-cos, -sin) in this planar
        # parameterization (x'=-cos phi, z'=-sin phi)
        return rho * np.array([-math.cos(phi), -math.sin(phi)])

    @staticmethod
    def _heading_to(pos_from: np.ndarray, pos_to: np.ndarray) -> float:
        delta = pos_to - pos_from
        return (math.atan2(delta[-1], delta[0]) + math.pi) % (2 * math.pi)

    def plan(self, r: float, theta: float) -> List[int]:
        goal = self._pol2cart(r, theta)
        position = np.zeros(2)
        heading = 0.0
        plan: List[int] = []

        while round(float(np.linalg.norm(position - goal)), 3) > self.goal_radius:
            # try every heading reachable by k left turns; take the forward
            # step that lands closest to the goal
            best = None
            for k in range(self.num_turns_in_circle):
                angle = (heading + k * self.turn_angle) % (2 * math.pi)
                cand = position + self._pol2cart(self._forward_distance, angle)
                d = float(np.linalg.norm(cand - goal))
                if best is None or d < best[0]:
                    best = (d, cand, angle, k)
            _, position, heading, k = best
            if k > self.num_turns_in_circle // 2:
                plan.extend([SimulatorActions.TURN_RIGHT] * (self.num_turns_in_circle - k))
            else:
                plan.extend([SimulatorActions.TURN_LEFT] * k)
            plan.append(SimulatorActions.MOVE_FORWARD)
            assert len(plan) < self.step_limit, "reached step limit"

        # align final heading away from the start point
        ideal = self._heading_to(np.zeros(2), goal)
        while heading - ideal > self.turn_angle / 2:
            heading -= self.turn_angle
            plan.append(SimulatorActions.TURN_RIGHT)
        while ideal - heading > self.turn_angle / 2:
            heading += self.turn_angle
            plan.append(SimulatorActions.TURN_LEFT)
        return plan
