"""Simulator interface (L0 boundary).

The reference delegates simulation to Habitat-Sim (C++/OpenGL). Here the
boundary is an explicit protocol: everything the task layer touches
(reference habitat_extensions/actions.py:37-55, sensors.py:75-78,
measures.py:52-57) is a method on `Simulator`. Implementations:

- GridWorldSim (vlnce_torch/envs/gridworld.py): procedural host-side world for
  tests/benchmarks/dry-runs.
- ReplaySim (vlnce_torch/envs/replay_sim.py): prerecorded pose/observation
  sequences.
- HabitatSimAdapter (vlnce_torch/envs/habitat_adapter.py): real MP3D scenes,
  registered only when habitat_sim is installed.

Simulation stays CPU-side; all neural compute happens on the card downstream.
"""

from __future__ import annotations

import abc
from typing import Dict, List, Optional, Sequence, Union

import numpy as np


class AgentState:
    __slots__ = ("position", "rotation")

    def __init__(self, position: np.ndarray, rotation: np.ndarray):
        self.position = np.asarray(position, dtype=np.float64)  # [x, y, z]
        self.rotation = np.asarray(rotation, dtype=np.float64)  # quat [x,y,z,w]


class SimulatorActions:
    """Discrete action ids (habitat HabitatSimActions equivalent)."""

    STOP = 0
    MOVE_FORWARD = 1
    TURN_LEFT = 2
    TURN_RIGHT = 3
    LOOK_UP = 4
    LOOK_DOWN = 5

    NAMES = ["STOP", "MOVE_FORWARD", "TURN_LEFT", "TURN_RIGHT", "LOOK_UP", "LOOK_DOWN"]

    @classmethod
    def by_name(cls, name: str) -> int:
        return cls.NAMES.index(name)


Observations = Dict[str, np.ndarray]


class Simulator(abc.ABC):
    """Minimal simulator protocol required by the VLN-CE task layer."""

    previous_step_collided: bool = False

    @abc.abstractmethod
    def reconfigure(self, scene_id: str) -> None: ...

    @abc.abstractmethod
    def reset(self) -> Observations: ...

    @abc.abstractmethod
    def step(self, action: int) -> Observations: ...

    @abc.abstractmethod
    def get_agent_state(self) -> AgentState: ...

    @abc.abstractmethod
    def set_agent_state(self, position: Sequence[float], rotation: Sequence[float]) -> None: ...

    @abc.abstractmethod
    def get_observations_at(
        self,
        position: Optional[Sequence[float]] = None,
        rotation: Optional[Sequence[float]] = None,
        keep_agent_at_new_pose: bool = False,
    ) -> Observations: ...

    @abc.abstractmethod
    def geodesic_distance(
        self, position_a: Sequence[float], position_b: Union[Sequence[float], Sequence[Sequence[float]]]
    ) -> float: ...

    @abc.abstractmethod
    def is_navigable(self, position: Sequence[float]) -> bool: ...

    @abc.abstractmethod
    def snap_point(self, position: Sequence[float]) -> np.ndarray: ...

    @abc.abstractmethod
    def step_filter(self, start: Sequence[float], end: Sequence[float]) -> np.ndarray: ...

    @abc.abstractmethod
    def get_straight_shortest_path_points(
        self, position_a: Sequence[float], position_b: Sequence[float]
    ) -> List[List[float]]: ...

    @abc.abstractmethod
    def sample_navigable_point(self) -> List[float]: ...

    def seed(self, seed: int) -> None:  # pragma: no cover - trivial default
        pass

    def close(self) -> None:  # pragma: no cover - trivial default
        pass

    def render(self, mode: str = "rgb") -> np.ndarray:
        obs = self.get_observations_at()
        return obs.get("rgb")
