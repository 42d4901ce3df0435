"""Replay simulator: serves prerecorded observation/pose sequences.

Port of vlnce_tpu/envs/replay_sim.py.

The obs contract is easily mockable (SURVEY.md §4, modeled on the reference's
feature-caching and preload_trajectories paths). Used for deterministic
trainer/eval tests without any world model: positions advance along a stored
trajectory regardless of the action taken; navigation queries answer from the
stored path.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from vlnce_torch.registry import registry
from vlnce_torch.envs.sim import AgentState, Observations, Simulator
from vlnce_torch.tasks.geometry import quat_from_heading


@registry.register_simulator(name="ReplaySim-v0")
class ReplaySim(Simulator):
    """trajectories: scene_id -> {"positions": [T,3], "headings": [T],
    "observations": list of obs dicts (optional)}."""

    trajectories: Dict[str, dict] = {}

    def __init__(self, config):
        self.config = config
        self._traj: Optional[dict] = None
        self._t = 0
        self.previous_step_collided = False

    @classmethod
    def register_trajectory(cls, scene_id: str, positions, headings, observations=None) -> None:
        cls.trajectories[scene_id] = {
            "positions": np.asarray(positions, dtype=np.float64),
            "headings": np.asarray(headings, dtype=np.float64),
            "observations": observations,
        }

    def reconfigure(self, scene_id: str) -> None:
        self._traj = self.trajectories.get(scene_id)
        if self._traj is None:
            # default: a straight 10-step line
            T = 11
            pos = np.stack([np.zeros(T), np.zeros(T), -0.25 * np.arange(T)], axis=1)
            self._traj = {"positions": pos, "headings": np.zeros(T), "observations": None}
        self._t = 0

    def reset(self) -> Observations:
        self._t = 0
        return self.get_observations_at()

    def step(self, action: int) -> Observations:
        self._t = min(self._t + 1, len(self._traj["positions"]) - 1)
        return self.get_observations_at()

    def get_agent_state(self) -> AgentState:
        pos = self._traj["positions"][self._t]
        return AgentState(pos, quat_from_heading(float(self._traj["headings"][self._t])))

    def set_agent_state(self, position, rotation) -> None:
        # replay ignores external pose writes; time index is the state
        pass

    def get_observations_at(self, position=None, rotation=None, keep_agent_at_new_pose=False) -> Observations:
        obs_list = self._traj.get("observations")
        if obs_list is not None:
            return dict(obs_list[min(self._t, len(obs_list) - 1)])
        return {}

    def geodesic_distance(self, a, b) -> float:
        a = np.asarray(a, dtype=np.float64)
        b = np.asarray(b, dtype=np.float64)
        goals = b[None, :] if b.ndim == 1 else b
        return float(min(np.linalg.norm(g[[0, 2]] - a[[0, 2]]) for g in goals))

    def is_navigable(self, position) -> bool:
        return True

    def snap_point(self, position) -> np.ndarray:
        return np.asarray(position, dtype=np.float64)

    def step_filter(self, start, end) -> np.ndarray:
        return np.asarray(end, dtype=np.float64)

    def get_straight_shortest_path_points(self, a, b) -> List[List[float]]:
        return [list(map(float, a)), list(map(float, b))]

    def sample_navigable_point(self) -> List[float]:
        return [0.0, 0.0, 0.0]
