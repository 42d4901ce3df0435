"""VLN embodied task: wires sensors, measures, and actions around a simulator.

EmbodiedTask equivalent (the reference uses habitat's, registered "VLN-v0").
Action interface accepts either {"action": name_or_index} or
{"action": name, "action_args": {...}} dicts, matching the reference's action
dict protocol (reference vlnce_baselines/models/waypoint_policy.py:191-208).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import numpy as np
from vlnce_torch.envs import spaces

from vlnce_torch.envs.sim import Observations, Simulator
from vlnce_torch.tasks.actions import build_actions
from vlnce_torch.tasks.measures import Measurements, build_measures
from vlnce_torch.tasks.sensors import Sensor, build_sensors


class VLNTask:
    def __init__(self, task_config, sim: Simulator):
        self._config = task_config
        self._sim = sim
        self.sensor_suite: List[Sensor] = build_sensors(list(task_config.SENSORS), task_config, sim)
        self.measurements: Measurements = build_measures(list(task_config.MEASUREMENTS), task_config, sim)
        self.actions = build_actions(list(task_config.POSSIBLE_ACTIONS), task_config, sim, self)
        self.action_names = list(task_config.POSSIBLE_ACTIONS)
        self.is_stop_called = False

    # -- spaces --------------------------------------------------------------
    @property
    def action_space(self) -> spaces.Discrete:
        return spaces.Discrete(len(self.action_names))

    def sensor_observation_spaces(self) -> Dict[str, spaces.Space]:
        return {s.uuid: s.observation_space for s in self.sensor_suite}

    # -- lifecycle -----------------------------------------------------------
    def reset(self, episode) -> Observations:
        self.is_stop_called = False
        obs = self._sim.reset()
        obs.update(self._collect_sensor_obs(episode))
        self.measurements.reset_measures(episode=episode, task=self)
        return obs

    def step(self, action: Union[int, str, Dict[str, Any]], episode) -> Observations:
        if not isinstance(action, dict):
            action = {"action": action}
        name = action["action"]
        if isinstance(name, dict):
            # habitat-style nested spec: {"action": {"action": name, "action_args": {...}}}
            action = name
            name = action["action"]
        if isinstance(name, (int, np.integer)):
            name = self.action_names[int(name)]
        action_args = action.get("action_args") or {}
        task_action = self.actions[name]
        obs = task_action.step(**action_args)
        obs.update(self._collect_sensor_obs(episode))
        self.measurements.update_measures(episode=episode, task=self, action=action)
        return obs

    def _collect_sensor_obs(self, episode) -> Observations:
        return {s.uuid: s.get_observation(episode=episode) for s in self.sensor_suite}

    def add_sensor(self, sensor_cfg, uuid: Optional[str] = None) -> None:
        """Dynamically attach a sensor (DAgger adds the expert sensor this
        way, reference vlnce_baselines/dagger_trainer.py:486-488)."""
        from vlnce_torch.registry import registry

        cls = registry.get_sensor(sensor_cfg.TYPE)
        sensor = cls(sim=self._sim, config=sensor_cfg)
        if uuid is not None:
            sensor.uuid = uuid
        if all(s.uuid != sensor.uuid for s in self.sensor_suite):
            self.sensor_suite.append(sensor)
