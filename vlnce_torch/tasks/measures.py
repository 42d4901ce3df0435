"""Task metrics (Measure system).

Implements the habitat core measures the task configs assume (DistanceToGoal,
Success, SPL) and the VLN-CE extension measures
(reference habitat_extensions/measures.py:35-562), with the same uuids,
dependency declarations, and update semantics. nDTW uses the from-scratch
fastdtw/dtw in vlnce_torch/tasks/dtw.py. Of the JAX package's measures,
WaypointRewardMeasure and TopDownMapVLNCE are not ported yet.
"""

from __future__ import annotations

import gzip
import json
from typing import Any, Dict, List

import numpy as np

from vlnce_torch.registry import registry
from vlnce_torch.envs.sim import Simulator
from vlnce_torch.tasks.dtw import dtw, fastdtw
from vlnce_torch.tasks.geometry import euclidean_distance


class Measure:
    cls_uuid: str = ""

    def __init__(self, *args: Any, **kwargs: Any):
        self.uuid = self._get_uuid()
        self._metric = None

    def _get_uuid(self) -> str:
        return self.cls_uuid

    def reset_metric(self, *args: Any, **kwargs: Any) -> None:
        raise NotImplementedError

    def update_metric(self, *args: Any, **kwargs: Any) -> None:
        raise NotImplementedError

    def get_metric(self):
        return self._metric


class Measurements:
    """Ordered collection with dependency checking
    (habitat task.measurements equivalent)."""

    def __init__(self, measures: List[Measure]):
        self.measures: Dict[str, Measure] = {}
        for m in measures:
            assert m.uuid not in self.measures, f"duplicate measure {m.uuid}"
            self.measures[m.uuid] = m

    def reset_measures(self, *args: Any, **kwargs: Any) -> None:
        for m in self.measures.values():
            m.reset_metric(*args, **kwargs)

    def update_measures(self, *args: Any, **kwargs: Any) -> None:
        for m in self.measures.values():
            m.update_metric(*args, **kwargs)

    def get_metrics(self) -> Dict[str, Any]:
        return {uuid: m.get_metric() for uuid, m in self.measures.items()}

    def check_measure_dependencies(self, uuid: str, dependencies: List[str]) -> None:
        order = list(self.measures)
        for dep in dependencies:
            assert dep in self.measures, f"measure {uuid} requires {dep}"
            assert order.index(dep) < order.index(uuid), (
                f"measure {dep} must appear before {uuid} in TASK.MEASUREMENTS"
            )


@registry.register_measure(name="DistanceToGoal")
class DistanceToGoal(Measure):
    """Geodesic distance to the closest goal (habitat core measure)."""

    cls_uuid = "distance_to_goal"

    def __init__(self, *args: Any, sim: Simulator, config=None, **kwargs: Any):
        self._sim = sim
        super().__init__()

    def reset_metric(self, *args: Any, episode, **kwargs: Any) -> None:
        self._episode = episode
        self.update_metric(episode=episode, **kwargs)

    def update_metric(self, *args: Any, episode=None, **kwargs: Any) -> None:
        episode = episode or self._episode
        pos = list(self._sim.get_agent_state().position)
        goals = [g.position for g in episode.goals]
        self._metric = self._sim.geodesic_distance(pos, goals)


@registry.register_measure(name="Success")
class Success(Measure):
    """I(agent stopped and distance_to_goal < SUCCESS_DISTANCE)."""

    cls_uuid = "success"

    def __init__(self, *args: Any, sim: Simulator = None, config=None, **kwargs: Any):
        self._config = config
        super().__init__()

    def reset_metric(self, *args: Any, task, **kwargs: Any) -> None:
        task.measurements.check_measure_dependencies(self.uuid, [DistanceToGoal.cls_uuid])
        self._metric = 0.0
        self.update_metric(task=task, **kwargs)

    def update_metric(self, *args: Any, task, **kwargs: Any) -> None:
        d = task.measurements.measures[DistanceToGoal.cls_uuid].get_metric()
        called_stop = getattr(task, "is_stop_called", False)
        self._metric = float(called_stop and d < self._config.SUCCESS_DISTANCE)


@registry.register_measure(name="SPL")
class SPL(Measure):
    """Success weighted by (inverse normalized) Path Length."""

    cls_uuid = "spl"

    def __init__(self, *args: Any, sim: Simulator, config=None, **kwargs: Any):
        self._sim = sim
        self._config = config
        super().__init__()

    def reset_metric(self, *args: Any, episode, task, **kwargs: Any) -> None:
        task.measurements.check_measure_dependencies(self.uuid, [DistanceToGoal.cls_uuid, Success.cls_uuid])
        self._start_end_dist = task.measurements.measures[DistanceToGoal.cls_uuid].get_metric()
        self._agent_path_length = 0.0
        self._prev_pos = np.array(self._sim.get_agent_state().position)
        self._metric = 0.0

    def update_metric(self, *args: Any, task, **kwargs: Any) -> None:
        pos = np.array(self._sim.get_agent_state().position)
        self._agent_path_length += euclidean_distance(pos, self._prev_pos)
        self._prev_pos = pos
        success = task.measurements.measures[Success.cls_uuid].get_metric()
        denom = max(self._agent_path_length, self._start_end_dist, 1e-8)
        self._metric = success * (self._start_end_dist / denom)


@registry.register_measure(name="PathLength")
class PathLength(Measure):
    """Sum of euclidean step lengths along the agent path
    (reference habitat_extensions/measures.py:35-60)."""

    cls_uuid = "path_length"

    def __init__(self, *args: Any, sim: Simulator, config=None, **kwargs: Any):
        self._sim = sim
        super().__init__()

    def reset_metric(self, *args: Any, **kwargs: Any) -> None:
        self._previous_position = self._sim.get_agent_state().position
        self._metric = 0.0

    def update_metric(self, *args: Any, **kwargs: Any) -> None:
        pos = self._sim.get_agent_state().position
        self._metric += euclidean_distance(pos, self._previous_position)
        self._previous_position = pos


@registry.register_measure(name="OracleNavigationError")
class OracleNavigationError(Measure):
    """min distance_to_goal over the path
    (reference habitat_extensions/measures.py:63-86)."""

    cls_uuid = "oracle_navigation_error"

    def __init__(self, *args: Any, sim: Simulator = None, config=None, **kwargs: Any):
        super().__init__()

    def reset_metric(self, *args: Any, task, **kwargs: Any) -> None:
        task.measurements.check_measure_dependencies(self.uuid, [DistanceToGoal.cls_uuid])
        self._metric = float("inf")
        self.update_metric(task=task)

    def update_metric(self, *args: Any, task, **kwargs: Any) -> None:
        d = task.measurements.measures[DistanceToGoal.cls_uuid].get_metric()
        self._metric = min(self._metric, d)


@registry.register_measure(name="OracleSuccess")
class OracleSuccess(Measure):
    """I(distance_to_goal < SUCCESS_DISTANCE at any point)
    (reference habitat_extensions/measures.py:89-111)."""

    cls_uuid = "oracle_success"

    def __init__(self, *args: Any, sim: Simulator = None, config=None, **kwargs: Any):
        self._config = config
        super().__init__()

    def reset_metric(self, *args: Any, task, **kwargs: Any) -> None:
        task.measurements.check_measure_dependencies(self.uuid, [DistanceToGoal.cls_uuid])
        self._metric = 0.0
        self.update_metric(task=task)

    def update_metric(self, *args: Any, task, **kwargs: Any) -> None:
        d = task.measurements.measures[DistanceToGoal.cls_uuid].get_metric()
        self._metric = float(self._metric or d < self._config.SUCCESS_DISTANCE)


@registry.register_measure(name="OracleSPL")
class OracleSPL(Measure):
    """max(SPL) over the path (reference habitat_extensions/measures.py:114-131)."""

    cls_uuid = "oracle_spl"

    def __init__(self, *args: Any, sim: Simulator = None, config=None, **kwargs: Any):
        super().__init__()

    def reset_metric(self, *args: Any, task, **kwargs: Any) -> None:
        task.measurements.check_measure_dependencies(self.uuid, ["spl"])
        self._metric = 0.0

    def update_metric(self, *args: Any, task, **kwargs: Any) -> None:
        spl = task.measurements.measures["spl"].get_metric()
        self._metric = max(self._metric, spl)


@registry.register_measure(name="StepsTaken")
class StepsTaken(Measure):
    """Action count incl. STOP (reference habitat_extensions/measures.py:134-150)."""

    cls_uuid = "steps_taken"

    def __init__(self, *args: Any, sim: Simulator = None, config=None, **kwargs: Any):
        super().__init__()

    def reset_metric(self, *args: Any, **kwargs: Any) -> None:
        self._metric = 0.0

    def update_metric(self, *args: Any, **kwargs: Any) -> None:
        self._metric += 1.0


@registry.register_measure(name="NDTW")
class NDTW(Measure):
    """Normalized Dynamic Time Warping to the GT path
    (reference habitat_extensions/measures.py:236-291):
    nDTW = exp(-DTW(path, gt) / (|gt| * d_success)).
    """

    cls_uuid = "ndtw"

    def __init__(self, *args: Any, sim: Simulator, config=None, **kwargs: Any):
        self._sim = sim
        self._config = config
        self.dtw_func = fastdtw if config.FDTW else dtw
        self.gt_json: Dict[str, Any] = {}
        if "{role}" in config.GT_PATH:
            for role in ("guide", "follower"):
                path = config.GT_PATH.format(split=config.SPLIT, role=role)
                try:
                    with gzip.open(path, "rt") as f:
                        self.gt_json.update(json.load(f))
                except FileNotFoundError:
                    pass
        else:
            path = config.GT_PATH.format(split=config.SPLIT)
            try:
                with gzip.open(path, "rt") as f:
                    self.gt_json = json.load(f)
            except FileNotFoundError:
                pass
        super().__init__()

    def reset_metric(self, *args: Any, episode, **kwargs: Any) -> None:
        self.locations: List[List[float]] = []
        if episode.episode_id in self.gt_json:
            self.gt_locations = self.gt_json[episode.episode_id]["locations"]
        else:
            # fall back to the episode's reference path (synthetic datasets
            # carry no separate GT file)
            self.gt_locations = [list(p) for p in (episode.reference_path or [episode.goals[0].position])]
        self.update_metric()

    def update_metric(self, *args: Any, **kwargs: Any) -> None:
        current_position = list(self._sim.get_agent_state().position)
        if len(self.locations) == 0:
            self.locations.append(current_position)
        else:
            if current_position == self.locations[-1]:
                return
            self.locations.append(current_position)
        dtw_distance = self.dtw_func(self.locations, self.gt_locations)
        self._metric = float(
            np.exp(-dtw_distance / (len(self.gt_locations) * self._config.SUCCESS_DISTANCE))
        )


@registry.register_measure(name="SDTW")
class SDTW(Measure):
    """Success-weighted nDTW (reference habitat_extensions/measures.py:294-314)."""

    cls_uuid = "sdtw"

    def __init__(self, *args: Any, sim: Simulator = None, config=None, **kwargs: Any):
        super().__init__()

    def reset_metric(self, *args: Any, task, **kwargs: Any) -> None:
        task.measurements.check_measure_dependencies(self.uuid, [NDTW.cls_uuid, Success.cls_uuid])
        self.update_metric(task=task)

    def update_metric(self, *args: Any, task, **kwargs: Any) -> None:
        success = task.measurements.measures[Success.cls_uuid].get_metric()
        ndtw = task.measurements.measures[NDTW.cls_uuid].get_metric()
        self._metric = success * ndtw


def build_measures(measure_names: List[str], task_config, sim: Simulator) -> Measurements:
    """Instantiate TASK.MEASUREMENTS (in declared order) from config blocks."""
    out = []
    for name in measure_names:
        cfg = getattr(task_config, name)
        cls = registry.get_measure(cfg.TYPE)
        if name in ("SUCCESS", "SPL", "ORACLE_SUCCESS"):
            cfg = cfg.clone().defrost()
            if "SUCCESS_DISTANCE" not in cfg:
                cfg.SUCCESS_DISTANCE = task_config.SUCCESS_DISTANCE
        out.append(cls(sim=sim, config=cfg))
    return Measurements(out)
