"""Task metrics (Measure system).

Implements the habitat core measures the task configs assume (DistanceToGoal,
Success, SPL) and the VLN-CE extension measures
(reference habitat_extensions/measures.py:35-562), with the same uuids,
dependency declarations, and update semantics. nDTW uses the from-scratch
fastdtw/dtw in vlnce_torch/tasks/dtw.py. TopDownMapVLNCE paints the video
path's top-down index map (vlnce_torch/utils/maps.py).
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
from vlnce_torch.utils import maps as map_utils
from vlnce_torch.utils.nav_graph import _node_position, get_nearest_node, load_connectivity_graphs, update_nearest_node


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


@registry.register_measure(name="WaypointRewardMeasure")
class WaypointRewardMeasure(Measure):
    """RL shaping reward: distance-scaled slack + distance-to-goal delta +
    success bonus (reference habitat_extensions/measures.py:153-233)."""

    cls_uuid = "waypoint_reward_measure"

    def __init__(self, *args: Any, sim: Simulator, config=None, **kwargs: Any):
        self._sim = sim
        self._slack_reward = config.slack_reward
        self._use_distance_scaled_slack_reward = config.use_distance_scaled_slack_reward
        self._scale_slack_on_prediction = config.scale_slack_on_prediction
        self._success_reward = config.success_reward
        self._distance_scalar = config.distance_scalar
        self._prev_position = None
        super().__init__()

    def reset_metric(self, *args: Any, task, **kwargs: Any) -> None:
        task.measurements.check_measure_dependencies(self.uuid, [DistanceToGoal.cls_uuid, Success.cls_uuid])
        self._previous_distance_to_goal = task.measurements.measures["distance_to_goal"].get_metric()
        self._metric = 0.0
        self._prev_position = np.take(self._sim.get_agent_state().position, [0, 2])

    def _get_scaled_slack_reward(self, action) -> float:
        if isinstance(action.get("action"), int):
            return self._slack_reward
        if not self._use_distance_scaled_slack_reward:
            return self._slack_reward
        agent_pos = np.take(self._sim.get_agent_state().position, [0, 2])
        if self._scale_slack_on_prediction and action["action"] != "STOP":
            slack_distance = action["action_args"]["r"]
        else:
            slack_distance = float(np.linalg.norm(self._prev_position - agent_pos))
        scaled = self._slack_reward * slack_distance / 0.25
        self._prev_position = agent_pos
        return min(self._slack_reward, scaled)

    def _progress_to_goal(self, task) -> float:
        d = task.measurements.measures["distance_to_goal"].get_metric()
        delta = self._previous_distance_to_goal - d
        if np.isnan(delta) or np.isinf(delta):
            delta = -1.0
        self._previous_distance_to_goal = d
        return self._distance_scalar * delta

    def update_metric(self, *args: Any, action, task, **kwargs: Any) -> None:
        reward = self._get_scaled_slack_reward(action)
        reward += self._progress_to_goal(task)
        reward += self._success_reward * task.measurements.measures["success"].get_metric()
        self._metric = reward


@registry.register_measure(name="TopDownMapVLNCE")
class TopDownMapVLNCE(Measure):
    """Top-down indicator map with agent step-gradient trail, MP3D nav-graph
    nodes + nearest-node path tracking, reference/shortest paths, and
    source/target markers (reference habitat_extensions/measures.py:317-562).
    The map is an index image painted in place; colorization happens at viz
    time (vlnce_torch/utils/maps.py)."""

    cls_uuid = "top_down_map_vlnce"

    def __init__(self, *args: Any, sim: Simulator, config=None, **kwargs: Any):
        self._sim = sim
        self._config = config
        self._map_resolution = int(getattr(config, "MAP_RESOLUTION", 256))
        super().__init__()

    @property
    def _world_size(self) -> float:
        scene = getattr(self._sim, "_scene", None)
        if scene is not None:
            # occupancy grid spans the square world
            from vlnce_torch.envs.gridworld import _RES

            return scene.occupancy.shape[0] * _RES
        return 16.0

    def reset_metric(self, *args: Any, episode, **kwargs: Any) -> None:
        self._step_count = 0
        self._episode = episode
        self._meters_per_px = self._world_size / self._map_resolution
        start = self._sim.get_agent_state()
        self._map = map_utils.make_top_down_index_map(
            self._sim, self._map_resolution, draw_border=bool(getattr(self._config, "DRAW_BORDER", True))
        )
        r, c = map_utils.to_grid(start.position[0], start.position[2], self._map.shape, self._world_size)
        self._previous_xy_location = (c, r)

        # nav graph: fixed waypoints + nearest-node path tracking
        self._nav_graph = None
        if getattr(self._config, "DRAW_FIXED_WAYPOINTS", False) or getattr(self._config, "DRAW_MP3D_AGENT_PATH", False):
            graphs = load_connectivity_graphs(self._config.GRAPHS_FILE)
            if graphs:
                scene = episode.scene_id.split("/")[-1].split(".")[0]
                self._nav_graph = graphs.get(scene)
        if self._nav_graph is not None and getattr(self._config, "DRAW_FIXED_WAYPOINTS", False):
            map_utils.draw_mp3d_nodes(self._map, self._nav_graph, episode, self._world_size, self._meters_per_px)

        if self._config.DRAW_SHORTEST_PATH and episode.goals:
            try:
                points = self._sim.get_straight_shortest_path_points(
                    list(start.position), episode.goals[0].position
                )
                map_utils.draw_straight_shortest_path_points(self._map, points, self._world_size)
            except Exception:
                pass
        if self._config.DRAW_REFERENCE_PATH and getattr(episode, "reference_path", None):
            map_utils.draw_reference_path(self._map, episode, self._world_size, self._meters_per_px)
        # source and target last so they are not painted over
        if self._config.DRAW_SOURCE_AND_TARGET:
            map_utils.draw_source_and_target(self._map, episode, self._world_size, self._meters_per_px)

        # MP3D start node (nearest-node tracking, reference measures.py:430-443)
        self._nearest_node = None
        if self._nav_graph is not None:
            self._nearest_node = get_nearest_node(
                self._nav_graph, (start.position[0], start.position[2])
            )
            if self._nearest_node is not None:
                pos = _node_position(self._nav_graph, self._nearest_node)
                self._node_rc = map_utils.to_grid(pos[0], pos[-1], self._map.shape, self._world_size)

        self._fog_mask = None
        scene = getattr(self._sim, "_scene", None)
        if self._config.FOG_OF_WAR.DRAW and scene is not None:
            self._fog_mask = np.zeros_like(scene.occupancy, dtype=np.uint8)
        self.update_metric(episode=episode)

    def update_metric(self, *args: Any, episode=None, **kwargs: Any) -> None:
        self._step_count += 1
        state = self._sim.get_agent_state()
        heading = map_utils.agent_heading(state)
        r, c = map_utils.to_grid(state.position[0], state.position[2], self._map.shape, self._world_size)

        # agent trail with a step gradient (never over the source marker)
        max_steps = max(1, int(getattr(self._config, "MAX_EPISODE_STEPS", 500)))
        gradient_color = 15 + min(self._step_count * 245 // max_steps, 245)
        if self._map[r, c] != map_utils.MAP_SOURCE_POINT_INDICATOR:
            map_utils.drawline(
                self._map, self._previous_xy_location, (c, r), gradient_color,
                thickness=int(self._map_resolution * 1.4 / map_utils.MAP_THICKNESS_SCALAR),
                style="filled",
            )

        if self._fog_mask is not None:
            map_utils.reveal_fog_of_war(
                self._sim._scene.occupancy, self._fog_mask, state.position, heading,
                fov_deg=float(self._config.FOG_OF_WAR.FOV),
                visibility_dist=float(self._config.FOG_OF_WAR.VISIBILITY_DIST),
                world_size=self._world_size,
            )

        # nearest-node path over the nav graph (reference measures.py:516-560)
        if self._nearest_node is not None:
            prev = self._nearest_node
            self._nearest_node = update_nearest_node(
                self._nav_graph, self._nearest_node, (state.position[0], state.position[2])
            )
            if self._nearest_node != prev and getattr(self._config, "DRAW_MP3D_AGENT_PATH", False):
                pos = _node_position(self._nav_graph, self._nearest_node)
                prev_rc = self._node_rc
                self._node_rc = map_utils.to_grid(pos[0], pos[-1], self._map.shape, self._world_size)
                map_utils.drawpoint(
                    self._map, self._node_rc, gradient_color, self._meters_per_px, pad=0.15
                )
                map_utils.drawline(
                    self._map, (prev_rc[1], prev_rc[0]), (self._node_rc[1], self._node_rc[0]),
                    gradient_color,
                    thickness=max(1, int(0.5 * self._map_resolution / map_utils.MAP_THICKNESS_SCALAR)),
                )

        self._previous_xy_location = (c, r)
        self._metric = {
            "map": self._map,
            "fog_of_war_mask": self._fog_mask,
            "agent_map_coord": (r, c),
            "agent_angle": heading,
            "meters_per_px": self._meters_per_px,
            "bounds": {"lower": (0.0, 0.0), "upper": (self._world_size, self._world_size)},
            "world_size": self._world_size,
            "step_count": self._step_count,
        }


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
