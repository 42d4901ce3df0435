"""Habitat-Sim adapter (production MP3D backend).

Port of vlnce_tpu/envs/habitat_adapter.py. Maps the Simulator protocol
(vlnce_torch/envs/sim.py) onto habitat_sim when it
is installed — the seam through which real Matterport3D scenes plug into the
framework in place of the procedural GridWorld. Import is gated: the module
registers "HabitatSim-v0" only when habitat_sim is importable, so the rest
of the package never depends on it.

The surface matches exactly what the task layer consumes from Habitat-Sim in
the reference (reference habitat_extensions/actions.py:37-55, sensors.py:
75-78, shortest_path_follower.py): step/reset, agent state, geodesic
distance, navigability, snap_point, step_filter sliding, pose-conditioned
rendering, and straight shortest-path points.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from vlnce_torch.registry import registry
from vlnce_torch.envs.sim import AgentState, Observations, Simulator, SimulatorActions

try:  # pragma: no cover - exercised only with habitat_sim installed
    import habitat_sim

    HABITAT_SIM_AVAILABLE = True
except ImportError:
    habitat_sim = None
    HABITAT_SIM_AVAILABLE = False


if HABITAT_SIM_AVAILABLE:  # pragma: no cover

    @registry.register_simulator(name="HabitatSim-v0")
    class HabitatSimAdapter(Simulator):
        def __init__(self, config):
            self.config = config
            self._sim: Optional["habitat_sim.Simulator"] = None
            self._scene_id: Optional[str] = None
            self._action_map = {
                SimulatorActions.MOVE_FORWARD: "move_forward",
                SimulatorActions.TURN_LEFT: "turn_left",
                SimulatorActions.TURN_RIGHT: "turn_right",
                SimulatorActions.LOOK_UP: "look_up",
                SimulatorActions.LOOK_DOWN: "look_down",
            }

        # -- configuration -------------------------------------------------
        def _make_config(self, scene_id: str):
            backend = habitat_sim.SimulatorConfiguration()
            backend.scene_id = scene_id
            backend.allow_sliding = bool(self.config.HABITAT_SIM_V0.ALLOW_SLIDING)
            backend.gpu_device_id = int(self.config.HABITAT_SIM_V0.GPU_DEVICE_ID)

            sensor_specs = []
            for name in self.config.AGENT_0.SENSORS:
                cam = getattr(self.config, name, None)
                if cam is None:
                    continue
                spec = habitat_sim.CameraSensorSpec()
                spec.uuid = cam.UUID
                spec.sensor_type = (
                    habitat_sim.SensorType.DEPTH if "DEPTH" in name else habitat_sim.SensorType.COLOR
                )
                spec.resolution = [cam.HEIGHT, cam.WIDTH]
                spec.position = list(cam.POSITION)
                spec.orientation = list(cam.ORIENTATION)
                spec.hfov = float(cam.HFOV)
                sensor_specs.append(spec)

            agent = habitat_sim.agent.AgentConfiguration()
            agent.sensor_specifications = sensor_specs
            agent.height = float(self.config.AGENT_0.HEIGHT)
            agent.radius = float(self.config.AGENT_0.RADIUS)
            fwd = float(self.config.FORWARD_STEP_SIZE)
            turn = float(self.config.TURN_ANGLE)
            tilt = float(getattr(self.config, "TILT_ANGLE", turn))
            agent.action_space = {
                "move_forward": habitat_sim.agent.ActionSpec(
                    "move_forward", habitat_sim.agent.ActuationSpec(amount=fwd)
                ),
                "turn_left": habitat_sim.agent.ActionSpec(
                    "turn_left", habitat_sim.agent.ActuationSpec(amount=turn)
                ),
                "turn_right": habitat_sim.agent.ActionSpec(
                    "turn_right", habitat_sim.agent.ActuationSpec(amount=turn)
                ),
                "look_up": habitat_sim.agent.ActionSpec(
                    "look_up", habitat_sim.agent.ActuationSpec(amount=tilt)
                ),
                "look_down": habitat_sim.agent.ActionSpec(
                    "look_down", habitat_sim.agent.ActuationSpec(amount=tilt)
                ),
            }
            return habitat_sim.Configuration(backend, [agent])

        def reconfigure(self, scene_id: str) -> None:
            if self._sim is not None and scene_id == self._scene_id:
                return
            if self._sim is not None:
                self._sim.close()
            self._sim = habitat_sim.Simulator(self._make_config(scene_id))
            self._scene_id = scene_id

        # -- stepping ------------------------------------------------------
        def reset(self) -> Observations:
            obs = self._sim.reset()
            return self._post(obs)

        def step(self, action: int) -> Observations:
            if action == SimulatorActions.STOP:
                return self.get_observations_at()
            obs = self._sim.step(self._action_map[action])
            self.previous_step_collided = self._sim.previous_step_collided
            return self._post(obs)

        def _post(self, obs) -> Observations:
            out = {}
            for k, v in obs.items():
                v = np.asarray(v)
                if v.ndim == 3 and v.shape[-1] == 4:
                    v = v[..., :3]  # drop alpha
                if v.ndim == 2:  # depth [H, W] -> [H, W, 1], normalized
                    cfg = self.config.DEPTH_SENSOR
                    v = np.clip(v, cfg.MIN_DEPTH, cfg.MAX_DEPTH)
                    if cfg.NORMALIZE_DEPTH:
                        v = (v - cfg.MIN_DEPTH) / (cfg.MAX_DEPTH - cfg.MIN_DEPTH)
                    v = v[..., None].astype(np.float32)
                out[k] = v
            return out

        # -- state ---------------------------------------------------------
        def get_agent_state(self) -> AgentState:
            s = self._sim.get_agent(0).get_state()
            q = s.rotation
            return AgentState(np.asarray(s.position), np.array([q.x, q.y, q.z, q.w]))

        def set_agent_state(self, position, rotation) -> None:
            state = self._sim.get_agent(0).get_state()
            state.position = np.asarray(position, dtype=np.float32)
            state.rotation = habitat_sim.utils.common.quat_from_coeffs(np.asarray(rotation))
            self._sim.get_agent(0).set_state(state, reset_sensors=True)

        def get_observations_at(self, position=None, rotation=None, keep_agent_at_new_pose=False) -> Observations:
            agent = self._sim.get_agent(0)
            old = agent.get_state()
            if position is not None or rotation is not None:
                self.set_agent_state(
                    position if position is not None else old.position,
                    rotation if rotation is not None else [old.rotation.x, old.rotation.y, old.rotation.z, old.rotation.w],
                )
            obs = self._post(self._sim.get_sensor_observations())
            if not keep_agent_at_new_pose and (position is not None or rotation is not None):
                agent.set_state(old, reset_sensors=True)
            return obs

        # -- navigation ----------------------------------------------------
        def geodesic_distance(self, position_a, position_b) -> float:
            b = np.asarray(position_b, dtype=np.float32)
            goals = b[None, :] if b.ndim == 1 else b
            path = habitat_sim.MultiGoalShortestPath()
            path.requested_start = np.asarray(position_a, dtype=np.float32)
            path.requested_ends = goals
            self._sim.pathfinder.find_path(path)
            return float(path.geodesic_distance)

        def is_navigable(self, position) -> bool:
            return bool(self._sim.pathfinder.is_navigable(np.asarray(position, dtype=np.float32)))

        def snap_point(self, position) -> np.ndarray:
            return np.asarray(self._sim.pathfinder.snap_point(np.asarray(position, dtype=np.float32)))

        def step_filter(self, start, end) -> np.ndarray:
            return np.asarray(
                self._sim.step_filter(np.asarray(start, np.float32), np.asarray(end, np.float32))
            )

        def get_straight_shortest_path_points(self, position_a, position_b) -> List[List[float]]:
            path = habitat_sim.ShortestPath()
            path.requested_start = np.asarray(position_a, dtype=np.float32)
            path.requested_end = np.asarray(position_b, dtype=np.float32)
            self._sim.pathfinder.find_path(path)
            return [list(map(float, p)) for p in path.points]

        def sample_navigable_point(self) -> List[float]:
            return list(map(float, self._sim.pathfinder.get_random_navigable_point()))

        def seed(self, seed: int) -> None:
            self._sim.seed(seed)

        def close(self) -> None:
            if self._sim is not None:
                self._sim.close()
                self._sim = None
