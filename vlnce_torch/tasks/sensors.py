"""Task-layer observation sensors.

Registry-registered observation providers called by the task per step
(reference habitat_extensions/sensors.py:19-196 plus the habitat core
Instruction/Heading sensors the task configs assume). Observation arrays are
produced as fixed-shape numpy; batching to device happens in
vlnce_torch/envs/batch.py.
"""

from __future__ import annotations

from typing import Any, List

import numpy as np
from vlnce_torch.envs import spaces

from vlnce_torch.registry import registry
from vlnce_torch.envs.sim import Simulator, SimulatorActions
from vlnce_torch.tasks.geometry import heading_from_quaternion

# padded token length for the R2R instruction observation; the reference gets
# variable-length token lists from habitat's InstructionSensor and pads in
# the batcher — here the sensor itself pads so obs shapes are always static
# (the act step sees one shape for every episode).
MAX_INSTRUCTION_LEN = 200


class Sensor:
    cls_uuid: str = ""

    def __init__(self, *args: Any, config=None, **kwargs: Any):
        self.config = config
        self.uuid = self._get_uuid()
        self.observation_space = self._get_observation_space()

    def _get_uuid(self) -> str:
        return self.cls_uuid

    def _get_observation_space(self) -> spaces.Space:
        raise NotImplementedError

    def get_observation(self, *args: Any, episode, **kwargs: Any):
        raise NotImplementedError


@registry.register_sensor(name="InstructionSensor")
class InstructionSensor(Sensor):
    """Tokenized instruction, zero-padded to MAX_INSTRUCTION_LEN."""

    cls_uuid = "instruction"

    def _get_observation_space(self) -> spaces.Space:
        return spaces.Box(low=0, high=np.iinfo(np.int32).max, shape=(MAX_INSTRUCTION_LEN,), dtype=np.int32)

    def get_observation(self, *args: Any, episode, **kwargs: Any) -> np.ndarray:
        tokens = episode.instruction.instruction_tokens or []
        out = np.zeros((MAX_INSTRUCTION_LEN,), dtype=np.int32)
        n = min(len(tokens), MAX_INSTRUCTION_LEN)
        out[:n] = np.asarray(tokens[:n], dtype=np.int32)
        return out


@registry.register_sensor(name="HeadingSensor")
class HeadingSensor(Sensor):
    cls_uuid = "heading"

    def __init__(self, *args: Any, sim: Simulator, config=None, **kwargs: Any):
        self._sim = sim
        super().__init__(config=config)

    def _get_observation_space(self) -> spaces.Space:
        return spaces.Box(low=-2 * np.pi, high=2 * np.pi, shape=(1,), dtype=np.float32)

    def get_observation(self, *args: Any, episode=None, **kwargs: Any) -> np.ndarray:
        state = self._sim.get_agent_state()
        return np.array([heading_from_quaternion(state.rotation)], dtype=np.float32)


@registry.register_sensor(name="GlobalGPSSensor")
class GlobalGPSSensor(Sensor):
    """Agent position in the global frame
    (reference habitat_extensions/sensors.py:19-50)."""

    cls_uuid = "globalgps"

    def __init__(self, *args: Any, sim: Simulator, config=None, **kwargs: Any):
        self._sim = sim
        self._dimensionality = int(config.DIMENSIONALITY)
        super().__init__(config=config)

    def _get_observation_space(self) -> spaces.Space:
        return spaces.Box(
            low=np.finfo(np.float32).min,
            high=np.finfo(np.float32).max,
            shape=(self._dimensionality,),
            dtype=np.float32,
        )

    def get_observation(self, *args: Any, episode=None, **kwargs: Any) -> np.ndarray:
        pos = self._sim.get_agent_state().position
        if self._dimensionality == 2:
            pos = np.array([pos[0], pos[2]])
        return pos.astype(np.float32)


@registry.register_sensor(name="VLNOracleProgressSensor")
class VLNOracleProgressSensor(Sensor):
    """(d0 - dt) / d0 via geodesic distance
    (reference habitat_extensions/sensors.py:53-87)."""

    cls_uuid = "progress"

    def __init__(self, *args: Any, sim: Simulator, config=None, **kwargs: Any):
        self._sim = sim
        super().__init__(config=config)

    def _get_observation_space(self) -> spaces.Space:
        return spaces.Box(low=0.0, high=1.0, shape=(1,), dtype=np.float32)

    def get_observation(self, *args: Any, episode, **kwargs: Any) -> np.ndarray:
        d_t = self._sim.geodesic_distance(
            list(self._sim.get_agent_state().position), episode.goals[0].position
        )
        if not np.isfinite(d_t):
            return np.array([0.0], dtype=np.float32)
        d_0 = episode.info["geodesic_distance"]
        return np.array([(d_0 - d_t) / d_0], dtype=np.float32)


@registry.register_sensor(name="AngleFeaturesSensor")
class AngleFeaturesSensor(Sensor):
    """Fixed [sin, cos, 0, 1] features per pano camera
    (reference habitat_extensions/sensors.py:90-122)."""

    cls_uuid = "angle_features"

    def __init__(self, *args: Any, config=None, **kwargs: Any):
        self.cameras = int(config.CAMERA_NUM)
        orient = [2 * np.pi / self.cameras * i for i in range(self.cameras)]
        self.angle_features = np.stack(
            [np.array([np.sin(o), np.cos(o), 0.0, 1.0]) for o in orient]
        ).astype(np.float32)
        super().__init__(config=config)

    def _get_observation_space(self) -> spaces.Space:
        return spaces.Box(low=-1.0, high=1.0, shape=(self.cameras, 4), dtype=np.float32)

    def get_observation(self, *args: Any, episode=None, **kwargs: Any) -> np.ndarray:
        return self.angle_features.copy()


@registry.register_sensor(name="ShortestPathSensor")
class ShortestPathSensor(Sensor):
    """Next oracle action toward the goal
    (reference habitat_extensions/sensors.py:125-153)."""

    cls_uuid = "shortest_path_sensor"

    def __init__(self, *args: Any, sim: Simulator, config=None, **kwargs: Any):
        from vlnce_torch.tasks.shortest_path_follower import (
            ShortestPathFollower,
            ShortestPathFollowerCompat,
        )

        # USE_ORIGINAL_FOLLOWER selects the legacy v0.1.4-compat expert for
        # dataset-generation parity (reference sensors.py:136-138)
        cls = ShortestPathFollower
        if bool(getattr(config, "USE_ORIGINAL_FOLLOWER", False)):
            cls = ShortestPathFollowerCompat
        self.follower = cls(sim, float(config.GOAL_RADIUS), return_one_hot=False)
        super().__init__(config=config)

    def _get_observation_space(self) -> spaces.Space:
        return spaces.Box(low=0.0, high=100.0, shape=(1,), dtype=np.float32)

    def get_observation(self, *args: Any, episode, **kwargs: Any) -> np.ndarray:
        best_action = self.follower.get_next_action(episode.goals[0].position)
        if best_action is None:
            best_action = SimulatorActions.STOP
        return np.array([best_action], dtype=np.float32)


@registry.register_sensor(name="RxRInstructionSensor")
class RxRInstructionSensor(Sensor):
    """Precomputed BERT features zero-padded to [512, 768]
    (reference habitat_extensions/sensors.py:156-196)."""

    cls_uuid = "rxr_instruction"

    def __init__(self, *args: Any, config=None, **kwargs: Any):
        self.features_path = config.features_path
        self.max_text_len = int(getattr(config, "max_text_len", 512))
        self.feature_dim = int(getattr(config, "feature_dim", 768))
        super().__init__(config=config)

    def _get_observation_space(self) -> spaces.Space:
        return spaces.Box(
            low=np.finfo(np.float32).min,
            high=np.finfo(np.float32).max,
            shape=(self.max_text_len, self.feature_dim),
            dtype=np.float32,
        )

    def get_observation(self, *args: Any, episode, **kwargs: Any) -> np.ndarray:
        feats = np.zeros((self.max_text_len, self.feature_dim), dtype=np.float32)
        instr = episode.instruction
        try:
            archive = np.load(
                self.features_path.format(
                    split=getattr(instr, "split", None),
                    id=int(getattr(instr, "instruction_id", None) or episode.episode_id),
                    lang=(getattr(instr, "language", None) or "en-US").split("-")[0],
                )
            )
            f = archive["features"]
            feats[: f.shape[0], : f.shape[1]] = f[: self.max_text_len, : self.feature_dim]
        except (FileNotFoundError, KeyError, ValueError, TypeError) as e:
            # synthetic fallback: deterministic features from the episode id so
            # the full RxR path runs without the 23GB feature dump on disk.
            # Warn once — on real RxR data a typo'd features_path would
            # otherwise silently train on noise.
            if not getattr(RxRInstructionSensor, "_warned_fallback", False):
                RxRInstructionSensor._warned_fallback = True
                import logging

                logging.getLogger("vlnce_torch").warning(
                    "RxRInstructionSensor: failed to load BERT features from "
                    f"{self.features_path!r} ({type(e).__name__}: {e}); falling "
                    "back to deterministic synthetic features. If you expected "
                    "real RxR features, check INSTRUCTION_SENSOR.features_path."
                )
            rng = np.random.RandomState(abs(hash(str(episode.episode_id))) % (2**31))
            n = rng.randint(8, max(9, self.max_text_len // 2))
            feats[:n] = rng.randn(n, self.feature_dim).astype(np.float32)
        return feats


@registry.register_sensor(name="OracleActionSensor")
class OracleActionSensor(ShortestPathSensor):
    """Alias retained for config parity
    (reference habitat_extensions/config/default.py:22-24)."""

    cls_uuid = "oracle_action_sensor"


def build_sensors(sensor_names: List[str], task_config, sim: Simulator) -> List[Sensor]:
    """Instantiate TASK.SENSORS from their config blocks."""
    out = []
    for name in sensor_names:
        cfg = getattr(task_config, name)
        cls = registry.get_sensor(cfg.TYPE)
        out.append(cls(sim=sim, config=cfg))
    return out
