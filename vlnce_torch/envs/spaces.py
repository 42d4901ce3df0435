"""Observation and action spaces, without gymnasium.

The port describes observations with the few parts of gymnasium's `Box`,
`Dict` and `Discrete` that the models and transforms read (shape, dtype,
bounds, `.spaces`, `.n`), so it runs where gymnasium is not installed.
`observation_space_from_config` builds the space the environment reports for
a task config: the cameras of `SIMULATOR.AGENT_0.SENSORS`, and the
instruction and progress sensors of `TASK.SENSORS`.
"""

from __future__ import annotations

from typing import Dict as TDict, Optional, Tuple

import numpy as np


class Space:
    """Base of the space types, for annotations and isinstance checks."""


class Box(Space):
    """Bounded array space. `low` and `high` are scalars or arrays; without
    `shape` they give it, as in gymnasium."""

    def __init__(self, low, high, shape: Optional[Tuple[int, ...]] = None, dtype=np.float32):
        self.dtype = np.dtype(dtype)
        if shape is None:
            shape = np.broadcast(np.asarray(low), np.asarray(high)).shape
        self.shape = tuple(int(s) for s in shape)
        self.low = np.broadcast_to(np.asarray(low, self.dtype), self.shape).copy()
        self.high = np.broadcast_to(np.asarray(high, self.dtype), self.shape).copy()

    def __repr__(self) -> str:
        return f"Box({self.shape}, {self.dtype})"


class Dict(Space):
    def __init__(self, spaces: TDict[str, Space]):
        self.spaces = dict(spaces)

    def __getitem__(self, key: str) -> Space:
        return self.spaces[key]

    def __contains__(self, key: str) -> bool:
        return key in self.spaces

    def __repr__(self) -> str:
        return f"Dict({self.spaces})"


class Discrete(Space):
    def __init__(self, n: int):
        self.n = int(n)

    def __repr__(self) -> str:
        return f"Discrete({self.n})"


def observation_space_from_config(task_config) -> Dict:
    """The space of the observations the environment returns for this task
    config (the JAX package's `Env.observation_space` and its sensors)."""
    sim = task_config.SIMULATOR
    out = {}
    for name in sim.AGENT_0.SENSORS:
        cam = getattr(sim, name, None)
        if cam is None:
            continue
        if "DEPTH" in name:
            out[cam.UUID] = Box(0.0, 1.0, (cam.HEIGHT, cam.WIDTH, 1), np.float32)
        else:
            out[cam.UUID] = Box(0, 255, (cam.HEIGHT, cam.WIDTH, 3), np.uint8)
    task = task_config.TASK
    if "RXR_INSTRUCTION_SENSOR" in task.SENSORS:
        s = task.RXR_INSTRUCTION_SENSOR
        f32 = np.finfo(np.float32)
        out["rxr_instruction"] = Box(f32.min, f32.max, (s.max_text_len, s.feature_dim), np.float32)
    if "INSTRUCTION_SENSOR" in task.SENSORS:
        out[task.INSTRUCTION_SENSOR_UUID] = Box(0, np.iinfo(np.int32).max, (200,), np.int32)
    if "VLN_ORACLE_PROGRESS_SENSOR" in task.SENSORS:
        out["progress"] = Box(0.0, 1.0, (1,), np.float32)
    return Dict(out)


def action_space_from_config(task_config) -> Discrete:
    return Discrete(len(task_config.TASK.POSSIBLE_ACTIONS))
