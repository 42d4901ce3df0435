"""Episode schema for VLN-CE / RxR-VLN-CE.

Dataclass records mirroring the reference episode schema
(reference habitat_extensions/task.py:21-42 and the habitat
VLNEpisode/NavigationGoal records it extends). Unknown JSON keys are dropped
at construction so dataset format drift doesn't crash loading.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Union


def _filter_kwargs(cls, d: Dict[str, Any]) -> Dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


@dataclasses.dataclass
class NavigationGoal:
    position: List[float] = None
    radius: Optional[float] = None

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "NavigationGoal":
        return cls(**_filter_kwargs(cls, d))


@dataclasses.dataclass
class InstructionData:
    instruction_text: str = None
    instruction_tokens: Optional[List[int]] = None

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "InstructionData":
        return cls(**_filter_kwargs(cls, d))


@dataclasses.dataclass
class ExtendedInstructionData:
    """RxR instruction record (reference habitat_extensions/task.py:21-32)."""

    instruction_text: str = None
    instruction_id: Optional[str] = None
    language: Optional[str] = None
    annotator_id: Optional[str] = None
    edit_distance: Optional[float] = None
    timed_instruction: Optional[List[Dict[str, Union[float, str]]]] = None
    instruction_tokens: Optional[List[str]] = None
    split: Optional[str] = None

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExtendedInstructionData":
        return cls(**_filter_kwargs(cls, d))


@dataclasses.dataclass(kw_only=True)
class VLNEpisode:
    """One VLN-CE episode (reference habitat_extensions/task.py:35-42 plus
    the habitat VLNEpisode base fields)."""

    episode_id: str
    scene_id: str
    start_position: List[float]
    start_rotation: List[float]  # quaternion [x, y, z, w]
    instruction: Any = None
    goals: Optional[List[NavigationGoal]] = None
    reference_path: Optional[List[List[float]]] = None
    trajectory_id: Optional[Union[int, str]] = None
    info: Optional[Dict[str, Any]] = None
    start_room: Optional[str] = None
    shortest_paths: Optional[List[Any]] = None

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "VLNEpisode":
        return cls(**_filter_kwargs(cls, d))


# alias matching the reference class name
VLNExtendedEpisode = VLNEpisode
