"""R2R and RxR VLN-CE dataset loaders.

Behavioral parity with reference habitat_extensions/task.py:45-232:
gzipped-JSON episode files, instruction vocab, CONTENT_SCENES /
EPISODES_ALLOWED / LANGUAGES filtering, multi-role loading for RxR. Also
provides a synthetic-episode generator used with the procedural GridWorld
simulator when no real data assets are on disk.
"""

from __future__ import annotations

import gzip
import json
import os
from typing import List, Optional

import numpy as np

from vlnce_torch.registry import registry
from vlnce_torch.tasks.episodes import (
    ExtendedInstructionData,
    InstructionData,
    NavigationGoal,
    VLNEpisode,
)
from vlnce_torch.tasks.vocab import VocabDict

ALL_SCENES_MASK = "*"
ALL_LANGUAGES_MASK = "*"
ALL_ROLES_MASK = "*"
ALL_EPISODES_MASK = "*"
DEFAULT_SCENE_PATH_PREFIX = "data/scene_datasets/"


class BaseVLNDataset:
    """Shared episode-list behavior (habitat Dataset equivalent)."""

    episodes: List[VLNEpisode]
    instruction_vocab: Optional[VocabDict]

    def __init__(self, config=None) -> None:
        self.episodes = []
        self.instruction_vocab = None
        self.config = config
        if config is None:
            return
        self._load(config)
        self._apply_common_filters(config)

    # -- hooks ---------------------------------------------------------------
    def _load(self, config) -> None:
        raise NotImplementedError

    # -- shared filtering ----------------------------------------------------
    def _apply_common_filters(self, config) -> None:
        if ALL_SCENES_MASK not in config.CONTENT_SCENES:
            scenes = set(config.CONTENT_SCENES)
            self.episodes = [e for e in self.episodes if self.scene_from_scene_path(e.scene_id) in scenes]
        episodes_allowed = getattr(config, "EPISODES_ALLOWED", [ALL_EPISODES_MASK])
        if ALL_EPISODES_MASK not in episodes_allowed:
            allowed = {str(i) for i in episodes_allowed}
            self.episodes = [e for e in self.episodes if str(e.episode_id) in allowed]

    @staticmethod
    def scene_from_scene_path(scene_path: str) -> str:
        return os.path.splitext(os.path.basename(scene_path))[0]

    @classmethod
    def get_scenes_to_load(cls, config) -> List[str]:
        assert cls.check_config_paths_exist(config), "dataset paths missing"
        dataset = cls(config)
        return sorted({cls.scene_from_scene_path(e.scene_id) for e in dataset.episodes})

    @staticmethod
    def check_config_paths_exist(config) -> bool:
        raise NotImplementedError

    def filter_episodes(self, predicate) -> None:
        self.episodes = [e for e in self.episodes if predicate(e)]

    def __len__(self) -> int:
        return len(self.episodes)

    def _rewrite_scene_id(self, episode: VLNEpisode, scenes_dir: Optional[str]) -> None:
        if scenes_dir is None:
            return
        sid = episode.scene_id
        if sid.startswith(DEFAULT_SCENE_PATH_PREFIX):
            sid = sid[len(DEFAULT_SCENE_PATH_PREFIX):]
        episode.scene_id = os.path.join(scenes_dir, sid)


@registry.register_dataset(name="VLN-CE-v1")
class VLNCEDatasetV1(BaseVLNDataset):
    """R2R VLN-CE episodes + instruction vocab
    (reference habitat_extensions/task.py:45-122)."""

    def _load(self, config) -> None:
        path = config.DATA_PATH.format(split=config.SPLIT)
        with gzip.open(path, "rt") as f:
            self.from_json(f.read(), scenes_dir=config.SCENES_DIR)

    def from_json(self, json_str: str, scenes_dir: Optional[str] = None) -> None:
        data = json.loads(json_str)
        if "instruction_vocab" in data:
            self.instruction_vocab = VocabDict(word_list=data["instruction_vocab"]["word_list"])
        for ep in data["episodes"]:
            ep["episode_id"] = str(ep["episode_id"])
            if "trajectory_id" in ep:
                ep["trajectory_id"] = str(ep["trajectory_id"])
            episode = VLNEpisode.from_dict(ep)
            self._rewrite_scene_id(episode, scenes_dir)
            episode.instruction = InstructionData.from_dict(ep["instruction"])
            if episode.goals is not None:
                episode.goals = [NavigationGoal.from_dict(g) for g in ep["goals"]]
            self.episodes.append(episode)

    @staticmethod
    def check_config_paths_exist(config) -> bool:
        return os.path.exists(config.DATA_PATH.format(split=config.SPLIT)) and os.path.exists(config.SCENES_DIR)


@registry.register_dataset(name="RxR-VLN-CE-v1")
class RxRVLNCEDatasetV1(BaseVLNDataset):
    """RxR VLN-CE episodes; multi-role, multi-language
    (reference habitat_extensions/task.py:125-232)."""

    annotation_roles: List[str] = ["guide", "follower"]
    languages: List[str] = ["en-US", "en-IN", "hi-IN", "te-IN"]

    def _load(self, config) -> None:
        for role in self.extract_roles_from_config(config):
            path = config.DATA_PATH.format(split=config.SPLIT, role=role)
            with gzip.open(path, "rt") as f:
                self.from_json(f.read(), scenes_dir=config.SCENES_DIR)

    def _apply_common_filters(self, config) -> None:
        super()._apply_common_filters(config)
        if ALL_LANGUAGES_MASK not in config.LANGUAGES:
            langs = set(config.LANGUAGES)
            self.episodes = [e for e in self.episodes if e.instruction.language in langs]

    def from_json(self, json_str: str, scenes_dir: Optional[str] = None) -> None:
        data = json.loads(json_str)
        for ep in data["episodes"]:
            ep["episode_id"] = str(ep["episode_id"])
            episode = VLNEpisode.from_dict(ep)
            self._rewrite_scene_id(episode, scenes_dir)
            episode.instruction = ExtendedInstructionData.from_dict(ep["instruction"])
            episode.instruction.split = self.config.SPLIT
            if episode.goals is not None:
                episode.goals = [NavigationGoal.from_dict(g) for g in ep["goals"]]
            self.episodes.append(episode)

    @classmethod
    def extract_roles_from_config(cls, config) -> List[str]:
        if ALL_ROLES_MASK in config.ROLES:
            return cls.annotation_roles
        assert set(config.ROLES).issubset(set(cls.annotation_roles))
        return list(config.ROLES)

    @classmethod
    def check_config_paths_exist(cls, config) -> bool:
        return all(
            os.path.exists(config.DATA_PATH.format(split=config.SPLIT, role=role))
            for role in cls.extract_roles_from_config(config)
        ) and os.path.exists(config.SCENES_DIR)


@registry.register_dataset(name="Synthetic-VLN-v0")
class SyntheticVLNDataset(BaseVLNDataset):
    """Procedurally generated episodes for the GridWorld simulator.

    Used for tests, benchmarks, and dry-runs when the MP3D-derived assets are
    not on disk. Episode fields follow the R2R schema exactly so everything
    downstream (sensors, measures, collate, trainers) is exercised unchanged.
    """

    VOCAB_WORDS = [
        "<pad>", "<unk>", "walk", "turn", "left", "right", "forward", "stop",
        "go", "past", "the", "door", "room", "hall", "stairs", "table",
        "chair", "kitchen", "bedroom", "exit", "enter", "toward", "then",
        "and", "at", "to", "of", "into", "around", "straight", "until", "wait",
    ]

    def _load(self, config) -> None:
        split = config.SPLIT
        num_episodes = getattr(config, "NUM_EPISODES", 64)
        num_scenes = getattr(config, "NUM_SCENES", 4)
        seed = {"train": 0, "val_seen": 1, "val_unseen": 2, "test": 3}.get(split, 7)
        self.instruction_vocab = VocabDict(self.VOCAB_WORDS)
        rng = np.random.RandomState(seed * 7919 + 13)
        for i in range(num_episodes):
            scene = f"synth_scene_{(seed if split != 'val_unseen' else 100 + seed) * num_scenes + (i % num_scenes)}"
            self.episodes.append(self._make_episode(rng, i, scene, split))

    def _make_episode(self, rng: np.random.RandomState, idx: int, scene: str, split: str) -> VLNEpisode:
        # waypoints on a coarse lattice; GridWorldSim guarantees lattice points
        # are navigable and connected.
        for _attempt in range(20):
            n_way = int(rng.randint(3, 7))
            start = np.array([float(rng.randint(2, 14)), 0.0, float(rng.randint(2, 14))])
            path = [start.copy()]
            pos = start.copy()
            for _ in range(n_way):
                step = rng.choice([-2.0, 2.0], size=2)
                nxt = pos + np.array([step[0], 0.0, step[1]])
                nxt[0] = float(np.clip(nxt[0], 1.0, 15.0))
                nxt[2] = float(np.clip(nxt[2], 1.0, 15.0))
                if np.array_equal(nxt, pos):
                    continue
                path.append(nxt.copy())
                pos = nxt
            if np.linalg.norm(path[-1][[0, 2]] - start[[0, 2]]) >= 4.0:
                break
        heading = float(rng.uniform(0, 2 * np.pi))
        from vlnce_torch.tasks.geometry import quat_from_heading

        tokens = [int(rng.randint(2, len(self.VOCAB_WORDS))) for _ in range(int(rng.randint(8, 30)))]
        text = " ".join(self.instruction_vocab.idx2word(t) for t in tokens)
        geo = float(sum(np.linalg.norm(path[i + 1] - path[i]) for i in range(len(path) - 1)))
        return VLNEpisode(
            episode_id=str(idx),
            trajectory_id=str(idx),
            scene_id=f"synthetic/{scene}.glb",
            start_position=[float(x) for x in path[0]],
            start_rotation=[float(x) for x in quat_from_heading(heading)],
            instruction=InstructionData(instruction_text=text, instruction_tokens=tokens),
            goals=[NavigationGoal(position=[float(x) for x in path[-1]], radius=3.0)],
            reference_path=[[float(x) for x in p] for p in path],
            info={"geodesic_distance": geo},
        )

    @staticmethod
    def check_config_paths_exist(config) -> bool:
        return True


def make_dataset(name: str, config=None):
    return registry.get_dataset(name)(config)
