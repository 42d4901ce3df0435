"""The traffic generator of the DD-PPO cells (`kind` "ppo_split"): a
training split of R2R-like episodes on procedural scenes, made from the
seed. Every seed gets the same numbers of paths, instructions, scenes and
distinct goals; the seed sets the scenes' choice, the starts, goals,
headings and instructions.

A path is a start and a goal on a scene, told by `instructions_per_path`
instructions (R2R annotates each path three times), one episode each; no
two paths share a goal cell, so the split has one distinct goal field per
path. Instructions are token ids in [2, vocab) of a length drawn between
`instruction_tokens`' bounds, zero past it.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from benchmark.generate import LATTICE, _goal_pools, scene_ids


def ppo_split(params: Dict, seed: int, vocab: int) -> List[Dict]:
    """The split's episodes in order: dicts of id, scene, start [x, 0, z],
    heading, goal [x, 0, z], tokens (a list of ints). The paths are drawn on
    scenes in a seeded order, each path's episodes consecutive."""
    rng = np.random.default_rng(seed)
    n_scenes = int(params["scenes"])
    scenes = scene_ids(n_scenes)
    pools = _goal_pools(rng, n_scenes)
    used = [0] * n_scenes
    lo, hi = (int(x) for x in params["instruction_tokens"])
    out: List[Dict] = []
    for k in range(int(params["paths"])):
        s = int(rng.integers(n_scenes))
        gx, gz = pools[s][used[s]]
        used[s] += 1
        while True:
            sx, sz = float(rng.choice(LATTICE)), float(rng.choice(LATTICE))
            if math.hypot(sx - gx, sz - gz) >= 4.0:
                break
        for i in range(int(params["instructions_per_path"])):
            n = int(rng.integers(lo, hi + 1))
            out.append({"id": f"{k}_{i}", "scene": scenes[s], "start": [sx, 0.0, sz], "goal": [gx, 0.0, gz],
                        "heading": float(rng.uniform(0.0, 2.0 * math.pi)),
                        "tokens": [int(t) for t in rng.integers(2, vocab, size=n)]})
    return out


def rotation(heading: float) -> List[float]:
    """A heading as the dataset's start rotation: a quaternion [x, y, z, w]
    about the up axis."""
    return [0.0, math.sin(heading / 2.0), 0.0, math.cos(heading / 2.0)]
