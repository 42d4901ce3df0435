"""The traffic generators. A mix is a data file under `traffic/` whose
`kind` names one of the generators here and whose other keys are its
parameters; the seed sets the content only. Every seed gets the same
sizes, lengths, scenes and numbers of new goals per chunk, in another
order, so the work of a window does not depend on the seed.

- `scan_stream`: closed-loop episodes on procedural scenes, in chunks.
  Paths of `instructions_per_path` episodes, consecutive in the stream (a
  path's start and goal, told by several instructions, as R2R and RxR
  annotate them); every path has a goal cell no other path of the stream
  has, so each chunk asks the simulator for the same number of new goal
  fields. Instruction features are files in the RxR layout.
- `bank`: DAgger's trajectory bank on the device: episode lengths from a
  fixed histogram, features, oracle actions and instructions drawn from
  the seed in a few large calls.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List

import numpy as np
import torch

LATTICE = tuple(range(1, 16, 2))  # the free 2 m lattice of a procedural scene (metres)
CELL = 0.25


def scene_ids(n: int) -> List[str]:
    return [f"bench_scene_{i}" for i in range(n)]


def _goal_pools(rng: np.random.Generator, n_scenes: int) -> List[List[tuple]]:
    """Per scene, every goal cell of the lattice and its 8 neighbours (the
    corridors are 3 cells wide), in a seeded order."""
    pools = []
    for _ in range(n_scenes):
        cells = [(x + dx * CELL, z + dz * CELL) for x in LATTICE for z in LATTICE for dx in (-1, 0, 1) for dz in (-1, 0, 1)]
        order = rng.permutation(len(cells))
        pools.append([cells[i] for i in order])
    return pools


def scan_stream(params: Dict, seed: int, chunks: int) -> Dict:
    """{"warmup": [episode], "chunks": [[episode] * chunk] * chunks,
    "features": {instruction id: [n, D] f32 features}}. An episode is a dict: id, scene, start [x, 0,
    z], heading, goal [x, 0, z], instruction (an id from 1). The warm-up
    chunk visits every scene with goals no chunk uses."""
    rng = np.random.default_rng(seed)
    n_scenes = int(params["scenes"])
    per_path = int(params["instructions_per_path"])
    B = int(params["chunk"])
    n_files = len(params["instruction_lengths"])
    scenes = scene_ids(n_scenes)
    pools = _goal_pools(rng, n_scenes)
    used = [0] * n_scenes

    def path(scene_index: int) -> Dict:
        gx, gz = pools[scene_index][used[scene_index]]
        used[scene_index] += 1
        while True:
            sx, sz = float(rng.choice(LATTICE)), float(rng.choice(LATTICE))
            if math.hypot(sx - gx, sz - gz) >= 4.0:
                break
        return {"scene": scenes[scene_index], "start": [sx, 0.0, sz], "goal": [gx, 0.0, gz],
                "heading": float(rng.uniform(0.0, 2.0 * math.pi))}

    def episode(p: Dict, k: int) -> Dict:
        # feature files are numbered from 1: the sensor reads an id of 0 as none
        return {**p, "id": str(k), "instruction": 1 + int(rng.integers(n_files))}

    warmup = [episode(path(i % n_scenes), 10**7 + i) for i in range(B)]
    stream, k = [], 0
    while len(stream) < chunks * B:
        p = path(int(rng.integers(n_scenes)))
        for _ in range(per_path):
            stream.append(episode(p, k))
            k += 1
    stream = stream[: chunks * B]
    lengths = [int(n) for n in params["instruction_lengths"]]
    features, lo = {}, 0
    flat = rng.standard_normal((sum(lengths), int(params["feature_dim"])), dtype=np.float32) * float(params["feature_scale"])
    for i, n in enumerate(lengths):
        features[i + 1] = flat[lo : lo + n]
        lo += n
    return {"warmup": warmup, "chunks": [stream[c * B : (c + 1) * B] for c in range(chunks)], "features": features}


def write_features(features: Dict[int, np.ndarray], directory: str) -> str:
    """The features as RxR's per-instruction archives (`features` [n, D]);
    returns the path pattern for RXR_INSTRUCTION_SENSOR.features_path."""
    os.makedirs(directory, exist_ok=True)
    for i, f in features.items():
        np.savez(os.path.join(directory, f"{i}.npz"), features=f)
    return os.path.join(directory, "{id}.npz")


# ------------------------------------------------------------------ bank
def bank_lengths(params: Dict) -> np.ndarray:
    """The episodes' lengths: the histogram expanded, then one fixed
    permutation (the same for every seed)."""
    hist = params["length_histogram"]
    lengths = np.concatenate([np.full(int(c), int(n), np.int64) for n, c in hist])
    return lengths[np.random.default_rng(0).permutation(len(lengths))]


def bank_instruction_lengths(params: Dict, n: int) -> np.ndarray:
    lo, hi = params["instruction_tokens"]
    return np.random.default_rng(1).integers(int(lo), int(hi) + 1, size=n)


def bank(params: Dict, seed: int, device, feat_shapes: Dict[str, tuple], vocab: int, max_tokens: int) -> Dict:
    """The bank's rows on `device`: {"data": {key: [S + 1, F]}, "prev",
    "oracle" [S + 1] int32, "instruction" [E, max_tokens] int32, "offsets",
    "lengths" (numpy), "trash": S}. Row S is the padding row (1.0 in every
    feature, 0 in the actions). Features are in [0, 2) as the encoders'
    ReLU outputs are, stored in `params["feature_dtype"]`; the oracle
    walks forward 60% of the time and turns 40%, and stops at its last step;
    the previous action is the oracle's last."""
    lengths = bank_lengths(params)
    E, S = len(lengths), int(lengths.sum())
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
    g = torch.Generator(device=device).manual_seed(int(seed))
    store = {"float16": torch.float16, "float32": torch.float32}[params["feature_dtype"]]
    data = {}
    for key, shape in feat_shapes.items():
        if key == "progress":
            continue
        t = torch.rand((S + 1, int(np.prod(shape))), generator=g, device=device, dtype=store).mul_(2)
        t[S] = 1.0
        data[key] = t
    len_d = torch.from_numpy(lengths).to(device)
    off_d = torch.from_numpy(offsets).to(device)
    episode = torch.repeat_interleave(torch.arange(E, device=device), len_d)
    t_in = torch.arange(S, device=device) - off_d[episode]
    progress = torch.ones(S + 1, 1, device=device)
    progress[:S, 0] = (t_in + 1).float() / len_d[episode].float()
    data["progress"] = progress
    u = torch.rand(S, generator=g, device=device)
    oracle = torch.where(u < 0.6, 1, torch.where(u < 0.8, 2, 3)).to(torch.int32)
    oracle = torch.where(t_in == len_d[episode] - 1, 0, oracle)
    prev = torch.cat([oracle.new_zeros(1), oracle[:-1]])
    prev = torch.where(t_in == 0, 0, prev)
    pad = torch.zeros(1, dtype=torch.int32, device=device)
    tokens = torch.randint(2, vocab, (E, max_tokens), generator=g, device=device, dtype=torch.int32)
    n_tok = torch.from_numpy(bank_instruction_lengths(params, E)).to(device)
    tokens = torch.where(torch.arange(max_tokens, device=device)[None, :] < n_tok[:, None], tokens, 0)
    return {"data": data, "prev": torch.cat([prev, pad]), "oracle": torch.cat([oracle, pad]), "instruction": tokens,
            "offsets": offsets, "lengths": lengths, "trash": S}
