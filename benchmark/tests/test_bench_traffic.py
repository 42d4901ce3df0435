"""The traffic: one seed gives the same episodes and bank every time; two
seeds give the same amount of work (grid, scenes, new goals per chunk,
step cap, lengths, bank size) and differ only in content."""

import json
import os

import numpy as np
import torch

from benchmark import generate
from benchmark.reference import grid

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _traffic(name):
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)


def _stream(seed, chunks=24):
    return generate.scan_stream({**_traffic("scan_rollout"), "chunk": 64}, seed, chunks)


def _new_goals(stream):
    seen, per_chunk = set(), []
    for chunk in stream["chunks"]:
        fresh = {(e["scene"], round(e["goal"][0] / grid.RES), round(e["goal"][2] / grid.RES)) for e in chunk} - seen
        per_chunk.append(len(fresh))
        seen |= fresh
    return per_chunk


def test_same_seed_same_episodes():
    a, b = _stream(2**31 + 5), _stream(2**31 + 5)
    assert a["chunks"] == b["chunks"] and a["warmup"] == b["warmup"]
    assert all(np.array_equal(a["features"][k], b["features"][k]) for k in a["features"])


def test_two_seeds_same_work():
    a, b = _stream(3_000_000_001), _stream(17)
    assert a["chunks"] != b["chunks"]
    assert _new_goals(a) == _new_goals(b)  # 22, 21, 21, ... for every seed
    assert set(_new_goals(a)) == {21, 22}
    for s in (a, b):
        assert {e["scene"] for c in s["chunks"] for e in c} <= set(generate.scene_ids(24))
        assert sorted(len(f) for f in s["features"].values()) == sorted(_traffic("scan_rollout")["instruction_lengths"])


def test_goals_never_repeat_and_are_free():
    s = _stream(99, chunks=400)
    goals = [(e["scene"], e["goal"][0], e["goal"][2]) for c in s["chunks"] for e in c[::1]]
    paths = goals[::3]
    assert len(set(paths)) == len(paths)
    warm = {(e["scene"], e["goal"][0], e["goal"][2]) for e in s["warmup"]}
    assert not warm & set(paths)
    assert {e["scene"] for e in s["warmup"]} == set(generate.scene_ids(24))
    occ = {sid: grid.scene(sid)["occupancy"] for sid in generate.scene_ids(24)}
    for sid, x, z in paths + list(warm):
        assert not occ[sid][int(x / grid.RES), int(z / grid.RES)]
    for e in (e for c in s["chunks"] for e in c):
        assert not occ[e["scene"]][int(e["start"][0] / grid.RES), int(e["start"][2] / grid.RES)]


def _bank(seed):
    params = {**_traffic("dagger_train"), "length_histogram": [[3, 4], [20, 3], [33, 2]]}
    shapes = {"rgb_features": (8, 2, 2), "depth_features": (4, 2, 2), "progress": (1,)}
    return generate.bank(params, seed, "cpu", shapes, vocab=50, max_tokens=12)


def test_bank_same_seed_same_rows_and_fixed_sizes():
    a, b, c = _bank(2**32 + 1), _bank(2**32 + 1), _bank(5)
    for k in a["data"]:
        assert torch.equal(a["data"][k], b["data"][k])
    assert torch.equal(a["oracle"], b["oracle"]) and torch.equal(a["instruction"], b["instruction"])
    assert not torch.equal(a["data"]["rgb_features"], c["data"]["rgb_features"])
    assert np.array_equal(a["lengths"], c["lengths"]) and a["trash"] == c["trash"] == 12 + 60 + 66
    assert torch.equal((a["instruction"] != 0).sum(1), (c["instruction"] != 0).sum(1))
    for r in (a, c):  # the padding row, and every episode ends in STOP
        assert float(r["data"]["rgb_features"][r["trash"]].min()) == 1.0
        ends = r["offsets"] + r["lengths"] - 1
        assert (r["oracle"][torch.from_numpy(ends)] == 0).all()


def test_published_histogram():
    t = _traffic("dagger_train")
    lengths = generate.bank_lengths(t)
    assert len(lengths) == 5000 and abs(lengths.mean() - 55.88) < 0.5
    assert np.array_equal(lengths, generate.bank_lengths(t))
