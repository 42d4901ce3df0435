"""BENCHMARK.json against the benchmark's contract: its keys, names, units,
lines, the files it names, and the time a full check takes."""

import json
import os
import re

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = harness.benchmark_spec()


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert list(SPEC) == ["command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"]
    assert SPEC["paths"] == ["benchmark"] and len(SPEC["command"]) <= 32 and all(_line(w) for w in SPEC["command"])
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_entries_names_and_lines():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert _line(c["source"]) and _line(c["why"]) and c["file"].startswith("benchmark/configs/")
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        with open(os.path.join(harness.ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["source"] == c["source"] and set(c["reduced"]) == set(cfg["reduced"]) <= set(cfg["opts"])
    names = [c["name"] for c in SPEC["configs"]]
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in names and NAME.match(w["traffic"]) and w["chips"] in (1, 4) and _line(w["why"])
        assert os.path.exists(os.path.join(harness.BENCH_DIR, "traffic", f"{w['traffic']}.json"))
        assert os.path.exists(os.path.join(harness.BENCH_DIR, "limits", f"{w['name']}.json"))
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"} and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    layers = {}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"} and UNIT.match(m["unit"])
        assert NAME.match(m["name"]) and m["moves"] in e2e and _line(m["layer"]) and set(m["workloads"]) <= cells
        assert os.path.exists(os.path.join(harness.BENCH_DIR, "metrics", f"{m['name']}.py"))
        layers.setdefault(m["layer"], []).append(m["name"])
    all_names = names + list(cells) + list(e2e) + [m["name"] for m in SPEC["per_layer"]]
    assert len(set(names)) == len(names) and len({m["name"] for m in SPEC["per_layer"]}) == len(SPEC["per_layer"])
    assert len(all_names) >= 4


def test_a_full_check_fits():
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
