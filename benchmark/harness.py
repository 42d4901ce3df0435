"""What every cell shares: finding a cell's files by name, the program's
configuration, the checks against their limits, the device's description
and the look for JAX in the process.

A cell is an entry of BENCHMARK.json's `workloads`. Its configuration is
`configs/<config>.json` (the YAML, the keys changed from it and why), its
traffic is `traffic/<traffic>.json` (a generator's `kind`, the `runner`
that runs the window, and their parameters), its limits are
`limits/<workload>.json`, and each per-layer metric is
`metrics/<metric>.py`. A later cell adds files; it edits none of these.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
CACHE_DIR = os.path.join(ROOT, ".bench_cache")  # git-ignored; fixed, so later runs hit
FORBIDDEN = ("jax", "jaxlib", "flax", "vlnce_tpu")


def set_environment() -> None:
    """Before torch is imported: every compile cache inside the checkout, at
    fixed paths (the port's nvcc builds go to vlnce_torch/build/ already),
    and one thread for the host's math libraries: the host work of both
    cells is one Python thread, and idle pool threads only take cores from
    it."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(CACHE_DIR, sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    os.environ.setdefault("USE_FLAX", "0")


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    workload: str
    config_name: str
    traffic_name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    # CPU tests only: extra program options and traffic parameters
    extra_opts: Dict = field(default_factory=dict)
    traffic_overrides: Dict = field(default_factory=dict)

    @property
    def params(self) -> Dict:
        return {**self.traffic, **self.traffic_overrides}


def benchmark_spec() -> Dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def load_cell(workload: str, seed: int, seconds: float, trace: bool, spec: Optional[Dict] = None) -> Cell:
    spec = spec or benchmark_spec()
    entry = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json ({[w['name'] for w in spec['workloads']]})")
    return Cell(
        workload=workload, config_name=entry["config"], traffic_name=entry["traffic"], chips=int(entry["chips"]),
        config=load_json(os.path.join(BENCH_DIR, "configs", f"{entry['config']}.json")),
        traffic=load_json(os.path.join(BENCH_DIR, "traffic", f"{entry['traffic']}.json")),
        limits=load_json(os.path.join(BENCH_DIR, "limits", f"{workload}.json")),
        seed=int(seed), seconds=float(seconds), trace=bool(trace),
    )


def program_config(cell: Cell, runtime: Dict):
    """The program's config: the YAML, the configuration file's keys, the
    run's own (seed, paths), then the tests' extra keys."""
    from vlnce_torch.config import get_config

    opts: List = []
    for k, v in {**cell.config["opts"], **runtime, **cell.extra_opts}.items():
        opts += [k, v]
    return get_config(os.path.join(ROOT, cell.config["yaml"]), opts)


def program_seed(seed: int) -> int:
    return int(seed) % (2**31)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def runner(cell: Cell):
    return load_module(os.path.join(BENCH_DIR, "runners", f"{cell.traffic['runner']}.py"), f"bench_runner_{cell.traffic['runner']}")


def metric_reader(name: str):
    return load_module(os.path.join(BENCH_DIR, "metrics", f"{name}.py"), "bench_metric_" + name.replace(".", "_"))


def checks(values: Dict[str, float], limits: Dict) -> Dict[str, Dict[str, float]]:
    """Each compared number beside its limit, in the limits file's order."""
    out = {}
    for name, lim in limits["checks"].items():
        out[name] = {"value": float(values[name]), "limit": float(lim["limit"])}
    return out


def passed(compared: Dict[str, Dict[str, float]]) -> bool:
    return all(c["value"] == c["value"] and c["value"] <= c["limit"] for c in compared.values())


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def device_description(chips: int) -> Dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": int(chips),
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i) for i in range(chips)))}


def power_limit() -> str:
    """The card's name and power limit, from nvidia-smi ("" where it fails)."""
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""
