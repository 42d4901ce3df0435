"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and compiles on its own into
`vlnce_torch/build/lib<name>-<digest>.so` (the directory is git-ignored),
where the digest covers the source, the headers (`csrc/*.cuh`) and the
flags, so an edited source is rebuilt and an unchanged one is reused.
Nothing here runs at import: a wrapper calls `load(name)` at its first launch
on a CUDA tensor, and `build()` compiles several kernels at once, one nvcc
process each, started together. The compiler's report (`-Xptxas -v`: registers, shared memory,
spills) is kept beside each library as `.log`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable

import torch

KERNELS = ("gru_sequence", "resize_normalize", "goal_field")

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def loaded() -> Dict[str, ctypes.CDLL]:
    """The kernels loaded into this process so far, by name."""
    return dict(_loaded)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidate = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else shutil.which("nvcc")
    if not candidate or not os.path.exists(candidate):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH to build the kernels")
    return candidate


def library_path(name: str) -> str:
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for filename in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC_DIR, filename), "rb") as f:
            digest.update(f.read())
    digest = digest.hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile the named kernels that are not built yet, all nvcc processes
    at once. Returns the seconds each build took (0.0 for one already
    built); raises with the compiler's output if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = None
    procs = {}
    seconds = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            seconds[name] = 0.0
            continue
        nvcc = nvcc or _nvcc()
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp, out, time.perf_counter())
    failures = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        with open(out[: -len(".so")] + ".log", "wb") as f:
            f.write(log)
        if proc.returncode != 0:
            failures.append(f"{name}:\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return seconds


def build_log(name: str) -> str:
    path = library_path(name)[: -len(".so")] + ".log"
    with open(path, "r", errors="replace") as f:
        return f.read()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if it is not yet."""
    if name not in _loaded:
        path = library_path(name)
        if not os.path.exists(path):
            build([name])
        _loaded[name] = ctypes.CDLL(path)
    return _loaded[name]


def call_on_stream(fn, device, *args) -> int:
    """fn(*args, stream) with `device` current and its current stream (the
    capture stream inside `torch.cuda.graph`); returns fn's CUDA error code.
    The device guard is skipped where `device` is current already: it is
    host work on every launch of a host-bound step."""
    if torch.cuda.current_device() == device.index:
        return fn(*args, torch.cuda.current_stream().cuda_stream)
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream().cuda_stream)


def check(name: str, status: int) -> None:
    """Raise if a C entry returned a CUDA error code (cudaGetLastError)."""
    if status != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {status}")
