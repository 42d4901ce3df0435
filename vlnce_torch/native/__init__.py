"""The port's host-side native library: the shared-memory observation ring.

`obs_ring.cpp` is the port's own copy of the JAX package's ring (the same C
ABI). It compiles with g++ at its first use into
`vlnce_torch/build/libobsring-<digest>.so` (git-ignored), the digest covering
the source and the flags, as `ops/_build.py` does for the CUDA kernels.
Importing this module builds nothing; `load()` builds and loads, and raises
with the compiler's output when the build fails.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Optional

NATIVE_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(NATIVE_DIR, "obs_ring.cpp")
BUILD_DIR = os.path.join(os.path.dirname(NATIVE_DIR), "build")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")
LD_FLAGS = ("-lrt",)

_lib: Optional[ctypes.CDLL] = None


def library_path() -> str:
    digest = hashlib.sha256(" ".join(CXX_FLAGS + LD_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libobsring-{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the ring if it is not built yet; returns the library's path.
    Raises RuntimeError with g++'s output when the build fails."""
    out = library_path()
    if os.path.exists(out):
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the shared-memory observation ring needs a C++ compiler "
                           "(or set VLNCE_TORCH_SHM_OBS=0 to send observations through the pipes)")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, SOURCE, *LD_FLAGS, "-o", tmp], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {SOURCE} failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The ring library with its C signatures declared, built first if it is
    not yet."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    slots = ctypes.POINTER(ctypes.c_int64)
    lib.obs_ring_open.restype = ptr
    lib.obs_ring_open.argtypes = [ctypes.c_char_p, i64, i64, ctypes.c_int]
    lib.obs_ring_close.argtypes = [ptr, ctypes.c_char_p, ctypes.c_int]
    lib.obs_ring_write.argtypes = [ptr, i64, i64, ptr, i64, ctypes.c_uint64]
    lib.obs_ring_write_nopub.argtypes = [ptr, i64, i64, ptr, i64]
    lib.obs_ring_publish.argtypes = [ptr, i64, ctypes.c_uint64]
    lib.obs_ring_seq.restype = ctypes.c_uint64
    lib.obs_ring_seq.argtypes = [ptr, i64]
    lib.obs_ring_gather.argtypes = [ptr, slots, i64, i64, i64, ptr]
    lib.obs_ring_wait.restype = ctypes.c_int
    lib.obs_ring_wait.argtypes = [ptr, slots, i64, ctypes.c_uint64, i64]
    _lib = lib
    return lib
