"""Geodesic distance fields on occupancy grids: the CUDA kernel
(csrc/goal_field.cu) and its plain PyTorch version.

Replaces no TPU kernel: the JAX package builds each goal's field on the host
(BaseScene._dijkstra, a Python Dijkstra), as the port's host simulators still
do. The closed loops on the card build a chunk's distinct goal fields here
instead, in one launch (envs/device_sim.scene_batch).

A field is the host's 8-connected geodesic distance from a free goal cell,
in f64: 0 at the goal, +inf where blocked or unreachable, `step` to an
orthogonal neighbour and sqrt(2) * `step` to a diagonal one (the host's own
f64 constants), no move into a blocked cell or off the grid, no diagonal past
a blocked orthogonal neighbour. Both versions relax the field until a whole
sweep changes nothing: with positive steps and monotone rounding the fixed
point is unique and is the one the host's Dijkstra reaches, so both equal the
host's field bit for bit. The kernel sweeps in place, cell by cell; the plain
version updates every cell at once per move direction.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from vlnce_torch.ops import _build

# the host's moves (BaseScene._dijkstra), as the neighbour (i + di, j + dj) a step arrives from
_MOVES = ((1, 0), (-1, 0), (0, 1), (0, -1), (1, 1), (1, -1), (-1, 1), (-1, -1))
_SMEM_PER_BLOCK = 227 * 1024  # the most dynamic shared memory an sm_90 block can have


def _spans(delta: int, n: int):
    """(target, source) slices of one axis for the move from i + delta to i."""
    return slice(max(0, -delta), n - max(0, delta)), slice(max(0, delta), n + min(0, delta))


def _shifted(free: torch.Tensor, di: int, dj: int) -> torch.Tensor:
    """out[:, i, j] = free[:, i + di, j + dj], False off the grid."""
    n = free.shape[-1]
    (ti, si), (tj, sj) = _spans(di, n), _spans(dj, n)
    out = torch.zeros_like(free)
    out[:, ti, tj] = free[:, si, sj]
    return out


def _check_inputs(occupancy: torch.Tensor, cells: torch.Tensor) -> None:
    if occupancy.dim() != 3 or occupancy.shape[1] != occupancy.shape[2] or occupancy.dtype != torch.bool:
        raise ValueError(f"goal_distance_fields: occupancy must be bool [R, n, n], got {occupancy.dtype} "
                         f"{tuple(occupancy.shape)}")
    if cells.dim() != 2 or cells.shape[1] != 3 or cells.dtype != torch.int32:
        raise ValueError(f"goal_distance_fields: cells must be int32 [F, 3], got {cells.dtype} {tuple(cells.shape)}")
    if cells.device != occupancy.device:
        raise ValueError(f"goal_distance_fields: cells on {cells.device}, occupancy on {occupancy.device}")


def goal_distance_fields_plain(occupancy: torch.Tensor, cells: torch.Tensor, step: float) -> torch.Tensor:
    """occupancy bool [R, n, n] (True = blocked); cells int32 [F, 3], each (row
    of occupancy, goal i, goal j) with the goal cell free -> f64 [F, n, n]."""
    _check_inputs(occupancy, cells)
    F, n = cells.shape[0], occupancy.shape[-1]
    rows, gi, gj = (cells[:, k].long() for k in range(3))
    free = ~occupancy[rows]
    diag = math.sqrt(2.0) * step
    # cost[k][:, i, j]: the move into (i, j) from its neighbour k, +inf where the host forbids it
    costs = []
    for di, dj in _MOVES:
        allowed = free & _shifted(free, di, dj)
        if di and dj:
            allowed &= _shifted(free, 0, dj) & _shifted(free, di, 0)
        cost = torch.full((F, n, n), math.inf, dtype=torch.float64, device=free.device)
        costs.append(cost.masked_fill_(allowed, diag if di and dj else step))
    d = torch.full((F, n, n), math.inf, dtype=torch.float64, device=free.device)
    d[torch.arange(F, device=free.device), gi, gj] = 0.0
    while True:
        before = d.clone()
        for (di, dj), cost in zip(_MOVES, costs):
            (ti, si), (tj, sj) = _spans(di, n), _spans(dj, n)
            target = d[:, ti, tj]
            torch.minimum(target, d[:, si, sj] + cost[:, ti, tj], out=target)
        if torch.equal(d, before):
            return d


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("goal_field").goal_distance_fields
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_double] * 2 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def shared_bytes(n: int) -> int:
    """The shared memory a block of the kernel takes for an [n, n] grid: the
    f64 field and a byte of moves per cell; 0 where that is more than a block
    can have, and the kernel keeps them in device memory."""
    need = 9 * n * n
    return need if need <= _SMEM_PER_BLOCK else 0


def _launch(occupancy: torch.Tensor, cells: torch.Tensor, step: float) -> torch.Tensor:
    _check_inputs(occupancy, cells)
    if not (occupancy.is_contiguous() and cells.is_contiguous()):
        raise ValueError("goal_distance_fields: occupancy and cells must be contiguous")
    F, n = cells.shape[0], occupancy.shape[-1]
    out = torch.empty((F, n, n), dtype=torch.float64, device=occupancy.device)
    if F == 0:
        return out
    smem = shared_bytes(n)
    scratch = None if smem else torch.empty((F, n, n), dtype=torch.uint8, device=occupancy.device)
    status = _build.call_on_stream(
        _kernel(), occupancy.device, occupancy.data_ptr(), cells.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), F, n, float(step), math.sqrt(2.0) * float(step), smem,
    )
    _build.check("goal_field", status)
    goal_distance_fields.launches += 1
    goal_distance_fields.fields += F
    return out


def goal_distance_fields(occupancy: torch.Tensor, cells: torch.Tensor, step: float) -> torch.Tensor:
    """`goal_distance_fields_plain` for tensors on the CPU; on CUDA tensors
    one launch of the kernel, a block per field. occupancy: contiguous bool
    [R, n, n]; cells: contiguous int32 [F, 3] whose rows and goal cells are in
    range and whose goal cells are free (not checked: that would read them
    back). Nothing synchronises with the host. `calls` counts the calls on
    either route; `launches` the kernel's launches and `fields` the fields
    they built (none on the CPU, nor for F = 0)."""
    goal_distance_fields.calls += 1
    if occupancy.device.type == "cpu":
        return goal_distance_fields_plain(occupancy, cells, step)
    return _launch(occupancy, cells, step)


goal_distance_fields.calls = 0
goal_distance_fields.launches = 0
goal_distance_fields.fields = 0
