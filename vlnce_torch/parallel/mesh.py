"""The data-parallel layout of training (port of vlnce_tpu/parallel/mesh.py).

The JAX package lays its data axis over a device mesh: one process may own
several chips, and gradients are psum'd inside shard_map. The port runs one
process per card in a `torch.distributed` process group
(`parallel/distributed.py`): the data axis is the world size, each rank holds
a full replica on its own card, losses are local sums over global counts and
gradients are summed with `all_reduce`. A one-process mesh over several
devices has no counterpart, and there is no model axis (`CUDA.MESH.MODEL`
must be 1, as every JAX config keeps it).

So a `DataMesh` always spans processes. The JAX package's
`shrink_mesh_for_batch` and `resident_mesh_for_batch`, which shard a scan or
a resident pipeline over the devices of one process, return None under
several processes, so they have no counterpart: each rank collects, renders
or evaluates its own slice on its own card and meets the others at the
train step's all_reduce.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from vlnce_torch.parallel.distributed import world_rank, world_size

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class DataMesh:
    """The data axis: `size` ranks of the process group `group` (None: the
    default group), this process being `rank`, on `device`."""

    size: int
    rank: int
    device: torch.device
    group: Optional[object] = None

    @property
    def shape(self):
        return {DATA_AXIS: self.size, MODEL_AXIS: 1}

    def all_reduce(self, tensor: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """In-place all_reduce over the data axis (op "sum" or "max");
        returns the tensor."""
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX, group=self.group)
        return tensor

    def broadcast(self, tensor: torch.Tensor, src: int = 0) -> torch.Tensor:
        dist.broadcast(tensor, src, group=self.group)
        return tensor

    def all_reduce_grads(self, parameters: Sequence[torch.nn.Parameter]) -> None:
        """Sum the gradients of `parameters` over the ranks, in place, with
        one all_reduce over a flat buffer (a parameter with no gradient on
        this rank counts as zeros, so every rank sends the same layout)."""
        grads = []
        for p in parameters:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        if not grads:
            return
        flat = self.all_reduce(torch.cat([g.reshape(-1) for g in grads]))
        offset = 0
        for g in grads:
            g.copy_(flat[offset : offset + g.numel()].view_as(g))
            offset += g.numel()


def resolve_training_mesh(config) -> Optional[DataMesh]:
    """The data axis for training, per CUDA.MESH.DATA:

    - 0 or 1: one process trains alone (None);
    - -1 (auto): every rank of the process group; None at world size 1;
    - k > 1: exactly k ranks. RAISES when the process group does not have
      k ranks: a config that asks for k-way data parallelism must not run
      on another width.
    """
    data = int(config.CUDA.MESH.DATA)
    model = int(config.CUDA.MESH.MODEL)
    if model != 1:
        raise ValueError(f"CUDA.MESH.MODEL={model}: the port has no model axis (one full replica per rank); set it to 1")
    n = world_size()
    if data in (0, 1):
        return None
    if data == -1:
        if n <= 1:
            return None
    elif data != n:
        raise RuntimeError(
            f"CUDA.MESH.DATA={data} requires {data} ranks but the process group has {n}; launch with "
            f"torchrun --nproc_per_node {data} (or {data} SLURM tasks), or set CUDA.MESH.DATA=-1 for auto or 1 "
            f"to train on one process"
        )
    return DataMesh(size=n, rank=world_rank(), device=torch.device(config.CUDA.DEVICE))
