"""Process-group initialization and rank helpers (port of
vlnce_tpu/parallel/distributed.py; reference init_distrib_slurm,
ddppo_waypoint_trainer.py:310).

The JAX package joins `jax.distributed` (one process per host, the host's
chips forming its local devices). The port takes the PyTorch idiom instead:
one process per card in a `torch.distributed` process group, each rank on
its own card (`cuda:LOCAL_RANK`, wrapped over the cards present, so ranks
may share one card), gloo on the CPU and `RL.DDPPO.distrib_backend` (NCCL
by default) on the card. The rendezvous comes from torchrun's environment
(`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`), from
SLURM's (`SLURM_PROCID`, `SLURM_NTASKS`, `SLURM_LOCALID`, the reference's
convention), or from explicit arguments; a single process is a no-op.

The JAX module's compile leader (`VLNCE_COMPILE_LEADER`) has nothing to
share here: the kernels build once per checkout into `vlnce_torch/build/`,
and a CUDA graph belongs to the process that captured it.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

from vlnce_torch.utils.logging import logger

# the reference's DEFAULT_PORT of init_distrib_slurm
SLURM_DEFAULT_PORT = 8738

_STORE = None  # the process group's TCPStore; sync_ranks barriers on it
_BARRIER_SEQ = 0


def init_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    local_rank: Optional[int] = None,
    backend: str = "gloo",
    timeout_s: float = 1800.0,
) -> bool:
    """Join the process group from explicit arguments (`init_method`
    "tcp://host:port"), torchrun's or SLURM's environment. Returns True when
    a process group was initialized: under torchrun's variables always (a
    group of one rank included), from SLURM's or from explicit arguments
    only for more than one process; safe to call on a single host (no-op,
    False). On a machine with cards, it makes the rank's card (LOCAL_RANK
    modulo the card count) the current device. A first all_reduce of one
    element checks the group, so a broken rendezvous fails here."""
    if dist.is_available() and dist.is_initialized():
        return True
    env = os.environ
    launched = False
    if init_method is None:
        if "RANK" in env and "WORLD_SIZE" in env:  # torchrun, or its variables set by hand
            rank, world_size = int(env["RANK"]), int(env["WORLD_SIZE"])
            local_rank = int(env.get("LOCAL_RANK", rank))
            init_method = f"tcp://{env.get('MASTER_ADDR', 'localhost')}:{env.get('MASTER_PORT', '29500')}"
            launched = True
        elif "SLURM_PROCID" in env:  # the reference's init_distrib_slurm
            rank, world_size = int(env["SLURM_PROCID"]), int(env.get("SLURM_NTASKS", 1))
            local_rank = int(env.get("SLURM_LOCALID", 0))
            init_method = f"tcp://{env.get('MASTER_ADDR', '127.0.0.1')}:{env.get('MASTER_PORT', SLURM_DEFAULT_PORT)}"
        else:
            return False
    if world_size is None or (world_size == 1 and not launched):
        return False
    rank = int(rank or 0)
    local_rank = rank if local_rank is None else int(local_rank)
    if not init_method.startswith("tcp://"):
        raise ValueError(f"init_distributed: init_method must be tcp://host:port, got {init_method!r}")
    host, port = init_method[len("tcp://"):].rsplit(":", 1)
    if torch.cuda.is_available():
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    global _STORE
    # under torchrun's agent the store's server is the agent's (torch's env://
    # handler connects as a client in that case too)
    is_server = rank == 0 and env.get("TORCHELASTIC_USE_AGENT_STORE") != "True"
    _STORE = dist.TCPStore(host, int(port), world_size, is_server, timeout=timedelta(seconds=timeout_s))
    dist.init_process_group(backend.lower(), store=_STORE, rank=rank, world_size=world_size,
                            timeout=timedelta(seconds=timeout_s))
    device = f"cuda:{torch.cuda.current_device()}" if torch.cuda.is_available() else "cpu"
    probe = torch.ones(1, device=device if dist.get_backend() == "nccl" else "cpu")
    dist.all_reduce(probe)
    if int(probe.item()) != world_size:
        raise RuntimeError(f"init_distributed: a first all_reduce over {world_size} ranks gave {probe.item()}")
    logger.info(f"torch.distributed initialized: rank {rank}/{world_size} (local {local_rank}, {device}), "
                f"backend {dist.get_backend()}")
    return True


def world_rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank_slice(items, rank=None, nproc=None) -> list:
    """Per-rank strided data shard with wrap-padding so EVERY rank gets the
    same count (torch DistributedSampler semantics, reference
    ddppo_waypoint_trainer.py rank topology): unequal shards would give
    ranks different batch counts and deadlock the first collective the
    shorter rank never joins. Single-process: identity. Wrapped duplicates
    appear only when len(items) % nproc != 0."""
    items = list(items)
    if nproc is None:
        nproc = world_size()
    if nproc <= 1 or not items:
        return items
    if rank is None:
        rank = world_rank()
    per = -(-len(items) // nproc)
    return [items[(rank + i * nproc) % len(items)] for i in range(per)]


def sync_ranks(tag: str, timeout_s: float = 600.0) -> None:
    """Align all ranks at a named barrier on the process group's store (no
    device collective). Ranks reach sync points in the same order, so a
    per-process counter gives matching keys; a rank that diverges shows as a
    timeout naming the tag. Single process: no-op."""
    if world_size() <= 1:
        return
    global _BARRIER_SEQ
    _BARRIER_SEQ += 1
    key = f"vlnce/{os.environ.get('TORCHELASTIC_RESTART_COUNT', '0')}/{_BARRIER_SEQ}:{tag}"
    if _STORE is None:  # a group made elsewhere: its own barrier
        dist.barrier()
        return
    if _STORE.add(key, 1) == world_size():
        _STORE.set(f"{key}/done", "1")
    try:
        _STORE.wait([f"{key}/done"], timedelta(seconds=timeout_s))
    except RuntimeError as exc:
        raise RuntimeError(f"sync_ranks: rank {world_rank()} waited {timeout_s} s at barrier {key!r}: "
                           f"another rank never reached it") from exc


def _signature(args):
    """The key of one call: the tree structure (dict keys, nesting) and
    every leaf's shape and dtype (for a Python scalar or any other object,
    a callable included, its type: never a value or an address, which may
    differ between ranks)."""
    from torch.utils._pytree import tree_flatten

    leaves, spec = tree_flatten(args)

    def leaf_sig(x):
        if hasattr(x, "shape"):
            return (tuple(x.shape), str(getattr(x, "dtype", "?")))
        if x is None or isinstance(x, str):
            return repr(x)
        return ("py", type(x).__qualname__)

    return (str(spec), tuple(leaf_sig(x) for x in leaves))


class _AlignedStep:
    """A collective step whose first call with each new signature waits at a
    `sync_ranks` barrier first: a rank's first launch of a shape may follow
    its own nvcc build or CUDA-graph capture, which can skew ranks by
    seconds ahead of the step's first all_reduce."""

    def __init__(self, fn, tag: str):
        self._fn = fn
        self._tag = tag
        self._seen = set()

    def __call__(self, *args):
        key = _signature(args)
        if key not in self._seen:
            self._seen.add(key)
            sync_ranks(f"{self._tag}/{len(self._seen)}")
        return self._fn(*args)


def align_collective_step(fn, tag: str):
    """`fn` behind a barrier at its first call with each shape signature
    when several ranks run; unchanged on a single process."""
    if world_size() <= 1:
        return fn
    return _AlignedStep(fn, tag)
