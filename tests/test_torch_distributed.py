"""The port's process group and rank helpers (vlnce_torch/parallel/
{distributed,mesh}.py) against the JAX package's
(vlnce_tpu/parallel/{distributed,mesh}.py): the no-op single host, a real
two-process gloo rendezvous on localhost (from torchrun's variables and
from SLURM's), rank_slice, the mesh resolution, the gradient all_reduce's
flat layout, and the aligned step's key."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vlnce_torch.config import get_config
from vlnce_torch.parallel import distributed, mesh
from vlnce_torch.parallel.mp_smoke import _free_port
from vlnce_tpu.parallel.distributed import rank_slice as jax_rank_slice

from tests.torch_port_cases import EqualRanks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_single_host_is_noop(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "SLURM_PROCID", "SLURM_NTASKS"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.init_distributed() is False
    assert distributed.world_size() == 1 and distributed.world_rank() == 0


def test_explicit_single_process_is_noop():
    assert distributed.init_distributed("tcp://localhost:9999", world_size=1, rank=0) is False
    assert not torch.distributed.is_initialized()


WORKER = r"""
import sys
sys.path.insert(0, {repo!r})
import torch
from vlnce_torch.parallel import distributed
from vlnce_torch.parallel.mesh import DataMesh
assert distributed.init_distributed(), "expected a process group"
rank, n = distributed.world_rank(), distributed.world_size()
assert n == 2
distributed.sync_ranks("start")
m = DataMesh(n, rank, torch.device("cpu"))
x = m.all_reduce(torch.tensor([float(rank + 1)]))
y = m.all_reduce(torch.tensor([rank * 10]), op="max")
z = m.broadcast(torch.tensor([rank + 5.0]))
assert x.item() == 3.0 and y.item() == 10 and z.item() == 5.0, (x, y, z)
distributed.sync_ranks("end")
print("DISTRIBUTED_OK", rank, flush=True)
"""


@pytest.mark.parametrize("launcher", ["torchrun", "slurm"])
def test_two_process_rendezvous(tmp_path, launcher):
    port = _free_port()
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(repo=REPO))
    procs = []
    for rank in range(2):
        env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "SLURM_PROCID", "SLURM_NTASKS")}
        if launcher == "torchrun":
            env.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                       MASTER_PORT=str(port))
        else:
            env.update(SLURM_PROCID=str(rank), SLURM_NTASKS="2", SLURM_LOCALID=str(rank), MASTER_PORT=str(port))
        env["OMP_NUM_THREADS"] = "1"
        procs.append(subprocess.Popen([sys.executable, str(script)], env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT))
    outs = []
    try:
        outs = [p.communicate(timeout=60)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
        assert f"DISTRIBUTED_OK {rank}" in out


def test_rank_slice_equals_jax():
    for length in range(0, 12):
        items = [f"ep{i}" for i in range(length)]
        for nproc in range(1, 6):
            slices = []
            for rank in range(nproc):
                ours = distributed.rank_slice(items, rank=rank, nproc=nproc)
                assert ours == jax_rank_slice(items, rank=rank, nproc=nproc), (length, nproc, rank)
                slices.append(ours)
            assert len({len(s) for s in slices}) == 1  # equal counts on every rank
            assert set().union(*map(set, slices)) == set(items)  # the plan is covered
    assert distributed.rank_slice(range(5)) == list(range(5))  # one process: identity


def test_resolve_training_mesh_fails_loudly():
    """The counterpart of test_multichip_parity's: a width the process group
    does not have raises; 1 and auto at world size 1 are None."""
    with pytest.raises(RuntimeError, match="requires 2 ranks"):
        mesh.resolve_training_mesh(get_config(opts=["CUDA.MESH.DATA", 2, "CUDA.DEVICE", "cpu"]))
    assert mesh.resolve_training_mesh(get_config(opts=["CUDA.MESH.DATA", 1, "CUDA.DEVICE", "cpu"])) is None
    assert mesh.resolve_training_mesh(get_config(opts=["CUDA.MESH.DATA", -1, "CUDA.DEVICE", "cpu"])) is None
    assert mesh.resolve_training_mesh(get_config(opts=["CUDA.MESH.DATA", 0, "CUDA.DEVICE", "cpu"])) is None
    with pytest.raises(ValueError, match="no model axis"):
        mesh.resolve_training_mesh(get_config(opts=["CUDA.MESH.MODEL", 2, "CUDA.DEVICE", "cpu"]))


@pytest.mark.parametrize("with_missing_grad", [False, True])
def test_all_reduce_grads_sums_in_place_over_one_flat_buffer(with_missing_grad):
    """Every gradient summed in place (the flat buffer's offsets and views
    right for tensors of several shapes); a parameter with no gradient on
    this rank counts as zeros."""
    rng = np.random.RandomState(0)
    params = [torch.nn.Parameter(torch.from_numpy(rng.rand(*s).astype(np.float32))) for s in [(3, 4), (5,), (2, 1, 3)]]
    grads = [torch.from_numpy(rng.rand(*p.shape).astype(np.float32)) for p in params]
    for p, g in zip(params, grads):
        p.grad = g.clone()
    if with_missing_grad:
        params[1].grad = None
    kept = [p.grad for p in params]
    EqualRanks(3, 0, torch.device("cpu")).all_reduce_grads(params)
    for i, (p, g) in enumerate(zip(params, grads)):
        want = torch.zeros_like(g) if with_missing_grad and i == 1 else 3 * g
        torch.testing.assert_close(p.grad, want, rtol=0, atol=0)
        assert kept[i] is None or p.grad is kept[i]  # in place
    assert mesh.DataMesh(2, 0, torch.device("cpu")).shape == {mesh.DATA_AXIS: 2, mesh.MODEL_AXIS: 1}


def test_aligned_step_key_holds_the_tree_structure(monkeypatch):
    x = torch.zeros(2, 3)
    sig = distributed._signature
    assert sig(({"a": x},)) != sig(({"b": x},))  # same leaves, other dict keys
    assert sig(((x, x),)) != sig(([x, x],))  # same leaves, other nesting
    assert sig((x, 1.0)) == sig((torch.ones(2, 3), 2.0))  # values do not matter, shapes and types do
    assert sig((x,)) != sig((torch.zeros(2, 3, dtype=torch.float64),))

    def fn(*args):
        return len(args)

    assert distributed.align_collective_step(fn, "t") is fn  # one process: unchanged
    barriers = []
    monkeypatch.setattr(distributed, "sync_ranks", lambda tag: barriers.append(tag))
    aligned = distributed._AlignedStep(fn, "step")
    aligned({"a": x}), aligned({"a": torch.ones(2, 3)}), aligned({"b": x}), aligned({"a": x})
    assert barriers == ["step/1", "step/2"]  # one barrier per new signature, before its first call
    assert np.isclose(aligned(x, x), 2)


class _Clock:
    def mark(self, name):
        pass


def test_aligned_step_key_holds_no_address_or_value():
    """A callable leaf (a bound `StepClock.mark`, a closure) keys by its type,
    so ranks whose objects lie at other addresses still meet at the same
    barriers; a string keys by its value, None as None."""
    x = torch.zeros(2, 3)
    sig = distributed._signature
    assert sig((x, _Clock().mark)) == sig((x, _Clock().mark))  # two objects, two addresses
    assert sig((x, lambda n: None)) == sig((x, lambda n: n))
    assert "0x" not in repr(sig((x, _Clock().mark, object())))
    assert sig((x, _Clock().mark)) != sig((x, 1))
    assert sig((x, "a")) != sig((x, "b")) and sig((x, None)) != sig((x, "None"))

