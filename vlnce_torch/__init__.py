"""vlnce_torch: the PyTorch + CUDA port of vlnce_tpu for NVIDIA Hopper.

It sits beside the JAX package, imports nothing of it, and is held against it
by the tests (tests/test_torch_*.py) on the same inputs and carried-across
weights. Plain tensor code is PyTorch; each of the JAX package's Pallas
kernels is a CUDA kernel written for sm_90a under `csrc/`, built by nvcc at
its first launch (`ops/_build.py`) and bound with ctypes. On CPU tensors every
kernel wrapper runs its plain PyTorch version instead.

Ported so far: the CMA, Seq2Seq and waypoint policies, and `python -m
vlnce_torch.run --run-type {train,eval,inference}` over the host env layer
(`envs/`, `tasks/`: the procedural GridWorld simulator, datasets, sensors,
measures, forked vector envs) with checkpoints from `utils.checkpoints`: eval
and inference (`trainers.base_trainer`), DAgger (`trainers.dagger_trainer`),
the recollect trainer (`trainers.recollect_trainer`) and DD-PPO of the
waypoint policy on one card (`trainers.ddppo_waypoint_trainer`, `rl/`).
ROADMAP.md lists what is not ported yet.
"""

__version__ = "0.1.0"

from vlnce_torch.registry import registry  # noqa: F401
from vlnce_torch.ops import obs_transforms  # noqa: F401  (registry population)
from vlnce_torch.models.cma_policy import CMAPolicy  # noqa: F401
