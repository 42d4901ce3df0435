"""vlnce_torch: the PyTorch + CUDA port of vlnce_tpu for NVIDIA Hopper.

It sits beside the JAX package, imports nothing of it, and is held against it
by the tests (tests/test_torch_*.py) on the same inputs and carried-across
weights. Plain tensor code is PyTorch; each of the JAX package's Pallas
kernels is a CUDA kernel written for sm_90a under `csrc/`, built by nvcc at
its first launch (`ops/_build.py`) and bound with ctypes. On CPU tensors every
kernel wrapper runs its plain PyTorch version instead.

Ported so far: the serving path of the RxR CMA policy. `python -m
vlnce_torch.run --run-type {eval,inference}` drives `trainers.base_trainer`'s
eval and inference loops over the host env layer (`envs/`, `tasks/`: the
procedural GridWorld simulator, datasets, sensors, measures, forked vector
envs), with checkpoints from `utils.checkpoints`, around the act step (obs
transforms, CMAPolicy, `trainers.base_trainer.make_fused_act_step`). Training
is not ported yet.
"""

__version__ = "0.1.0"

from vlnce_torch.registry import registry  # noqa: F401
from vlnce_torch.ops import obs_transforms  # noqa: F401  (registry population)
from vlnce_torch.models.cma_policy import CMAPolicy  # noqa: F401
