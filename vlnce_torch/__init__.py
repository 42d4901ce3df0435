"""vlnce_torch: the PyTorch + CUDA port of vlnce_tpu for NVIDIA Hopper.

It sits beside the JAX package, imports nothing of it, and is held against it
by the tests (tests/test_torch_*.py) on the same inputs and carried-across
weights. Plain tensor code is PyTorch; each of the JAX package's Pallas
kernels is a CUDA kernel written for sm_90a under `csrc/`, built by nvcc at
its first launch (`ops/_build.py`) and bound with ctypes. On CPU tensors every
kernel wrapper runs its plain PyTorch version instead.

Ported so far: the act step of the RxR CMA policy (obs transforms, CMAPolicy,
`trainers.base_trainer.make_fused_act_step`).
"""

__version__ = "0.1.0"

from vlnce_torch.registry import registry  # noqa: F401
from vlnce_torch.ops import obs_transforms  # noqa: F401  (registry population)
from vlnce_torch.models.cma_policy import CMAPolicy  # noqa: F401
