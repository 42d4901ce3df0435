"""Package boundary and configuration of the PyTorch port."""

import json
import os
import subprocess
import sys

import numpy as np

from vlnce_tpu.config import get_config as jax_get_config
from vlnce_torch.config import get_config
from vlnce_torch.envs.spaces import observation_space_from_config
from vlnce_torch.ops.obs_transforms import apply_obs_transforms_obs_space, get_active_obs_transforms

from tests.torch_port_cases import JAX_RXR_CMA, RXR_CMA

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import vlnce_torch
from vlnce_torch.ops import _build
names = [m.name for m in pkgutil.walk_packages(vlnce_torch.__path__, "vlnce_torch.")]
for name in names:
    importlib.import_module(name)
print(json.dumps({
    "modules": names,
    "foreign": sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "vlnce_tpu")),
    "loaded_kernels": sorted(_build.loaded()),
}))
"""


def test_import_pulls_in_no_jax_and_builds_no_kernel():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert "vlnce_torch.models.cma_policy" in report["modules"] and "vlnce_torch.ops.preprocess" in report["modules"]
    assert report["foreign"] == []
    assert report["loaded_kernels"] == []


def test_default_device_is_cuda_in_bf16():
    cfg = get_config()
    assert cfg.CUDA.DEVICE == "cuda"
    assert cfg.CUDA.PRECISION.compute_dtype == "bfloat16"
    assert "TPU" not in cfg


def test_rxr_cma_config_matches_jax():
    """The port's copies of rxr_cma_en.yaml and its task YAML give the JAX
    package's model, transforms and cameras."""
    jcfg, cfg = jax_get_config(JAX_RXR_CMA), get_config(RXR_CMA)
    assert cfg.BASE_TASK_CONFIG_PATH.startswith("vlnce_torch/")
    assert json.dumps(cfg.MODEL.to_dict(), sort_keys=True) == json.dumps(jcfg.MODEL.to_dict(), sort_keys=True)
    assert cfg.RL.POLICY.OBS_TRANSFORMS.to_dict() == jcfg.RL.POLICY.OBS_TRANSFORMS.to_dict()
    for sensor in ("RGB_SENSOR", "DEPTH_SENSOR"):
        assert cfg.TASK_CONFIG.SIMULATOR[sensor].to_dict() == jcfg.TASK_CONFIG.SIMULATOR[sensor].to_dict()
    assert cfg.TASK_CONFIG.TASK.POSSIBLE_ACTIONS == jcfg.TASK_CONFIG.TASK.POSSIBLE_ACTIONS
    assert cfg.TASK_CONFIG.TASK.SENSORS == ["RXR_INSTRUCTION_SENSOR"]


def test_rxr_observation_space_after_transforms():
    cfg = get_config(RXR_CMA)
    space = apply_obs_transforms_obs_space(observation_space_from_config(cfg.TASK_CONFIG), get_active_obs_transforms(cfg))
    assert space["rgb"].shape == (224, 224, 3) and space["rgb"].dtype == np.uint8
    assert space["depth"].shape == (256, 256, 1) and space["depth"].dtype == np.float32
    assert space["rxr_instruction"].shape == (512, 768)
