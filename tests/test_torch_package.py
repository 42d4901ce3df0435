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

BLOCKED = ("jax", "jaxlib", "flax", "optax", "vlnce_tpu", "gymnasium", "attr", "tqdm", "cv2", "msgpack", "lmdb")

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
blocked = %r
for name in blocked:
    sys.modules[name] = None  # `import name` now raises ImportError
import vlnce_torch
from vlnce_torch.ops import _build
names = [m.name for m in pkgutil.walk_packages(vlnce_torch.__path__, "vlnce_torch.")]
for name in names:
    importlib.import_module(name)
print(json.dumps({
    "modules": names,
    "foreign": sorted(k for k, v in sys.modules.items() if k.split(".")[0] in blocked and v is not None),
    "loaded_kernels": sorted(_build.loaded()),
}))
""" % (BLOCKED,)

NEW_MODULES = [
    "vlnce_torch.run", "vlnce_torch.trainers.base_trainer", "vlnce_torch.utils.checkpoints", "vlnce_torch.utils.logging",
    "vlnce_torch.utils.tensorboard", "vlnce_torch.envs.env", "vlnce_torch.envs.env_utils", "vlnce_torch.envs.gridworld",
    "vlnce_torch.envs.rl_envs", "vlnce_torch.envs.sim", "vlnce_torch.envs.vector_env", "vlnce_torch.tasks.actions",
    "vlnce_torch.tasks.datasets", "vlnce_torch.tasks.dtw", "vlnce_torch.tasks.episodes", "vlnce_torch.tasks.geometry",
    "vlnce_torch.tasks.measures", "vlnce_torch.tasks.sensors", "vlnce_torch.tasks.shortest_path_follower",
    "vlnce_torch.tasks.task", "vlnce_torch.tasks.vocab",
    # the training slice
    "vlnce_torch.trainers.dagger_trainer", "vlnce_torch.parallel.il_step", "vlnce_torch.parallel.optim",
    "vlnce_torch.data.collate", "vlnce_torch.data.prefetch", "vlnce_torch.data.trajectory_store",
    "vlnce_torch.models.aux_losses", "vlnce_torch.utils.profiling",
    # the recollect slice
    "vlnce_torch.models.seq2seq_policy", "vlnce_torch.data.recollection", "vlnce_torch.trainers.recollect_trainer",
    # the waypoint RL slice
    "vlnce_torch.models.waypoint_predictors", "vlnce_torch.models.waypoint_policy", "vlnce_torch.rl.rollout_storage",
    "vlnce_torch.rl.ppo", "vlnce_torch.trainers.ddppo_waypoint_trainer", "vlnce_torch.tasks.discrete_planner",
]


def test_import_pulls_in_no_jax_and_builds_no_kernel():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert "vlnce_torch.models.cma_policy" in report["modules"] and "vlnce_torch.ops.preprocess" in report["modules"]
    assert set(NEW_MODULES) <= set(report["modules"])
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


def test_r2r_cma_configs_match_jax():
    """The port's copies of the R2R experiment YAMLs (ten CMA, seven
    Seq2Seq) give the JAX package's model and IL settings, and point at the
    port's task YAMLs; the nonlearning ones are not ported yet."""
    names = sorted(f for f in os.listdir(os.path.join(REPO, "vlnce_torch/config/experiments/r2r_baselines")))
    assert len(names) == 17 and sum(n.startswith("cma") for n in names) == 10
    assert sum(n.startswith("seq2seq") for n in names) == 7
    for name in names:
        jcfg = jax_get_config(f"vlnce_tpu/config/experiments/r2r_baselines/{name}")
        cfg = get_config(f"vlnce_torch/config/experiments/r2r_baselines/{name}")
        assert cfg.BASE_TASK_CONFIG_PATH == jcfg.BASE_TASK_CONFIG_PATH.replace("vlnce_tpu/", "vlnce_torch/")
        assert cfg.TRAINER_NAME == jcfg.TRAINER_NAME == "dagger"
        assert cfg.MODEL.policy_name == ("CMAPolicy" if name.startswith("cma") else "Seq2SeqPolicy")
        for section in ("MODEL", "IL", "EVAL"):
            assert json.dumps(cfg[section].to_dict(), sort_keys=True) == json.dumps(jcfg[section].to_dict(), sort_keys=True), (name, section)
        assert cfg.TASK_CONFIG.TASK.to_dict() == jcfg.TASK_CONFIG.TASK.to_dict()
        assert cfg.TASK_CONFIG.DATASET.to_dict() == jcfg.TASK_CONFIG.DATASET.to_dict()


def test_rxr_and_synthetic_configs_match_jax():
    """The four RxR baselines (the recollect trainer; English, Hindi and
    Telugu task YAMLs) and the synthetic Seq2Seq smoke config equal the JAX
    package's up to the package name, outside the CUDA / TPU sections."""
    names = ["rxr_baselines/" + n for n in sorted(os.listdir(os.path.join(REPO, "vlnce_torch/config/experiments/rxr_baselines")))]
    assert names == [f"rxr_baselines/{n}.yaml" for n in ("rxr_cma_en", "rxr_cma_hi", "rxr_cma_te", "rxr_seq2seq")]
    for name in names + ["synthetic/smoke_seq2seq.yaml"]:
        jcfg = jax_get_config(f"vlnce_tpu/config/experiments/{name}").to_dict()
        cfg = get_config(f"vlnce_torch/config/experiments/{name}").to_dict()
        jcfg.pop("TPU"), cfg.pop("CUDA")
        jcfg["BASE_TASK_CONFIG_PATH"] = jcfg["BASE_TASK_CONFIG_PATH"].replace("vlnce_tpu/", "vlnce_torch/")
        assert json.dumps(cfg, sort_keys=True) == json.dumps(jcfg, sort_keys=True), name
        if name.startswith("rxr"):
            assert cfg["TRAINER_NAME"] == "recollect_trainer"
    languages = {n: get_config(f"vlnce_torch/config/experiments/rxr_baselines/{n}.yaml").TASK_CONFIG.DATASET.LANGUAGES
                 for n in ("rxr_cma_hi", "rxr_cma_te")}
    assert languages == {"rxr_cma_hi": ["hi-IN"], "rxr_cma_te": ["te-IN"]}


def test_training_keys_of_the_cuda_section():
    cfg = get_config()
    assert cfg.CUDA.ASYNC_CHECKPOINT is True and cfg.CUDA.PIPELINED_COLLECTION is False and cfg.CUDA.PROFILE_DIR == ""
    assert not (cfg.CUDA.ON_DEVICE_DAGGER or cfg.CUDA.DAGGER_RESIDENT or cfg.CUDA.RESIDENT_EPOCH_SCAN)
    assert not (cfg.CUDA.ON_DEVICE_RECOLLECT or cfg.CUDA.RECOLLECT_RESIDENT)
    assert not (cfg.CUDA.ON_DEVICE_ROLLOUT or cfg.CUDA.PPO_UPDATE_SCAN)


def test_waypoint_configs_match_jax():
    """The six r2r_waypoint experiments, the synthetic waypoint smoke
    config and the discrete-navigator override equal the JAX package's up to
    the package name, outside the CUDA / TPU sections, with the pano sensors
    added as the trainer adds them."""
    import pytest

    from vlnce_torch.config.default import add_pano_sensors_to_config
    from vlnce_tpu.config.default import add_pano_sensors_to_config as jax_add_pano_sensors_to_config

    names = sorted(os.listdir(os.path.join(REPO, "vlnce_torch/config/experiments/r2r_waypoint")))
    assert names == sorted(os.listdir(os.path.join(REPO, "vlnce_tpu/config/experiments/r2r_waypoint"))) and len(names) == 6
    chains = [f"config/experiments/r2r_waypoint/{n}" for n in names] + [
        "config/experiments/synthetic/smoke_waypoint.yaml",
        "config/experiments/synthetic/smoke_waypoint.yaml,{pkg}/tasks/config/vlnce_waypoint_DN.yaml"]
    for chain in chains:
        jcfg = jax_add_pano_sensors_to_config(jax_get_config("vlnce_tpu/" + chain.format(pkg="vlnce_tpu"))).to_dict()
        cfg = add_pano_sensors_to_config(get_config("vlnce_torch/" + chain.format(pkg="vlnce_torch"))).to_dict()
        jcfg.pop("TPU"), cfg.pop("CUDA")
        jcfg["BASE_TASK_CONFIG_PATH"] = jcfg["BASE_TASK_CONFIG_PATH"].replace("vlnce_tpu/", "vlnce_torch/")
        assert json.dumps(cfg, sort_keys=True) == json.dumps(jcfg, sort_keys=True), chain
        assert cfg["TRAINER_NAME"] == "ddppo-waypoint" and cfg["MODEL"]["STATE_ENCODER"]["hidden_size"] == 256
    with pytest.raises(KeyError):
        get_config("vlnce_torch/config/experiments/r2r_waypoint/1-wpn-cc.yaml", ["TPU.ON_DEVICE_ROLLOUT", True])


def test_resident_rl_keys_raise_naming_the_roadmap_heading():
    """CUDA.ON_DEVICE_ROLLOUT and CUDA.PPO_UPDATE_SCAN (the JAX package's
    device-resident rollout and fused PPO update) raise before any env is
    built."""
    import pytest

    import vlnce_torch.trainers  # noqa: F401
    from vlnce_torch.registry import registry

    for key in ("ON_DEVICE_ROLLOUT", "PPO_UPDATE_SCAN"):
        cfg = get_config("vlnce_torch/config/experiments/synthetic/smoke_waypoint.yaml",
                         ["CUDA.DEVICE", "cpu", f"CUDA.{key}", True])
        trainer = registry.get_trainer("ddppo-waypoint")(cfg)
        with pytest.raises(NotImplementedError, match="Device-resident loops"):
            trainer.train()
        assert trainer.envs is None
