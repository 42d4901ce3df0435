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

BLOCKED = ("jax", "jaxlib", "flax", "optax", "vlnce_tpu", "gymnasium", "attr", "tqdm", "cv2", "msgpack", "lmdb", "networkx",
           "PIL", "imageio")

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
blocked = %r
for name in blocked:
    sys.modules[name] = None  # `import name` now raises ImportError
import vlnce_torch
from vlnce_torch import native
from vlnce_torch.ops import _build
names = [m.name for m in pkgutil.walk_packages(vlnce_torch.__path__, "vlnce_torch.")]
for name in names:
    importlib.import_module(name)
print(json.dumps({
    "modules": names,
    "foreign": sorted(k for k, v in sys.modules.items() if k.split(".")[0] in blocked and v is not None),
    "loaded_kernels": sorted(_build.loaded()),
    "ring_loaded": native._lib is not None,
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
    # the device-resident grid world, scan eval and on-device DAgger
    "vlnce_torch.envs.device_sim", "vlnce_torch.trainers.scan_eval", "vlnce_torch.trainers.device_dagger",
    # the trajectory bank on the card and the feature-bank route
    "vlnce_torch.data.device_bank", "vlnce_torch.data.feature_bank",
    # the JAX package's checkpoints, the nonlearning agents, scene import and the command-line tools
    "vlnce_torch.utils.msgpack_reader", "vlnce_torch.trainers.nonlearning_agents", "vlnce_torch.utils.nav_graph",
    "vlnce_torch.envs.scene_import", "vlnce_torch.scripts", "vlnce_torch.scripts.ckpt_to_interrupted_state",
    "vlnce_torch.scripts.export_scene_geometry", "vlnce_torch.scripts.generate_feature_bank",
    # the video path and the other simulators
    "vlnce_torch.utils.raster", "vlnce_torch.utils.maps", "vlnce_torch.utils.video", "vlnce_torch.envs.replay_sim",
    "vlnce_torch.envs.habitat_adapter",
    # data-parallel training across ranks and the shared-memory observation ring
    "vlnce_torch.parallel.mesh", "vlnce_torch.parallel.distributed", "vlnce_torch.parallel.mp_smoke",
    "vlnce_torch.envs.shm_transport", "vlnce_torch.native",
    # the asset-day parity check, the progress bars and the inference-merge tool
    "vlnce_torch.scripts.eval_parity", "vlnce_torch.utils.progress", "vlnce_torch.scripts.merge_inference_predictions",
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
    assert report["ring_loaded"] is False  # importing builds and loads no native library either


def test_no_module_imports_tqdm_or_cv2():
    """The card's machine has neither tqdm nor cv2: no module of the port
    names them in an import, guarded or not (the import check above only
    sees the imports that run)."""
    import ast

    found = []
    root = os.path.join(REPO, "vlnce_torch")
    for dirpath, _, files in os.walk(root):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    mods = [alias.name for alias in node.names]
                elif isinstance(node, ast.ImportFrom):
                    mods = [node.module or ""]
                elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                        "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
                    mods = [str(node.args[0].value)]
                else:
                    continue
                found += [f"{os.path.relpath(path, REPO)}:{node.lineno} {m}" for m in mods
                          if m.split(".")[0] in ("tqdm", "cv2")]
    assert found == []


_VIDEO_WITHOUT_IMAGE_LIBRARIES = """
import json, sys, tempfile
for name in ("cv2", "PIL", "imageio"):
    sys.modules[name] = None  # `import name` now raises ImportError
import numpy as np
import vlnce_torch.config  # noqa: F401
from vlnce_torch.envs import Env
from vlnce_torch.config import get_config
from vlnce_torch.utils import video
cfg = get_config(opts=["TASK_CONFIG.DATASET.TYPE", "Synthetic-VLN-v0", "TASK_CONFIG.SIMULATOR.RGB_SENSOR.HEIGHT", 32,
                       "TASK_CONFIG.SIMULATOR.RGB_SENSOR.WIDTH", 32, "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.HEIGHT", 32,
                       "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.WIDTH", 32])
task = cfg.TASK_CONFIG.clone()
task.defrost()
task.TASK.MEASUREMENTS.append("TOP_DOWN_MAP_VLNCE")
env = Env(task)
obs, frames = env.reset(), []
while not env.episode_over:
    obs = env.step(int(obs["shortest_path_sensor"][0]))
    info = env.get_metrics()
    frame = video.observations_to_image(obs, info)
    frames.append(video.append_text_to_image(frame, env.current_episode.instruction.instruction_text))
pano = {"rgb": np.stack([obs["rgb"]] * 12), "depth": np.stack([obs["depth"]] * 12)}
frames_wp = [video.waypoint_observations_to_image(pano, info, pano=3, r=1.0, theta=0.2, instruction_text="go"),
             video.navigator_video_frame(pano, info, instruction_text="go")]
out = tempfile.mkdtemp()
path = video.images_to_video(frames, out, "episode")
back = video.read_video(path)
print(json.dumps({"frames": len(frames), "read": int(back.shape[0]), "equal": bool((back == np.stack(frames)).all()),
                  "shapes": [list(f.shape) for f in frames_wp],
                  "foreign": sorted(k for k in ("cv2", "PIL", "imageio") if sys.modules.get(k) is not None)}))
"""


def test_video_composer_runs_without_image_libraries():
    """The frame composers and the AVI writer run with cv2, PIL and imageio
    unimportable, and the file reads back bit for bit."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _VIDEO_WITHOUT_IMAGE_LIBRARIES], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["frames"] == report["read"] > 1 and report["equal"]
    assert report["foreign"] == [] and all(s[2] == 3 for s in report["shapes"])

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
    Seq2Seq, the nonlearning agents' and the test-set inference's) give the
    JAX package's model and IL settings, and point at the port's task YAMLs;
    the two others equal the JAX package's outside the CUDA / TPU sections."""
    names = sorted(f for f in os.listdir(os.path.join(REPO, "vlnce_torch/config/experiments/r2r_baselines")))
    assert names == sorted(os.listdir(os.path.join(REPO, "vlnce_tpu/config/experiments/r2r_baselines")))
    assert len(names) == 19 and sum(n.startswith("cma") for n in names) == 10
    assert sum(n.startswith("seq2seq") for n in names) == 7
    for name in ("nonlearning.yaml", "test_set_inference.yaml"):
        jcfg = jax_get_config(f"vlnce_tpu/config/experiments/r2r_baselines/{name}").to_dict()
        cfg = get_config(f"vlnce_torch/config/experiments/r2r_baselines/{name}").to_dict()
        jcfg.pop("TPU"), cfg.pop("CUDA")
        jcfg["BASE_TASK_CONFIG_PATH"] = jcfg["BASE_TASK_CONFIG_PATH"].replace("vlnce_tpu/", "vlnce_torch/")
        assert json.dumps(cfg, sort_keys=True) == json.dumps(jcfg, sort_keys=True), name
    assert get_config("vlnce_torch/config/experiments/r2r_baselines/nonlearning.yaml").EVAL.EVAL_NONLEARNING is True
    for name in names:
        if name in ("nonlearning.yaml", "test_set_inference.yaml"):
            continue
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
    # the JAX package's TPU defaults (vlnce_tpu/config/default.py)
    jcfg = jax_get_config()
    assert cfg.CUDA.DAGGER_SEGMENT == jcfg.TPU.DAGGER_SEGMENT == 32
    assert cfg.CUDA.FEATURE_BANK_DIR == jcfg.TPU.FEATURE_BANK_DIR == ""
    assert cfg.CUDA.FEATURE_BANK_MAX_DIST == jcfg.TPU.FEATURE_BANK_MAX_DIST == 0.0
    assert cfg.CUDA.DAGGER_ARCHIVE_STORE is jcfg.TPU.DAGGER_ARCHIVE_STORE is False


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


def test_resident_rl_keys_raise_naming_the_roadmap_heading(monkeypatch, tmp_path):
    """CUDA.ON_DEVICE_ROLLOUT and CUDA.PPO_UPDATE_SCAN (the rollout on the
    card and the enqueued PPO update) train since their slice came
    (tests/test_torch_device_rollout.py), and since the scene import came
    they train on imported scene geometry too: each trains one update on an
    export of every scene of the split (in a frame away from the origin),
    builds no env pool, and writes its checkpoint. (Until then both raised
    here naming the roadmap's heading.)"""
    import vlnce_torch.trainers  # noqa: F401
    from vlnce_torch.envs import rl_envs  # noqa: F401
    from vlnce_torch.registry import registry
    from vlnce_torch.tasks.datasets import make_dataset
    from vlnce_torch.trainers import ddppo_waypoint_trainer

    from tests.torch_port_cases import SceneRegistrySnapshot, assert_imported, export_synthetic_geometry

    def no_pool(*args, **kwargs):
        raise AssertionError("the env pool was constructed")

    monkeypatch.setattr(ddppo_waypoint_trainer, "construct_envs", no_pool)
    for key in ("ON_DEVICE_ROLLOUT", "PPO_UPDATE_SCAN"):
        with SceneRegistrySnapshot():
            cfg = get_config("vlnce_torch/config/experiments/synthetic/smoke_waypoint.yaml", [
                "CUDA.DEVICE", "cpu", "CUDA.PRECISION.compute_dtype", "float32", "CUDA.ON_DEVICE_ROLLOUT", True,
                f"CUDA.{key}", True, "TASK_CONFIG.SIMULATOR.GEOMETRY_DIR", str(tmp_path / key / "geometry"),
                "CHECKPOINT_FOLDER", str(tmp_path / key / "ckpts"), "RL.NUM_UPDATES", 1, "RL.PPO.num_steps", 2,
                "TASK_CONFIG.DATASET.NUM_EPISODES", 4,
                "TASK_CONFIG.SIMULATOR.RGB_SENSOR.HEIGHT", 16, "TASK_CONFIG.SIMULATOR.RGB_SENSOR.WIDTH", 16,
                "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.HEIGHT", 16, "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.WIDTH", 16,
            ])
            scene_ids = {e.scene_id for e in make_dataset(cfg.TASK_CONFIG.DATASET.TYPE, cfg.TASK_CONFIG.DATASET).episodes}
            export_synthetic_geometry(str(tmp_path / key / "geometry"), scene_ids)
            trainer = registry.get_trainer("ddppo-waypoint")(cfg)
            trainer.train()
            assert trainer.envs is None and trainer.collector is not None and trainer.collector.rollouts == 1
            assert_imported(scene_ids)
            assert os.path.exists(tmp_path / key / "ckpts" / "ckpt.0.ckpt")
