"""Environment pool construction.

Parity with reference vlnce_baselines/common/env_utils.py:10-103: scene
de-dup round-robin splitting across workers, per-process seed offsets, and
the auto_reset_false variant for eval. On this stack sims are CPU-side, so
SIMULATOR_GPU_IDS only scales the worker count for config parity.
"""

from __future__ import annotations

import os
import random
from typing import List

from vlnce_torch.registry import registry
from vlnce_torch.envs.vector_env import ThreadedVectorEnv, VectorEnv


def make_env_fn(config, env_class):
    env = env_class(config)
    env.seed(config.TASK_CONFIG.SEED)
    return env


def construct_envs(
    config,
    env_class,
    auto_reset_done: bool = True,
    episodes_allowed: List[str] = None,
):
    num_envs_per_gpu = config.NUM_ENVIRONMENTS
    if isinstance(config.SIMULATOR_GPU_IDS, list):
        num_envs = num_envs_per_gpu * max(1, len(config.SIMULATOR_GPU_IDS))
    else:
        num_envs = num_envs_per_gpu

    configs = []
    dataset_cls = registry.get_dataset(config.TASK_CONFIG.DATASET.TYPE)
    scenes = list(config.TASK_CONFIG.DATASET.CONTENT_SCENES)
    if "*" in scenes:
        scenes = dataset_cls.get_scenes_to_load(config.TASK_CONFIG.DATASET)

    if num_envs > 1:
        if len(scenes) == 0:
            raise RuntimeError("no scenes to load")
        random.Random(config.TASK_CONFIG.SEED).shuffle(scenes)

    # round-robin scene split (reference env_utils.py:64-71)
    scene_splits: List[List[str]] = [[] for _ in range(num_envs)]
    for idx, scene in enumerate(scenes):
        scene_splits[idx % len(scene_splits)].append(scene)

    for i in range(num_envs):
        proc_config = config.clone().defrost()
        task_config = proc_config.TASK_CONFIG
        task_config.SEED = task_config.SEED + i  # per-proc seed offset
        if len(scenes) > 0:
            task_config.DATASET.CONTENT_SCENES = scene_splits[i] if scene_splits[i] else scenes
        if episodes_allowed is not None:
            task_config.DATASET.EPISODES_ALLOWED = list(episodes_allowed)
        proc_config.freeze()
        configs.append(proc_config)

    vec_cls = ThreadedVectorEnv if os.environ.get("VLNCE_TORCH_THREADED_ENVS") else VectorEnv
    return vec_cls(
        make_env_fn=make_env_fn,
        env_fn_args=tuple((configs[i], env_class) for i in range(num_envs)),
        auto_reset_done=auto_reset_done,
    )


def construct_envs_auto_reset_false(config, env_class):
    return construct_envs(config, env_class, auto_reset_done=False)


def get_env_class(env_name: str):
    return registry.get_env(env_name)
