"""The program under test, built through its own entry points: the trainer
the configuration names, its observation spaces and obs transforms, the
policy from `_initialize_policy` (and its masked Adam), the kernels built
once into the checkout. The benchmark's weights are then loaded by name.

This module, and the runners, are the only parts of the benchmark that
import the program; the reference never does."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from benchmark.reference.cma import Arch


def _registries() -> None:
    import vlnce_torch.models.cma_policy  # noqa: F401
    import vlnce_torch.tasks  # noqa: F401
    import vlnce_torch.trainers  # noqa: F401
    from vlnce_torch.envs import ensure_registered, rl_envs  # noqa: F401

    ensure_registered()


def build_kernels(device: torch.device) -> None:
    if device.type == "cuda":
        from vlnce_torch.ops import _build

        _build.build()


def trainer_with_policy(config, trainer_name: str = ""):
    """The configuration's trainer (or `trainer_name`'s), with its obs
    transforms, its policy and its optimizer, as its own set-up makes them."""
    _registries()
    from vlnce_torch.ops.obs_transforms import get_active_obs_transforms
    from vlnce_torch.registry import registry

    trainer = registry.get_trainer(trainer_name or config.TRAINER_NAME)(config)
    trainer.obs_transforms = get_active_obs_transforms(config)
    obs_space, act_space = trainer._get_spaces(config)
    trainer._initialize_policy(config, load_from_ckpt=False, observation_space=obs_space, action_space=act_space)
    return trainer


def load_weights(policy, W: Dict[str, torch.Tensor]) -> None:
    """The benchmark's weights into the policy, every key, every shape."""
    with torch.no_grad():
        policy.load_state_dict(W, strict=True)


def transformed_hw(config, uuid: str) -> Tuple[int, int]:
    """A camera's frame size after the configured resize and crop."""
    sim = config.TASK_CONFIG.SIMULATOR
    cam = sim.RGB_SENSOR if uuid == "rgb" else sim.DEPTH_SENSOR
    h, w = int(cam.HEIGHT), int(cam.WIDTH)
    tf = config.RL.POLICY.OBS_TRANSFORMS
    enabled = list(tf.ENABLED_TRANSFORMS)
    if "ResizeShortestEdge" in enabled:
        scale = int(tf.RESIZE_SHORTEST_EDGE.SIZE) / min(h, w)
        h, w = int(h * scale), int(w * scale)
    if "CenterCropperPerSensor" in enabled:
        crops = {k: tuple(v) for k, v in tf.CENTER_CROPPER_PER_SENSOR.SENSOR_CROPS}
        if uuid in crops:
            h, w = crops[uuid]
    return h, w


def arch(config) -> Arch:
    mc = config.MODEL
    ie = mc.INSTRUCTION_ENCODER
    tokens = str(ie.sensor_uuid) == "instruction"
    return Arch(
        num_actions=len(config.TASK_CONFIG.TASK.POSSIBLE_ACTIONS), hidden=int(mc.STATE_ENCODER.hidden_size),
        rgb_out=int(mc.RGB_ENCODER.output_size), depth_out=int(mc.DEPTH_ENCODER.output_size),
        depth_hw=transformed_hw(config, "depth")[0], instr_tokens=tokens, vocab=int(ie.vocab_size),
        embed=int(ie.embedding_size), feature_dim=int(config.TASK_CONFIG.TASK.RXR_INSTRUCTION_SENSOR.feature_dim),
        instr_hidden=int(ie.hidden_size), progress_monitor=bool(mc.PROGRESS_MONITOR.use),
        pm_alpha=float(mc.PROGRESS_MONITOR.alpha),
        frozen_embedding=bool(ie.use_pretrained_embeddings) and not bool(ie.fine_tune_embeddings),
    )


def cameras(config) -> List[Dict]:
    """The configured cameras, in the agent's sensor order, as the
    reference renderer takes them."""
    sim = config.TASK_CONFIG.SIMULATOR
    depth = sim.DEPTH_SENSOR
    out = []
    for name in sim.AGENT_0.SENSORS:
        cam = getattr(sim, name)
        out.append({"uuid": str(cam.UUID), "height": int(cam.HEIGHT), "width": int(cam.WIDTH), "hfov": float(cam.HFOV),
                    "kind": "depth" if "DEPTH" in name else "rgb", "min_depth": float(depth.MIN_DEPTH),
                    "max_depth": float(depth.MAX_DEPTH), "normalize": bool(depth.NORMALIZE_DEPTH)})
    return out
