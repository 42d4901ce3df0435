"""Single entry point of the port: train / eval / inference.

    python -m vlnce_torch.run --exp-config path/to/experiment.yaml \
        --run-type {train,eval,inference} [KEY VALUE ...]

The flags are those of the JAX package's run.py (reference run.py:22-43).
Everything runs on `CUDA.DEVICE` (default `cuda`); pass `CUDA.DEVICE cpu
CUDA.PRECISION.compute_dtype float32` to run on the CPU. `train` is DAgger
(`TRAINER_NAME dagger`, the r2r_baselines/*.yaml experiments), the
recollect trainer (`TRAINER_NAME recollect_trainer`, the rxr_baselines) or
DD-PPO of the waypoint policy (`TRAINER_NAME ddppo-waypoint`, the
r2r_waypoint/*.yaml experiments). `EVAL.EVAL_NONLEARNING` and
`INFERENCE.INFERENCE_NONLEARNING` run a nonlearning agent instead
(r2r_baselines/nonlearning.yaml).

Several ranks, one process per card: `torchrun --nproc_per_node K -m
vlnce_torch.run ...` (or K SLURM tasks, the reference's convention) joins a
`torch.distributed` process group before any device use
(`parallel/distributed.init_distributed`; backend `RL.DDPPO.distrib_backend`
on the card, gloo on the CPU), and the trainers train data-parallel over
its ranks (`CUDA.MESH.DATA`, -1 for all of them). Each rank logs to
`LOG_FILE.rank<k>`.
"""

from __future__ import annotations

import argparse
import random

import numpy as np


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--run-type",
        choices=["train", "eval", "inference"],
        required=True,
        help="run type of the experiment (train, eval, inference)",
    )
    parser.add_argument(
        "--exp-config",
        type=str,
        required=True,
        help="path to config yaml containing info about experiment",
    )
    parser.add_argument(
        "opts",
        default=None,
        nargs=argparse.REMAINDER,
        help="Modify config options from command line",
    )
    args = parser.parse_args()
    run_exp(args.exp_config, args.run_type, args.opts)


def run_exp(exp_config: str, run_type: str, opts=None):
    """Build the config and the trainer it names, run `run_type` on it, and
    return the trainer (its `last_loop_timing` holds the loop's clocks); a
    nonlearning eval or inference runs its agent and returns None."""
    import torch

    from vlnce_torch.config import get_config
    from vlnce_torch.utils.logging import logger

    # populate registries
    import vlnce_torch.tasks  # noqa: F401
    import vlnce_torch.models.cma_policy  # noqa: F401
    import vlnce_torch.models.seq2seq_policy  # noqa: F401
    import vlnce_torch.models.waypoint_policy  # noqa: F401
    from vlnce_torch.envs import ensure_registered
    from vlnce_torch.envs import rl_envs  # noqa: F401
    import vlnce_torch.trainers  # noqa: F401
    from vlnce_torch.registry import registry

    ensure_registered()

    config = get_config(exp_config, opts)
    # the process group (torchrun's or SLURM's environment) before any device
    # use; a no-op on one process
    from vlnce_torch.parallel.distributed import init_distributed, world_rank, world_size

    on_card = torch.device(config.CUDA.DEVICE).type == "cuda"
    multi = init_distributed(backend=str(config.RL.DDPPO.distrib_backend) if on_card else "gloo")
    logger.info(f"config: {config.dump()}" if config.VERBOSE else f"run_type: {run_type}")
    if config.LOG_FILE:
        logger.add_filehandler(f"{config.LOG_FILE}.rank{world_rank()}" if multi else config.LOG_FILE)
    if multi:
        logger.info(f"process group: rank {world_rank()} of {world_size()}, backend {torch.distributed.get_backend()}")

    random.seed(config.TASK_CONFIG.SEED)
    np.random.seed(config.TASK_CONFIG.SEED)
    torch.manual_seed(config.TASK_CONFIG.SEED)

    # nonlearning shortcuts (reference run.py:71-77); they build no trainer
    # and return None
    from vlnce_torch.trainers.nonlearning_agents import evaluate_agent, nonlearning_inference

    if run_type == "eval" and config.EVAL.EVAL_NONLEARNING:
        evaluate_agent(config)
        return None
    if run_type == "inference" and config.INFERENCE.INFERENCE_NONLEARNING:
        nonlearning_inference(config)
        return None

    trainer_cls = registry.get_trainer(config.TRAINER_NAME)
    trainer = trainer_cls(config)
    getattr(trainer, run_type)()
    return trainer


if __name__ == "__main__":
    main()
