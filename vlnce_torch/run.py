"""Single entry point of the port: train / eval / inference.

    python -m vlnce_torch.run --exp-config path/to/experiment.yaml \
        --run-type {train,eval,inference} [KEY VALUE ...]

The flags are those of the JAX package's run.py (reference run.py:22-43).
Everything runs on `CUDA.DEVICE` (default `cuda`); pass `CUDA.DEVICE cpu
CUDA.PRECISION.compute_dtype float32` to run on the CPU. `train` is DAgger
(`TRAINER_NAME dagger`, the r2r_baselines/*.yaml experiments), the
recollect trainer (`TRAINER_NAME recollect_trainer`, the rxr_baselines) or
DD-PPO of the waypoint policy (`TRAINER_NAME ddppo-waypoint`, the
r2r_waypoint/*.yaml experiments).
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
    return the trainer (its `last_loop_timing` holds the loop's clocks)."""
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
    logger.info(f"config: {config.dump()}" if config.VERBOSE else f"run_type: {run_type}")
    if config.LOG_FILE:
        logger.add_filehandler(config.LOG_FILE)

    random.seed(config.TASK_CONFIG.SEED)
    np.random.seed(config.TASK_CONFIG.SEED)
    torch.manual_seed(config.TASK_CONFIG.SEED)

    if (run_type == "eval" and config.EVAL.EVAL_NONLEARNING) or (
        run_type == "inference" and config.INFERENCE.INFERENCE_NONLEARNING
    ):
        raise NotImplementedError(
            "the nonlearning agents (trainers/nonlearning_agents.py) are not ported to vlnce_torch yet "
            "(ROADMAP.md section A, 'Left by the serving slice')"
        )

    trainer_cls = registry.get_trainer(config.TRAINER_NAME)
    trainer = trainer_cls(config)
    getattr(trainer, run_type)()
    return trainer


if __name__ == "__main__":
    main()
