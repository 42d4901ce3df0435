#!/bin/bash
#SBATCH --job-name=vlnce
#SBATCH --output=logs/%x.out
#SBATCH --error=logs/%x.err
#SBATCH --nodes 1
#SBATCH --ntasks-per-node 1
#SBATCH --gpus-per-task 1
#SBATCH --cpus-per-task 48
#SBATCH --time=24:00:00
#SBATCH --signal=USR1@600
#SBATCH --open-mode=append

# ----------------------------------------------------------------------------
# Example cluster script: DAgger IL training on one card of a GPU node.
# Simulators run as forked worker processes on the CPUs (NUM_ENVIRONMENTS);
# everything neural runs on the task's card. IL.is_requeue resumes from the
# latest full-state checkpoint after preemption.
# ----------------------------------------------------------------------------

set -x
srun -u \
python -u -m vlnce_torch.run \
    --exp-config vlnce_torch/config/experiments/r2r_baselines/cma_pm_da.yaml \
    --run-type train
