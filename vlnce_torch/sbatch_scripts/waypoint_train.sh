#!/bin/bash
#SBATCH --job-name=waypoint_train
#SBATCH --output=logs/%x.out
#SBATCH --error=logs/%x.err
#SBATCH --nodes 8
#SBATCH --ntasks-per-node 1
#SBATCH --gpus-per-task 1
#SBATCH --cpus-per-task 96
#SBATCH --time=72:00:00
#SBATCH --signal=USR1@600
#SBATCH --open-mode=append

# ----------------------------------------------------------------------------
# Distributed waypoint DD-PPO training over several GPU nodes.
#
# Topology (the reference's 64-GPU NCCL job, sbatch_scripts/waypoint_train.sh):
# ONE process per card, each a SLURM task with its own card. Each task drives
# its local simulator pool on its CPU cores; torch.distributed joins the
# tasks (NCCL, RL.DDPPO.distrib_backend) so the data-parallel axis spans
# every card of the job. vlnce_torch.run calls
# vlnce_torch.parallel.distributed.init_distributed, which reads
# SLURM_PROCID / SLURM_NTASKS / SLURM_LOCALID and MASTER_ADDR / MASTER_PORT
# (set below to the job's first node). On nodes of K cards, set
# --ntasks-per-node K and divide --cpus-per-task by K. SIGUSR1 600 s before
# the time limit triggers the requeue path (interrupted-state save +
# resume, same protocol as the reference).
# ----------------------------------------------------------------------------

export MASTER_ADDR=$(scontrol show hostnames "$SLURM_JOB_NODELIST" | head -n 1)
export MASTER_PORT=${MASTER_PORT:-8738}

printenv | grep -E "SLURM|CUDA|NCCL|MASTER" | sort
set -x
srun -u \
python -u -m vlnce_torch.run \
    --exp-config vlnce_torch/config/experiments/r2r_waypoint/2-wpn-dc.yaml \
    --run-type train \
    CUDA.MESH.DATA -1
