#!/bin/bash
#SBATCH --job-name=waypoint_train
#SBATCH --output=logs/%x.out
#SBATCH --error=logs/%x.err
#SBATCH --nodes 1
#SBATCH --ntasks-per-node 1
#SBATCH --gpus-per-task 8
#SBATCH --cpus-per-task 96
#SBATCH --time=72:00:00
#SBATCH --signal=USR1@600
#SBATCH --open-mode=append

# Single-node variant: one task holding the node's cards, in which torchrun
# starts one process per card (the port runs one process per card); the
# cards form the data-parallel axis (CUDA.MESH.DATA=-1: all ranks), sims on
# the node's CPUs. init_distributed reads torchrun's RANK / WORLD_SIZE /
# LOCAL_RANK / MASTER_ADDR / MASTER_PORT.
#
# The requeue signal: torchrun does not handle SIGUSR1 (its default action
# would end it) and starts each rank in a process group of its own, so the task
# starts torchrun with SIGUSR1 ignored and hands the signal to the ranks,
# whose trainers install their own handler.

CARDS=${SLURM_GPUS_ON_NODE:-$(nvidia-smi -L | wc -l)}

set -x
srun -u bash -c '
trap "" USR1
torchrun --standalone --nproc_per_node "$0" -m vlnce_torch.run \
    --exp-config vlnce_torch/config/experiments/r2r_waypoint/2-wpn-dc.yaml \
    --run-type train \
    CUDA.MESH.DATA -1 &
agent=$!
trap "pkill -USR1 -P $agent" USR1
status=0
while kill -0 "$agent" 2>/dev/null; do wait "$agent"; status=$?; done
exit "$status"
' "$CARDS"
