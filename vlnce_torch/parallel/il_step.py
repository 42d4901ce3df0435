"""The IL training step, on one process or data-parallel across ranks
(port of vlnce_tpu/parallel/il_step.py).

This module owns the IL update used by the production trainers: the sequence
forward of the policy, inflection-weighted cross-entropy, the aux losses,
backward and the optimizer step.

Loss bookkeeping is kept in sum/count form, as in the JAX package, so that

- across ranks (`mesh`, a `parallel/mesh.DataMesh`) the loss and the
  gradients are EXACTLY those of one process on the whole batch: the
  denominators are all_reduce'd before dividing, each rank backpropagates
  its local sum over the global count, and then the gradients of every
  trainable parameter and the three losses are summed with all_reduce (a
  mean of per-rank mean losses, as DistributedDataParallel would take,
  differs from it when the ranks hold different counts);
- env slots whose inflection weights are all zero (padding) contribute
  nothing to either loss term or to the gradients.

Inputs are time-major [T, N, ...]. `prepare_global_batch` is what the
trainers call between a rank's batch and the step: the time axis padded to
the longest of the ranks' (`global_max_time`, an all_reduce MAX), as in the
JAX package. The JAX module's `pad_batch_env_axis` and `globalize_batch`
have no job here: they pad the env axis to a per-rank shard multiple, which
is 1 for a rank of the port, and stitch the ranks' shards into one global
array, where a rank of the port keeps its shard and meets the others at the
all_reduce.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from vlnce_torch.parallel.distributed import align_collective_step, world_size
from vlnce_torch.parallel.optim import trainable_parameters
from vlnce_torch.utils.profiling import annotate


def il_loss_terms(policy, obs_tn: Dict[str, torch.Tensor], prev_tn, masks_tn, corrected, weights) -> Tuple:
    """Inflection-weighted CE + aux losses in sum/count form.

    obs_tn: dict of [T, n, ...]; prev/masks/corrected/weights: [T, n].
    Returns (action_num, action_den, aux_num, aux_den); the final losses are
    num / max(den, 1). Envs whose weights are all zero (padding) are excluded
    from both terms."""
    T, n = corrected.shape
    obs_flat = {k: v.reshape((T * n,) + tuple(v.shape[2:])) for k, v in obs_tn.items()}
    rnn_states = policy.initial_rnn_states(n)
    logits, _, aux = policy(
        obs_flat, rnn_states, prev_tn.reshape(T * n, 1), masks_tn.reshape(T * n, 1).float(), seq_len=T
    )
    log_probs = torch.log_softmax(logits.reshape(T, n, -1).float(), dim=-1)
    nll = -torch.gather(log_probs, 2, corrected[..., None].long()).squeeze(-1)

    weights = weights.float()
    w_sum = weights.sum(dim=0)  # [n]
    per_env = (weights * nll).sum(dim=0) / w_sum.clamp(min=1e-8)
    valid = (w_sum > 0).float()
    action_num = (per_env * valid).sum()
    action_den = valid.sum()

    # sum of alpha-scaled masked means, shared denominator
    # (mirrors _AuxLosses.reduce, reference aux_losses.py:24-32)
    aux_mask = (weights > 0).reshape(-1).float()
    aux_num = torch.zeros((), dtype=torch.float32, device=weights.device)
    for loss, alpha in aux.values():
        aux_num = aux_num + alpha * (loss.reshape(-1) * aux_mask).sum()
    aux_den = aux_mask.sum()
    return action_num, action_den, aux_num, aux_den


def il_losses(policy, obs_tn, prev_tn, masks_tn, corrected, weights, mesh=None) -> Tuple:
    """(loss, action_loss, aux_loss) of one [T, N] batch. With `mesh` the
    denominators are the global counts (all_reduce'd) and the losses are
    this rank's share: their sum over the ranks is the whole batch's."""
    a_num, a_den, x_num, x_den = il_loss_terms(policy, obs_tn, prev_tn, masks_tn, corrected, weights)
    if mesh is not None:
        # global counts, so every rank divides by the same denominator
        a_den, x_den = mesh.all_reduce(torch.stack([a_den, x_den])).unbind()
    action_loss = a_num / a_den.clamp(min=1.0)
    aux_loss = x_num / x_den.clamp(min=1.0)
    return action_loss + aux_loss, action_loss, aux_loss


def _no_mark(name: str) -> None:
    pass


def il_loss_and_grads(policy, optimizer, obs_tn, prev_tn, masks_tn, corrected, weights, mesh=None,
                      scale: float = 1.0, reduce_grads: bool = True,
                      mark: Callable[[str], None] = _no_mark) -> torch.Tensor:
    """Forward and backward of one batch: the gradients of loss / scale are
    added to the parameters' `.grad`. With `mesh`, the losses are summed over
    the ranks and, with `reduce_grads`, so are the optimizer's gradients (all
    of `.grad`, whatever it had accumulated). Returns [loss, action_loss,
    aux_loss] (detached) on the policy's device; `mark` gets "forward" and
    "backward". The two halves are the spans `il.forward` and
    `il.backward`."""
    with annotate("il.forward"):
        loss, action_loss, aux_loss = il_losses(policy, obs_tn, prev_tn, masks_tn, corrected, weights, mesh)
    mark("forward")
    with annotate("il.backward"):
        (loss if scale == 1.0 else loss / scale).backward()
        losses = torch.stack([loss, action_loss, aux_loss]).detach()
        if mesh is not None:
            mesh.all_reduce(losses)
            if reduce_grads:
                mesh.all_reduce_grads(trainable_parameters(optimizer))
    mark("backward")
    return losses


def build_il_train_step(policy, optimizer, mark: Callable[[str], None] = _no_mark, mesh=None) -> Callable:
    """Returns fn(obs_tn, prev[T,N], masks[T,N], corrected[T,N],
    weights[T,N]) -> (loss, action_loss, aux_loss) as detached 0-d tensors
    on the policy's device. The step updates the policy's parameters and the
    optimizer's state in place. `mark(name)` is called at the ends of
    "forward", "backward" and "optimizer" (a `StepClock.mark`, or nothing).
    With `mesh` each rank passes its own shard of the batch, and every rank
    applies the same summed gradients. The update is the span
    `il.optimizer`."""

    def train_step(obs_tn, prev_tn, masks_tn, corrected, weights):
        optimizer.zero_grad(set_to_none=True)
        losses = il_loss_and_grads(policy, optimizer, obs_tn, prev_tn, masks_tn, corrected, weights, mesh, mark=mark)
        with annotate("il.optimizer"):
            optimizer.step()
        mark("optimizer")
        return tuple(losses.unbind())

    return align_collective_step(train_step, "il_train_step") if mesh is not None else train_step


def build_il_accum_step(policy, optimizer, apply: bool, mark: Callable[[str], None] = _no_mark,
                        mesh=None) -> Callable:
    """Gradient-accumulation variant (RecollectTrainer): adds grads /
    accum_scale into the parameters' `.grad`; with `apply` it then steps the
    optimizer and clears them. The caller clears the gradients before the
    first step of a run (`optimizer.zero_grad()`). `mark` as in
    `build_il_train_step` ("optimizer" ends the step, applying or not).
    With `mesh`, the accumulated gradients are summed over the ranks once,
    in the step that applies them (the sum of the ranks' sums is the JAX
    step's sum of per-step psums)."""

    def accum_step(accum_scale, obs_tn, prev_tn, masks_tn, corrected, weights):
        losses = il_loss_and_grads(policy, optimizer, obs_tn, prev_tn, masks_tn, corrected, weights, mesh,
                                   scale=accum_scale, reduce_grads=apply, mark=mark)
        if apply:
            with annotate("il.optimizer"):
                optimizer.step()
                optimizer.zero_grad(set_to_none=True)
        mark("optimizer")
        return tuple(losses.unbind())

    return align_collective_step(accum_step, "il_accum_step") if mesh is not None else accum_step


# ------------------------------------------------------------ the global batch
def pad_time_axis(obs_tn: Dict[str, torch.Tensor], prev_tn, masks_tn, corrected, weights, t_target: int) -> Tuple:
    """Pad the time axis of a [T, N, ...] IL batch up to t_target. Padded
    steps carry zero inflection weight, so they are excluded from the loss
    exactly (the same guarantee as collate's tail padding)."""
    pad_t = t_target - corrected.shape[0]
    if pad_t == 0:
        return obs_tn, prev_tn, masks_tn, corrected, weights

    def pad(a, value=0):
        return F.pad(a, [0, 0] * (a.dim() - 1) + [0, pad_t], value=value)

    return (
        {k: pad(v) for k, v in obs_tn.items()},
        pad(prev_tn),
        pad(masks_tn, 1),  # mid-sequence semantics; loss-invisible (w=0)
        pad(corrected),
        pad(weights),
    )


def global_max_time(mesh, t_local: int) -> int:
    """The longest time axis of the ranks' batches (an all_reduce MAX of
    one integer on the CPU side of the group); `t_local` at world size 1."""
    if mesh is None or world_size() == 1:
        return t_local
    t = torch.tensor([t_local], dtype=torch.int64)
    if torch.distributed.get_backend(mesh.group) == "nccl":
        t = t.to(mesh.device)
    return int(mesh.all_reduce(t, op="max").item())


def prepare_global_batch(mesh, obs_tn, prev_tn, masks_tn, corrected, weights) -> Tuple:
    """Everything between a rank's [T, N_local, ...] batch and the step: the
    time axis padded to the longest of the ranks' (`global_max_time`).
    Identity without a mesh. DaggerTrainer and RecollectTrainer both go
    through here. (The JAX function also pads the env axis to the per-rank
    shard multiple, which is 1 for a rank of the port.)"""
    if mesh is None:
        return obs_tn, prev_tn, masks_tn, corrected, weights
    return pad_time_axis(obs_tn, prev_tn, masks_tn, corrected, weights,
                         t_target=global_max_time(mesh, int(corrected.shape[0])))
