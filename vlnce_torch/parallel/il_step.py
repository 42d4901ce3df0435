"""The IL training step on one device (port of vlnce_tpu/parallel/il_step.py).

This module owns the IL update used by the production trainers: the sequence
forward of the policy, inflection-weighted cross-entropy, the aux losses,
backward and the optimizer step.

Loss bookkeeping is kept in sum/count form, as in the JAX package, so that
env slots whose inflection weights are all zero (padding) contribute nothing
to either loss term or to the gradients, and a later multi-device step can
sum numerators and denominators across shards.

Inputs are time-major [T, N, ...]. The JAX module's `pad_batch_env_axis`,
`pad_time_axis`, `prepare_global_batch`, `globalize_batch` and
`global_max_time` shard a batch over a device mesh; they wait for the
`torch.distributed` slice, and `mesh` is no parameter here.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch


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


def il_losses(policy, obs_tn, prev_tn, masks_tn, corrected, weights) -> Tuple:
    """(loss, action_loss, aux_loss) of one [T, N] batch."""
    a_num, a_den, x_num, x_den = il_loss_terms(policy, obs_tn, prev_tn, masks_tn, corrected, weights)
    action_loss = a_num / a_den.clamp(min=1.0)
    aux_loss = x_num / x_den.clamp(min=1.0)
    return action_loss + aux_loss, action_loss, aux_loss


def _no_mark(name: str) -> None:
    pass


def build_il_train_step(policy, optimizer, mark: Callable[[str], None] = _no_mark) -> Callable:
    """Returns fn(obs_tn, prev[T,N], masks[T,N], corrected[T,N],
    weights[T,N]) -> (loss, action_loss, aux_loss) as detached 0-d tensors
    on the policy's device. The step updates the policy's parameters and the
    optimizer's state in place. `mark(name)` is called at the ends of
    "forward", "backward" and "optimizer" (a `StepClock.mark`, or nothing)."""

    def train_step(obs_tn, prev_tn, masks_tn, corrected, weights):
        optimizer.zero_grad(set_to_none=True)
        loss, action_loss, aux_loss = il_losses(policy, obs_tn, prev_tn, masks_tn, corrected, weights)
        mark("forward")
        loss.backward()
        mark("backward")
        optimizer.step()
        mark("optimizer")
        return loss.detach(), action_loss.detach(), aux_loss.detach()

    return train_step


def build_il_accum_step(policy, optimizer, apply: bool, mark: Callable[[str], None] = _no_mark) -> Callable:
    """Gradient-accumulation variant (RecollectTrainer): adds grads /
    accum_scale into the parameters' `.grad`; with `apply` it then steps the
    optimizer and clears them. The caller clears the gradients before the
    first step of a run (`optimizer.zero_grad()`). `mark` as in
    `build_il_train_step` ("optimizer" ends the step, applying or not)."""

    def accum_step(accum_scale, obs_tn, prev_tn, masks_tn, corrected, weights):
        loss, action_loss, aux_loss = il_losses(policy, obs_tn, prev_tn, masks_tn, corrected, weights)
        mark("forward")
        (loss / accum_scale).backward()
        mark("backward")
        if apply:
            optimizer.step()
            optimizer.zero_grad(set_to_none=True)
        mark("optimizer")
        return loss.detach(), action_loss.detach(), aux_loss.detach()

    return accum_step
