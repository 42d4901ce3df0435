"""The act step of the eval/inference loops (the part of
vlnce_tpu/trainers/base_trainer.py that this package has so far).

The rest of the trainer (eval-many, inference writers, checkpoints) is not
ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from vlnce_torch.ops.obs_transforms import apply_obs_transforms_batch


def make_fused_act_step(policy, transforms):
    """Obs transforms followed by `policy.act`, the counterpart of
    BaseVLNCETrainer._make_fused_act_step. The returned function takes the
    batched observations on the policy's device and returns (action [B, 1],
    new rnn_states, logits)."""

    @torch.no_grad()
    def act_step(observations, rnn_states, prev_actions, masks, deterministic: bool = False,
                 generator: Optional[torch.Generator] = None):
        batch = apply_obs_transforms_batch(observations, transforms)
        return policy.act(batch, rnn_states, prev_actions, masks, deterministic, generator)

    return act_step
