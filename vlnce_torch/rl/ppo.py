"""PPO update for the dict-action waypoint policy (WDDPPO), single device
(port of the host path of vlnce_tpu/rl/ppo.py).

Loss parity with reference vlnce_baselines/common/ddppo_alg.py:9-149:
clipped surrogate, clipped value loss, the three per-component entropies
with their own coefficients, and the L1 offset regularizer. Each minibatch
of the rollout storage's `recurrent_generator` is uploaded through pinned
copies, run through the policy's sequence forward (`evaluate_actions(...,
seq_len=T)`, both GRUs through B1 on the card), differentiated by autograd
(B1's backward kernel is the GRUs' gradient) and applied by Adam over the
trainable parameters (`parallel/optim.masked_adam`, with the global-norm
clip `max_grad_norm`). Linear clip decay and linear LR decay follow
`update_idx` and the count of optimizer steps, as the JAX package's optax
schedule does.

The JAX module's mesh, padding and device-batch paths (`_pad_sample`,
`_globalize_sample`, `update_device`, `update_device_scan`) wait for the
port's multi-process and device-resident slices.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from vlnce_torch.envs.batch import to_device
from vlnce_torch.models.waypoint_predictors import offset_to_continuous
from vlnce_torch.parallel.optim import masked_adam

STAT_KEYS = ("value_loss", "action_loss", "entropy_loss", "pano_entropy", "offset_entropy", "distance_entropy")


def _no_mark(name: str) -> None:
    pass


class WDDPPO:
    def __init__(self, policy, ppo_cfg, offset_regularize_coef: float = 0.0, pano_entropy_coef: float = 1.0,
                 offset_entropy_coef: float = 1.0, distance_entropy_coef: float = 1.0,
                 num_updates: Optional[int] = None):
        self.policy = policy
        self.cfg = ppo_cfg
        self.offset_regularize_coef = offset_regularize_coef
        self.pano_entropy_coef = pano_entropy_coef
        self.offset_entropy_coef = offset_entropy_coef
        self.distance_entropy_coef = distance_entropy_coef
        self.num_updates = num_updates
        self.optimizer = masked_adam(
            ppo_cfg.lr, policy, policy.config.MODEL, eps=ppo_cfg.eps, max_grad_norm=ppo_cfg.max_grad_norm
        )
        # linear LR decay over optimizer steps to 0 at the last update (the
        # JAX package's optax.linear_schedule; reference use_linear_lr_decay)
        self._lr_steps = (
            num_updates * ppo_cfg.ppo_epoch * ppo_cfg.num_mini_batch
            if getattr(ppo_cfg, "use_linear_lr_decay", False) and num_updates else 0
        )
        self.optimizer_steps = 0

    # ------------------------------------------------------------- advantages
    def get_advantages(self, rollouts) -> np.ndarray:
        adv = rollouts.returns[:-1] - rollouts.value_preds[:-1]
        if not self.cfg.use_normalized_advantage:
            return adv
        return (adv - adv.mean()) / (adv.std() + 1e-5)

    def clip_param(self, update_idx: int) -> float:
        """The clip range at update `update_idx` (linear clip decay)."""
        clip_param = self.cfg.clip_param
        if getattr(self.cfg, "use_linear_clip_decay", False) and self.num_updates:
            clip_param *= max(0.0, 1.0 - update_idx / float(self.num_updates))
        return clip_param

    # ------------------------------------------------------------------ loss
    def upload(self, sample) -> tuple:
        """One host minibatch of `recurrent_generator` (numpy, without its T
        and n) onto the policy's device, one pinned asynchronous copy per
        array."""
        obs, hidden0, actions, prev_actions, *rest = sample
        names = ("value_preds", "returns", "masks", "old_log_probs", "adv_targ")
        arrays = {**{f"obs/{k}": v for k, v in obs.items()}, **{f"act/{k}": v for k, v in actions.items()},
                  **{f"prev/{k}": v for k, v in prev_actions.items()}, "hidden0": hidden0, **dict(zip(names, rest))}
        dev = to_device(arrays, self.policy.device)

        def group(prefix):
            return {k.split("/", 1)[1]: v for k, v in dev.items() if k.startswith(prefix)}

        return (group("obs/"), dev["hidden0"], group("act/"), group("prev/"), *(dev[k] for k in names))

    def loss(self, sample, clip_param: float, T: int):
        """(total loss, stats) of one minibatch on the device: tensors [T, n,
        ...] as `upload` returns them. Every mean is over the T * n rows."""
        obs, hidden0, actions, prev_actions, value_preds, returns, masks, old_log_probs, adv_targ = sample

        def flat(v):
            return v.reshape((T * v.shape[1],) + tuple(v.shape[2:]))

        actions = {k: flat(v) for k, v in actions.items()}
        value_preds, returns, masks, old_log_probs, adv_targ = (
            flat(value_preds), flat(returns), flat(masks), flat(old_log_probs), flat(adv_targ),
        )
        values, action_log_probs, entropy, _ = self.policy.evaluate_actions(
            {k: flat(v) for k, v in obs.items()}, hidden0, {k: flat(v) for k, v in prev_actions.items()}, masks,
            actions, seq_len=T,
        )

        entropy_loss = (
            self.pano_entropy_coef * entropy["pano"] + self.offset_entropy_coef * entropy["offset"]
            + self.distance_entropy_coef * entropy["distance"]
        ).mean() * self.cfg.entropy_coef

        ratio = torch.exp(action_log_probs - old_log_probs)
        surr1 = ratio * adv_targ
        surr2 = torch.clamp(ratio, 1.0 - clip_param, 1.0 + clip_param) * adv_targ
        action_loss = -torch.minimum(surr1, surr2).mean()

        if self.cfg.clip_value_loss:
            value_pred_clipped = value_preds + torch.clamp(values - value_preds, -clip_param, clip_param)
            value_loss = 0.5 * torch.maximum((values - returns) ** 2, (value_pred_clipped - returns) ** 2).mean()
        else:
            value_loss = 0.5 * ((returns - values) ** 2).mean()
        value_loss = value_loss * self.cfg.value_loss_coef

        offsets = offset_to_continuous(actions["offset"], self.policy.wypt_cfg, self.policy.num_panos)
        offset_loss = self.offset_regularize_coef * offsets.abs().mean()

        total = value_loss + action_loss + offset_loss - entropy_loss
        stats = {
            "value_loss": value_loss, "action_loss": action_loss, "entropy_loss": entropy_loss,
            "pano_entropy": entropy["pano"].mean(), "offset_entropy": entropy["offset"].mean(),
            "distance_entropy": entropy["distance"].mean(),
        }
        return total, stats

    def _set_lr(self) -> None:
        if self._lr_steps:
            frac = min(self.optimizer_steps / self._lr_steps, 1.0)
            for group in self.optimizer.param_groups:
                group["lr"] = self.cfg.lr * (1.0 - frac)

    # ------------------------------------------------------------------ update
    def update(self, rollouts, rng: np.random.RandomState, update_idx: int = 0,
               clock=None) -> Dict[str, float]:
        """`ppo_epoch` passes of `num_mini_batch` minibatches over the
        rollouts, one optimizer step each; returns the stats' means. With a
        `clock` (a `utils.profiling.StepClock`), every minibatch is one of its
        steps, split into "upload", "forward", "backward" and "optimizer"."""
        mark: Callable[[str], None] = clock.mark if clock else _no_mark
        clip_param = self.clip_param(update_idx)
        advantages = self.get_advantages(rollouts)
        all_stats = []
        for _ in range(self.cfg.ppo_epoch):
            for *arrays, T, _n in rollouts.recurrent_generator(advantages, self.cfg.num_mini_batch, rng):
                if clock:
                    clock.start()
                sample = self.upload(arrays)
                mark("upload")
                self.optimizer.zero_grad(set_to_none=True)
                total, stats = self.loss(sample, clip_param, T)
                mark("forward")
                total.backward()
                mark("backward")
                self._set_lr()
                self.optimizer.step()
                self.optimizer_steps += 1
                mark("optimizer")
                all_stats.append(torch.stack([stats[k].detach() for k in STAT_KEYS]))
        # one download of every minibatch's stats
        means = torch.stack(all_stats).mean(dim=0).tolist()
        return dict(zip(STAT_KEYS, means))
