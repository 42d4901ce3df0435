"""PPO update for the dict-action waypoint policy (WDDPPO), on one process
or data-parallel across ranks (port of vlnce_tpu/rl/ppo.py).

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

Spans (`utils/profiling.annotate`): `ppo.update` around each update;
inside the device updates `ppo.plan` (the index matrix, and its upload in
`update_device_scan`), `ppo.minibatches` (the K enqueued steps) and
`ppo.update_readback`. `minibatch_steps` counts the minibatch steps taken.

`update_device` and `update_device_scan` take the PPO batch that
`rl/device_rollout.DeviceRolloutCollector` leaves on the card ([T, B, ...]
tensors in their natural shapes): a minibatch is `index_select(1, idx)` of
it (and of hidden0 on axis 0), fed to the same `loss`, masked Adam and LR
decay. Both draw the same `rng.permutation` stream as `update` (one
`_minibatch_plan`) and read the stats back once. They differ in how the host
meets the card: `update_device` uploads each minibatch's env indices as it
comes, a pageable copy that waits for the card to finish the minibatches
before it, while `update_device_scan` uploads the [K, n] index matrix once
and enqueues all K minibatch steps with no synchronisation between them
(the JAX package runs them as one `lax.scan` program; capturing the step in
a CUDA graph is not done here).

Across ranks (`mesh`, a `parallel/mesh.DataMesh`; reference DD-PPO's
ranks) each rank minibatches its own rollouts, as in the JAX package: every
loss term is a sum over this rank's rows divided by the
global count (all_reduce'd), and the gradients and the six stats are summed
over the ranks before the clip and the Adam step, which every rank then
takes alike. Advantages are normalized per rank (`get_advantages`), as in
JAX. The JAX module's `_pad_sample` and `_globalize_sample` have no job
here: they pad a minibatch to a per-rank shard multiple, which is 1 for a
rank of the port, so every row is valid, and stitch the ranks' shards into
one global array, where a rank of the port keeps its own.
`update_device_scan` stays single-process, as the JAX one does.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from vlnce_torch.envs.batch import to_device
from vlnce_torch.envs.device_sim import upload
from vlnce_torch.models.waypoint_predictors import offset_to_continuous
from vlnce_torch.parallel.distributed import align_collective_step, world_size
from vlnce_torch.parallel.optim import masked_adam, trainable_parameters
from vlnce_torch.utils.profiling import annotate

STAT_KEYS = ("value_loss", "action_loss", "entropy_loss", "pano_entropy", "offset_entropy", "distance_entropy")


def _no_mark(name: str) -> None:
    pass


class WDDPPO:
    def __init__(self, policy, ppo_cfg, offset_regularize_coef: float = 0.0, pano_entropy_coef: float = 1.0,
                 offset_entropy_coef: float = 1.0, distance_entropy_coef: float = 1.0,
                 num_updates: Optional[int] = None, mesh=None):
        self.policy = policy
        self.cfg = ppo_cfg
        self.mesh = mesh
        self.offset_regularize_coef = offset_regularize_coef
        self.pano_entropy_coef = pano_entropy_coef
        self.offset_entropy_coef = offset_entropy_coef
        self.distance_entropy_coef = distance_entropy_coef
        self.num_updates = num_updates
        self.optimizer = masked_adam(
            ppo_cfg.lr, policy, policy.config.MODEL, eps=ppo_cfg.eps, max_grad_norm=ppo_cfg.max_grad_norm, mesh=mesh
        )
        self._minibatch_step = self._step if mesh is None else align_collective_step(self._step, "wddppo_step")
        # linear LR decay over optimizer steps to 0 at the last update (the
        # JAX package's optax.linear_schedule; reference use_linear_lr_decay)
        self._lr_steps = (
            num_updates * ppo_cfg.ppo_epoch * ppo_cfg.num_mini_batch
            if getattr(ppo_cfg, "use_linear_lr_decay", False) and num_updates else 0
        )
        self.optimizer_steps = 0
        self.minibatch_steps = 0  # the minibatch steps this process has taken (optimizer_steps resumes a count)

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
        ...] as `upload` returns them. Every mean is over the T * n rows; with
        a mesh it is this rank's sum over the global count of rows
        (all_reduce'd), so the ranks' losses sum to the whole batch's."""
        obs, hidden0, actions, prev_actions, value_preds, returns, masks, old_log_probs, adv_targ = sample
        if self.mesh is None:
            def mmean(x):
                return x.mean()
        else:
            rows = torch.tensor(float(value_preds.shape[0] * value_preds.shape[1]), device=value_preds.device)
            count = self.mesh.all_reduce(rows)

            def mmean(x):
                return x.sum() / count

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

        entropy_loss = mmean(
            self.pano_entropy_coef * entropy["pano"] + self.offset_entropy_coef * entropy["offset"]
            + self.distance_entropy_coef * entropy["distance"]
        ) * self.cfg.entropy_coef

        ratio = torch.exp(action_log_probs - old_log_probs)
        surr1 = ratio * adv_targ
        surr2 = torch.clamp(ratio, 1.0 - clip_param, 1.0 + clip_param) * adv_targ
        action_loss = -mmean(torch.minimum(surr1, surr2))

        if self.cfg.clip_value_loss:
            value_pred_clipped = value_preds + torch.clamp(values - value_preds, -clip_param, clip_param)
            value_loss = 0.5 * mmean(torch.maximum((values - returns) ** 2, (value_pred_clipped - returns) ** 2))
        else:
            value_loss = 0.5 * mmean((returns - values) ** 2)
        value_loss = value_loss * self.cfg.value_loss_coef

        offsets = offset_to_continuous(actions["offset"], self.policy.wypt_cfg, self.policy.num_panos)
        offset_loss = self.offset_regularize_coef * mmean(offsets.abs())

        total = value_loss + action_loss + offset_loss - entropy_loss
        stats = {
            "value_loss": value_loss, "action_loss": action_loss, "entropy_loss": entropy_loss,
            "pano_entropy": mmean(entropy["pano"]), "offset_entropy": mmean(entropy["offset"]),
            "distance_entropy": mmean(entropy["distance"]),
        }
        return total, stats

    def _set_lr(self) -> None:
        if self._lr_steps:
            frac = min(self.optimizer_steps / self._lr_steps, 1.0)
            for group in self.optimizer.param_groups:
                group["lr"] = self.cfg.lr * (1.0 - frac)

    def _grads_and_stats(self, sample, clip_param: float, T: int,
                         mark: Callable[[str], None] = _no_mark) -> torch.Tensor:
        """Forward and backward of one minibatch into the parameters'
        `.grad`; with a mesh, the gradients and the stats summed over the
        ranks (the core that the update and the cross-rank parity checks
        share). Returns the stats [6] on the device."""
        total, stats = self.loss(sample, clip_param, T)
        mark("forward")
        total.backward()
        stats = torch.stack([stats[k].detach() for k in STAT_KEYS])
        if self.mesh is not None:
            # the losses are local sums over the global count: the sum completes the mean
            self.mesh.all_reduce_grads(trainable_parameters(self.optimizer))
            self.mesh.all_reduce(stats)
        mark("backward")
        return stats

    def _step(self, sample, clip_param: float, T: int, mark: Callable[[str], None]) -> torch.Tensor:
        """One optimizer step on a minibatch on the device; returns its stats
        [6] on the device."""
        self.optimizer.zero_grad(set_to_none=True)
        stats = self._grads_and_stats(sample, clip_param, T, mark)
        self._set_lr()
        self.optimizer.step()
        self.optimizer_steps += 1
        self.minibatch_steps += 1
        mark("optimizer")
        return stats

    # ------------------------------------------------------------------ update
    def update(self, rollouts, rng: np.random.RandomState, update_idx: int = 0,
               clock=None) -> Dict[str, float]:
        """`ppo_epoch` passes of `num_mini_batch` minibatches over the
        rollouts, one optimizer step each; returns the stats' means. With a
        `clock` (a `utils.profiling.StepClock`), every minibatch is one of its
        steps, split into "upload", "forward", "backward" and "optimizer"."""
        mark: Callable[[str], None] = clock.mark if clock else _no_mark
        with annotate("ppo.update"):
            clip_param = self.clip_param(update_idx)
            advantages = self.get_advantages(rollouts)
            all_stats = []
            for _ in range(self.cfg.ppo_epoch):
                for *arrays, T, _n in rollouts.recurrent_generator(advantages, self.cfg.num_mini_batch, rng):
                    if clock:
                        clock.start()
                    sample = self.upload(arrays)
                    mark("upload")
                    all_stats.append(self._minibatch_step(sample, clip_param, T, mark))
            # one download of every minibatch's stats
            return _means(torch.stack(all_stats))

    # --------------------------------------------------- update (device batch)
    def _minibatch_plan(self, batch: Dict, rng: np.random.RandomState, update_idx: int):
        """What update_device and update_device_scan share: the env count's
        check, the [K, n] minibatch index matrix (ppo_epoch permutations of
        the envs, each cut into num_mini_batch slices, from the same
        `rng.permutation` stream as the host generator) and the clip range.
        Returns (T, rows, clip_param)."""
        T, N = batch["value_preds"].shape[:2]
        if N < self.cfg.num_mini_batch:
            raise ValueError(f"num_envs ({N}) must be >= RL.PPO.num_mini_batch ({self.cfg.num_mini_batch}), the "
                             f"host recurrent generator's constraint")
        envs_per_batch = N // self.cfg.num_mini_batch
        rows = []
        for _ in range(self.cfg.ppo_epoch):
            perm = rng.permutation(N)
            for start in range(0, envs_per_batch * self.cfg.num_mini_batch, envs_per_batch):
                rows.append(perm[start : start + envs_per_batch])
        return T, np.asarray(rows, np.int64), self.clip_param(update_idx)

    def _gather_step(self, batch: Dict, idx: torch.Tensor, clip_param: float, T: int, clock=None) -> torch.Tensor:
        """The minibatch of env columns `idx` gathered from the device batch,
        then one optimizer step; with a `clock`, split into "gather",
        "forward", "backward" and "optimizer"."""
        mark: Callable[[str], None] = clock.mark if clock else _no_mark
        if clock:
            clock.start()

        def take(v):
            return v.index_select(1, idx)

        sample = (
            {k: take(v) for k, v in batch["obs"].items()}, batch["hidden0"].index_select(0, idx),
            {k: take(v) for k, v in batch["actions"].items()}, {k: take(v) for k, v in batch["prev_actions"].items()},
            *(take(batch[k]) for k in ("value_preds", "returns", "masks", "old_log_probs", "advantages")),
        )
        mark("gather")
        return self._minibatch_step(sample, clip_param, T, mark)

    def update_device(self, batch: Dict, rng: np.random.RandomState, update_idx: int = 0,
                      clock=None) -> Dict[str, float]:
        """The PPO update over a batch on the card, one minibatch's indices
        uploaded at a time; the stats read back once. Spans: `ppo.update`
        around `ppo.plan`, `ppo.minibatches` and `ppo.update_readback`."""
        with annotate("ppo.update"):
            with annotate("ppo.plan"):
                T, rows, clip_param = self._minibatch_plan(batch, rng, update_idx)
            device = batch["value_preds"].device
            with annotate("ppo.minibatches"):
                all_stats = torch.stack([self._gather_step(batch, torch.from_numpy(row).to(device), clip_param, T, clock)
                                         for row in rows])
            with annotate("ppo.update_readback"):
                return _means(all_stats)

    def minibatch_loop(self, batch: Dict, idx: torch.Tensor, clip_param: float, T: int, clock=None) -> torch.Tensor:
        """The K minibatch steps of the index matrix idx [K, n] on the card,
        enqueued without a read-back; returns their stats [K, 6] there."""
        return torch.stack([self._gather_step(batch, idx[k], clip_param, T, clock) for k in range(idx.shape[0])])

    def update_device_scan(self, batch: Dict, rng: np.random.RandomState, update_idx: int = 0,
                           clock=None) -> Dict[str, float]:
        """The PPO update over a batch on the card with the [K, n] index
        matrix uploaded once and all K minibatch steps enqueued together; the
        minibatches are update_device's, and so are the stats (one
        read-back). Single-process only, as in the JAX package. Spans as
        update_device's; the plan holds the index upload."""
        if world_size() > 1:
            raise RuntimeError("CUDA.PPO_UPDATE_SCAN is single-process; under several ranks use update_device")
        with annotate("ppo.update"):
            with annotate("ppo.plan"):
                T, rows, clip_param = self._minibatch_plan(batch, rng, update_idx)
                idx = upload({"idx": rows}, batch["value_preds"].device)["idx"]
            with annotate("ppo.minibatches"):
                stats = self.minibatch_loop(batch, idx, clip_param, T, clock)
            with annotate("ppo.update_readback"):
                return _means(stats)


def _means(stats: torch.Tensor) -> Dict[str, float]:
    """[K, 6] stats on the device -> their means by name (one read-back)."""
    return dict(zip(STAT_KEYS, stats.mean(dim=0).tolist()))
