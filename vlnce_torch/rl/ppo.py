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
inside the device update `ppo.plan` (the index matrix and its upload),
`ppo.capture` (where it captures its step), `ppo.minibatches` (the K
enqueued steps) and `ppo.update_readback`. `minibatch_steps` counts the
minibatch steps taken, `captures` and `replayed_steps` the captured step's
captures and replays.

`update_device_scan` takes the PPO batch that
`rl/device_rollout.DeviceRolloutCollector` leaves on the card ([T, B, ...]
tensors in their natural shapes): a minibatch is `index_select(1, idx)` of
it (and of hidden0 on axis 0), fed to the same `loss`, masked Adam and LR
decay. It draws the same `rng.permutation` stream as `update`
(`_minibatch_plan`), uploads the [K, n] index matrix once, enqueues all K
minibatch steps with no synchronisation between them (the JAX package runs
them as one `lax.scan` program) and reads the stats back once.

On the card `update_device_scan` captures the minibatch step (the gather,
the forward, the backward with B1's kernels, the clip and Adam) in a CUDA
graph once and replays it for every step: its index row copied in, one
replay, its six stats copied out. Adam is built `capturable`, with the
learning rate a tensor on the card that `_set_lr` fills before each
replay, and the clip range is a float64 scalar on the card filled once an
update, so linear LR and clip decay hold under replay. A training step has
side effects, so its warm-up is a real update: the step runs eagerly on
the CPU, with `eager` (for comparisons only), with a `clock` (host marks
cannot sit inside a graph), under a mesh (the all_reduce sits inside the
step, which `align_collective_step` runs), while Adam holds no state (its
first update), and at a (T, n) no eager update has run yet. The capture
itself is ops/graphs.capture. The graph is keyed to the addresses of what
it reads and writes (the batch, the policy's parameters and buffers, Adam's
state and learning rate) and keeps those tensors alive; another batch or a
new Adam state (`optimizer.state.clear()`, `load_state_dict`) captures
anew, and at most `_GRAPHS_MAX` graphs are kept.

Across ranks (`mesh`, a `parallel/mesh.DataMesh`; reference DD-PPO's
ranks) each rank minibatches its own rollouts, as in the JAX package: every
loss term is a sum over this rank's rows divided by the
global count (all_reduce'd), and the gradients and the six stats are summed
over the ranks before the clip and the Adam step, which every rank then
takes alike. Advantages are normalized per rank (`get_advantages`), as in
JAX. The JAX module's `_pad_sample` and `_globalize_sample` have no job
here: they pad a minibatch to a per-rank shard multiple, which is 1 for a
rank of the port, so every row is valid, and stitch the ranks' shards into
one global array, where a rank of the port keeps its own. The JAX
package's `update_device_scan` is single-process; across ranks the port's
takes every step eagerly, as the JAX package's `update_device` does.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from vlnce_torch.envs.batch import to_device
from vlnce_torch.envs.device_sim import upload
from vlnce_torch.models.waypoint_predictors import offset_to_continuous
from vlnce_torch.ops.graphs import cached_in, capture
from vlnce_torch.parallel.distributed import align_collective_step
from vlnce_torch.parallel.optim import masked_adam, trainable_parameters
from vlnce_torch.utils.profiling import annotate

STAT_KEYS = ("value_loss", "action_loss", "entropy_loss", "pano_entropy", "offset_entropy", "distance_entropy")
_GRAPHS_MAX = 2  # captured minibatch steps kept per agent, oldest dropped first


def _no_mark(name: str) -> None:
    pass


class WDDPPO:
    def __init__(self, policy, ppo_cfg, offset_regularize_coef: float = 0.0, pano_entropy_coef: float = 1.0,
                 offset_entropy_coef: float = 1.0, distance_entropy_coef: float = 1.0,
                 num_updates: Optional[int] = None, mesh=None, eager: bool = False):
        self.policy = policy
        self.cfg = ppo_cfg
        self.mesh = mesh
        self.offset_regularize_coef = offset_regularize_coef
        self.pano_entropy_coef = pano_entropy_coef
        self.offset_entropy_coef = offset_entropy_coef
        self.distance_entropy_coef = distance_entropy_coef
        self.num_updates = num_updates
        # capturable on the card: the learning rate and Adam's step counts live there, so that a captured
        # step replays with the rate `_set_lr` wrote
        self.optimizer = masked_adam(
            ppo_cfg.lr, policy, policy.config.MODEL, eps=ppo_cfg.eps, max_grad_norm=ppo_cfg.max_grad_norm, mesh=mesh,
            capturable=policy.device.type == "cuda",
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
        # update_device_scan's captured step: `eager` keeps every step eager (for comparisons only)
        self.eager = eager
        self._graphs: Dict[tuple, MinibatchGraph] = {}
        self._warm_shapes = set()  # the (T, n) of the eager minibatch steps taken
        self.captures = 0
        self.replayed_steps = 0  # minibatch steps taken as a replay (counted in minibatch_steps too)
        self.capture_launches: Dict[str, int] = {}  # each kernel wrapper's launches in the last capture
        self.capture_seconds = 0.0

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

    def loss(self, sample, clip_param, T: int):
        """(total loss, stats) of one minibatch on the device: tensors [T, n,
        ...] as `upload` returns them. Every mean is over the T * n rows; with
        a mesh it is this rank's sum over the global count of rows
        (all_reduce'd), so the ranks' losses sum to the whole batch's.
        `clip_param` is a float or a 0-d float64 tensor on the device (the
        captured step's), which give the same numbers: the bounds 1 -+ clip
        are formed in float64 either way and rounded to float32 by the clamp."""
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
        """The decayed learning rate for the next step: written into a
        capturable Adam's tensor (a fill on the card, read by a replay), else
        set as a float."""
        if self._lr_steps:
            lr = self.cfg.lr * (1.0 - min(self.optimizer_steps / self._lr_steps, 1.0))
            for group in self.optimizer.param_groups:
                if torch.is_tensor(group["lr"]):
                    group["lr"].fill_(lr)
                else:
                    group["lr"] = lr

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
        """The device update's plan: the env count's check, the [K, n]
        minibatch index matrix (ppo_epoch permutations of the envs, each cut
        into num_mini_batch slices, from the same `rng.permutation` stream as
        the host generator) and the clip range. Returns (T, rows,
        clip_param)."""
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

    @staticmethod
    def _gather(batch: Dict, idx: torch.Tensor) -> tuple:
        """The minibatch of env columns `idx` of the device batch, as `loss`
        takes it."""
        def take(v):
            return v.index_select(1, idx)

        return (
            {k: take(v) for k, v in batch["obs"].items()}, batch["hidden0"].index_select(0, idx),
            {k: take(v) for k, v in batch["actions"].items()}, {k: take(v) for k, v in batch["prev_actions"].items()},
            *(take(batch[k]) for k in ("value_preds", "returns", "masks", "old_log_probs", "advantages")),
        )

    def _gather_step(self, batch: Dict, idx: torch.Tensor, clip_param: float, T: int, clock=None) -> torch.Tensor:
        """The minibatch of env columns `idx` gathered from the device batch,
        then one optimizer step; with a `clock`, split into "gather",
        "forward", "backward" and "optimizer"."""
        mark: Callable[[str], None] = clock.mark if clock else _no_mark
        if clock:
            clock.start()
        sample = self._gather(batch, idx)
        mark("gather")
        self._warm_shapes.add((T, int(idx.shape[0])))
        return self._minibatch_step(sample, clip_param, T, mark)

    def _captured_step(self, batch: Dict, idx: torch.Tensor, clip: torch.Tensor, T: int) -> torch.Tensor:
        """What a MinibatchGraph holds: `_gather_step` without its host part
        (the learning rate, the counters, the clock). Returns the stats [6]."""
        stats = self._grads_and_stats(self._gather(batch, idx), clip, T)
        self.optimizer.step()
        return stats

    def _step_graph(self, batch: Dict, T: int, n: int, clock=None) -> Optional["MinibatchGraph"]:
        """The captured minibatch step for this batch, (T, n) and Adam
        state, captured now (span `ppo.capture`) where none holds them; None
        where the update runs eagerly (the module docstring's cases)."""
        if (self.eager or clock is not None or self.mesh is not None or batch["value_preds"].device.type != "cuda"
                or not self.optimizer.state or (T, n) not in self._warm_shapes):
            return None
        held = self._held_tensors(batch)

        def build() -> MinibatchGraph:
            with annotate("ppo.capture"):
                graph = MinibatchGraph(self, batch, T, n, held)
            self.captures += 1
            self.capture_launches = dict(graph.capture_launches)
            self.capture_seconds += graph.capture_seconds
            return graph

        return cached_in(self._graphs, (T, n) + tuple(t.data_ptr() for t in held), build, _GRAPHS_MAX)

    def _held_tensors(self, batch: Dict) -> tuple:
        """What a captured step reads and writes outside its graph's pool:
        the batch, the policy's parameters and buffers, Adam's state and
        learning rates."""
        leaves = [t for v in batch.values() for t in (v.values() if isinstance(v, dict) else (v,))]
        state = [t for p in trainable_parameters(self.optimizer) for t in self.optimizer.state.get(p, {}).values()
                 if torch.is_tensor(t)]
        lrs = [g["lr"] for g in self.optimizer.param_groups if torch.is_tensor(g["lr"])]
        return (*leaves, *self.policy.parameters(), *self.policy.buffers(), *state, *lrs)

    def minibatch_loop(self, batch: Dict, idx: torch.Tensor, clip_param: float, T: int, clock=None,
                       graph: Optional["MinibatchGraph"] = None) -> torch.Tensor:
        """The K minibatch steps of the index matrix idx [K, n] on the card,
        enqueued without a read-back; returns their stats [K, 6] there. With
        `graph` (`_step_graph`'s) the clip range is filled once and each step
        is one replay."""
        if graph is None:
            return torch.stack([self._gather_step(batch, idx[k], clip_param, T, clock) for k in range(idx.shape[0])])
        graph.clip.fill_(clip_param)
        stats = torch.empty((idx.shape[0], len(STAT_KEYS)), device=idx.device)
        for k in range(idx.shape[0]):
            self._set_lr()
            graph.replay(idx[k], stats[k])
            self.optimizer_steps += 1
            self.minibatch_steps += 1
            self.replayed_steps += 1
        return stats

    def update_device_scan(self, batch: Dict, rng: np.random.RandomState, update_idx: int = 0,
                           clock=None) -> Dict[str, float]:
        """The PPO update over a batch on the card: the [K, n] index matrix
        uploaded once, all K minibatch steps enqueued together, the stats'
        means read back once. On the card each step is a replay of the
        captured step, except in the module docstring's eager cases. Spans:
        `ppo.update` around `ppo.plan` (with the index upload), `ppo.capture`
        (a capture), `ppo.minibatches` and `ppo.update_readback`."""
        with annotate("ppo.update"):
            with annotate("ppo.plan"):
                T, rows, clip_param = self._minibatch_plan(batch, rng, update_idx)
                idx = upload({"idx": rows}, batch["value_preds"].device)["idx"]
            graph = self._step_graph(batch, T, rows.shape[1], clock)
            with annotate("ppo.minibatches"):
                stats = self.minibatch_loop(batch, idx, clip_param, T, clock, graph)
            with annotate("ppo.update_readback"):
                return _means(stats)


class MinibatchGraph:
    """One minibatch step of `update_device_scan` captured in a CUDA graph
    (`WDDPPO._captured_step`): the gather of the env columns in `idx` from
    the batch, the loss at the clip range in `clip`, the backward, the clip
    by global norm and Adam, its stats [6] left in `stats`. The captured
    step runs nothing: each `replay` runs it. `held` are the tensors the
    step reads and writes outside the graph's pool, kept alive so that the
    addresses that key the graph stay theirs. `capture_launches` holds each
    kernel wrapper's launches recorded by the capture: each replay runs
    them again."""

    def __init__(self, agent: WDDPPO, batch: Dict, T: int, n: int, held: tuple):
        device = batch["value_preds"].device
        self.held = held
        self.idx = torch.zeros(n, dtype=torch.long, device=device)
        self.clip = torch.zeros((), dtype=torch.float64, device=device)
        agent.optimizer.zero_grad(set_to_none=True)  # so the gradients are allocated in the graph's pool
        main = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(main)
        self.graph, self.stats, self.capture_launches, self.capture_seconds = capture(
            lambda: agent._captured_step(batch, self.idx, self.clip, T), stream=side)
        main.wait_stream(side)

    def replay(self, row: torch.Tensor, out: torch.Tensor) -> None:
        """One step on the env columns `row` [n]: the row copied in, one
        replay, its stats copied into `out` [6]; device copies only."""
        self.idx.copy_(row)
        self.graph.replay()
        out.copy_(self.stats)


def _means(stats: torch.Tensor) -> Dict[str, float]:
    """[K, 6] stats on the device -> their means by name (one read-back)."""
    return dict(zip(STAT_KEYS, stats.mean(dim=0).tolist()))
