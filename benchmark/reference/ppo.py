"""The plain reference of the waypoint policy's DD-PPO update (the
reference repo's `vlnce_baselines/common/ddppo_alg.py`, PPO of Schulman et
al. 2017 with the DD-PPO recurrent minibatching of Wijmans et al. 2020), in
plain PyTorch and f32: GAE, the minibatch plan, the loss, the gradient's
global-norm clip and Adam.

- `gae`: the returns of a rollout, generalised advantage estimation from
  the last value of the bootstrap.
- `minibatch_plan`: `ppo_epoch` permutations of the rollout's envs, each
  cut into `num_mini_batch` slices: a minibatch is every step of a slice's
  envs, in time order, their recurrent state carried from the rollout's
  first step (the recurrent generator of the reference).
- `loss`: the clipped surrogate, the clipped value loss times its
  coefficient, the pano, offset and distance entropies with their
  coefficients times the entropy coefficient, and the L1 offset
  regulariser (a constant of the batch).
- `_step`: one minibatch step: forward and backward of the trainable
  parts, the gradients scaled to a global norm of at most `max_grad_norm`,
  then Adam as torch states it.
- `steps`: each minibatch step of one update from the state a run held
  before it (its weights and Adam's moments), so that each step is held
  to the run's at the rounding of one step; `update`: every step in turn
  from the given weights, which shows what carries from step to step.
- `compare`: a run's numbers against the reference's.

The frozen backbones' features of a frame do not change during an
update, so `steps` and `update` take them computed once per rollout
(`waypoint.encode_steps`); the program recomputes them in every
minibatch. That changes no value. Departure from the reference repo: its
optimiser is torch's Adam over every parameter, which skips those
without a gradient; here Adam runs over the trainable ones alone, the
same steps.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.reference import cma, waypoint
from benchmark.reference.train import NOUGHT, _median, leaf_gaps


def gae(rewards, values, masks_next, next_value, gamma: float, tau: float) -> torch.Tensor:
    """rewards, values, masks_next [T, B]; next_value [B] -> returns [T, B]:
    delta_t = r_t + gamma V_{t+1} m_t - V_t, A_t = delta_t + gamma tau m_t
    A_{t+1}, returns A_t + V_t."""
    T = rewards.shape[0]
    adv = torch.zeros_like(next_value)
    out = [None] * T
    for t in reversed(range(T)):
        v_next = values[t + 1] if t + 1 < T else next_value
        delta = rewards[t] + gamma * v_next * masks_next[t] - values[t]
        adv = delta + gamma * tau * masks_next[t] * adv
        out[t] = adv + values[t]
    return torch.stack(out)


def minibatch_plan(num_envs: int, ppo_epoch: int, num_mini_batch: int, rng: np.random.RandomState) -> np.ndarray:
    """[ppo_epoch * num_mini_batch, num_envs // num_mini_batch] env indices."""
    per = num_envs // num_mini_batch
    rows = []
    for _ in range(ppo_epoch):
        perm = rng.permutation(num_envs)
        rows += [perm[k * per : (k + 1) * per] for k in range(num_mini_batch)]
    return np.asarray(rows, np.int64)


def loss(p: Dict[str, torch.Tensor], arch: waypoint.Arch, mb: Dict, cfg: Dict, clip: float,
         prec: cma.Precision = cma.F32, unclipped: bool = False) -> torch.Tensor:
    """The PPO loss of one minibatch (mb: the rollout's tensors [T, n, ...]
    at the minibatch's envs, with the frames' features `rgb_f`, `depth_f`
    and the instruction encodings' tokens). `unclipped` leaves the
    probability ratio unclipped (a planted fault)."""
    T, n = mb["masks"].shape
    emb = cma.instruction(p, mb["instruction"].reshape(T * n, -1), arch.instr, prec).reshape(T, n, 2 * arch.instr_hidden, -1)
    out = waypoint.sequence(p, arch, mb["rgb_f"], mb["depth_f"], emb, mb["prev_actions"], mb["masks"],
                            mb["angle_features"], mb["hidden0"], prec)
    logp, ent = waypoint.evaluate(out, mb["actions"], arch)
    values = out["value"]
    entropy = (cfg["pano_entropy_coef"] * ent["pano"] + cfg["offset_entropy_coef"] * ent["offset"]
               + cfg["distance_entropy_coef"] * ent["distance"]).mean() * cfg["entropy_coef"]
    ratio = torch.exp(logp - mb["old_log_probs"])
    adv = mb["advantages"]
    clipped = ratio if unclipped else torch.clamp(ratio, 1.0 - clip, 1.0 + clip)
    action = -torch.minimum(ratio * adv, clipped * adv).mean()
    v_old, ret = mb["value_preds"], mb["returns"]
    if cfg["clip_value_loss"]:
        v_clipped = v_old + torch.clamp(values - v_old, -clip, clip)
        value = 0.5 * torch.maximum((values - ret) ** 2, (v_clipped - ret) ** 2).mean()
    else:
        value = 0.5 * ((ret - values) ** 2).mean()
    offset = cfg["offset_regularize_coef"] * mb["actions"]["offset"].abs().mean()
    return value * cfg["value_loss_coef"] + action + offset - entropy


def _take(batch: Dict, idx: torch.Tensor) -> Dict:
    """The rollout's tensors at the envs `idx` (axis 1; hidden0's axis 0)."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, dict):
            out[k] = {a: b.index_select(1, idx) for a, b in v.items()}
        else:
            out[k] = v.index_select(0 if k == "hidden0" else 1, idx)
    return out


def trainable_names(arch: waypoint.Arch) -> List[str]:
    return [name for name, _, _, _ in waypoint.param_spec(arch) if waypoint.trainable(name)]


def _step(p: Dict[str, torch.Tensor], names: List[str], arch: waypoint.Arch, mb: Dict, cfg: Dict,
          m: Dict[str, torch.Tensor], v: Dict[str, torch.Tensor], t: int, prec: cma.Precision, unclipped: bool):
    """One minibatch step from the leaves `p` and Adam's moments m, v of
    t - 1 steps (updated in place): the loss, the gradients scaled to a
    global norm of at most `max_grad_norm`, and the leaves after Adam as
    torch states it. Returns (loss, {leaf: clipped gradient}, {leaf: new
    value})."""
    leaves = {k: p[k].detach().requires_grad_(True) for k in names}
    total = loss({**p, **leaves}, arch, mb, cfg, cfg["clip_param"], prec, unclipped)
    grads = torch.autograd.grad(total, [leaves[k] for k in names])
    b1, b2 = cfg["betas"]
    new = {}
    with torch.no_grad():
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        scale = cfg["max_grad_norm"] / torch.clamp(norm, min=cfg["max_grad_norm"])
        grads = [g * scale for g in grads]
        for k, g in zip(names, grads):
            m[k].mul_(b1).add_(g, alpha=1 - b1)
            v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v[k].sqrt() / (1 - b2**t) ** 0.5).add_(cfg["eps"])
            new[k] = p[k].detach().addcdiv(m[k], denom, value=-cfg["lr"] / (1 - b1**t))
    return float(total.detach()), dict(zip(names, grads)), new


def update(W: Dict[str, torch.Tensor], arch: waypoint.Arch, batch: Dict, rows: np.ndarray, cfg: Dict,
           prec: cma.Precision = cma.F32, unclipped: bool = False) -> Dict[str, torch.Tensor]:
    """Every minibatch step of `rows` in turn from the weights W over the
    rollout `batch` (`loss`'s tensors [T, B, ...]), Adam from nothing:
    {leaf: the change after the last step} over the trainable leaves."""
    names = trainable_names(arch)
    p = {k: w.detach().float() for k, w in W.items()}
    m = {k: torch.zeros_like(p[k]) for k in names}
    v = {k: torch.zeros_like(p[k]) for k in names}
    with cma.strict_f32():
        for t, row in enumerate(rows, start=1):
            _, _, new = _step(p, names, arch, _take(batch, torch.as_tensor(row, device=batch["masks"].device)), cfg,
                              m, v, t, prec, unclipped)
            p.update(new)
    return {k: (p[k] - W[k].float()).detach() for k in names}


def steps(W: Dict[str, torch.Tensor], arch: waypoint.Arch, batch: Dict, rows: np.ndarray, cfg: Dict, states: List[Dict],
          prec: cma.Precision = cma.F32, unclipped: bool = False) -> Dict[str, list]:
    """Each minibatch step of `rows` taken from the state a run held
    before it (`states[k]`: {"before": {leaf: value}, "adam": {leaf:
    {"exp_avg", "exp_avg_sq", "step"}}}, no entry before Adam's first
    step), the frozen leaves from W: {"losses": [each step's loss],
    "grads": [{leaf: its clipped gradient}], "changes": [{leaf: its
    change}]}. Each step is held to the run's from the same state, so a
    gap does not carry into the next steps."""
    names = trainable_names(arch)
    frozen = {k: w.detach().float() for k, w in W.items()}
    out: Dict[str, list] = {"losses": [], "grads": [], "changes": []}
    with cma.strict_f32():
        for row, state in zip(rows, states):
            p = {**frozen, **{k: state["before"][k].float() for k in names}}
            adam = state["adam"]
            m = {k: adam[k]["exp_avg"].float().clone() if k in adam else torch.zeros_like(p[k]) for k in names}
            v = {k: adam[k]["exp_avg_sq"].float().clone() if k in adam else torch.zeros_like(p[k]) for k in names}
            t = int(adam[names[0]]["step"]) + 1 if adam else 1
            total, grads, new = _step(p, names, arch, _take(batch, torch.as_tensor(row, device=batch["masks"].device)),
                                      cfg, m, v, t, prec, unclipped)
            out["losses"].append(total)
            out["grads"].append(grads)
            out["changes"].append({k: new[k] - p[k] for k in names})
    return out


def vector_gaps(a: Dict[str, torch.Tensor], r: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each leaf's norm of the difference over the larger of its reference
    norm and the median leaf's."""
    ra = {k: float(torch.linalg.vector_norm(r[k].float())) for k in r}
    median = float(torch.tensor(list(ra.values())).median())
    return {k: float(torch.linalg.vector_norm(a[k].float() - r[k].float())) / max(ra[k], median, 1e-30) for k in r}


def moved_leaves(ref: Dict) -> List[str]:
    """The leaves whose first reference gradient is not nought (a
    thousandth of the median leaf's norm): under Adam, the others move by
    round-off alone."""
    g = {k: float(torch.linalg.vector_norm(v)) for k, v in ref["grads"][0].items()}
    median = float(torch.tensor(list(g.values())).median())
    return [k for k in g if g[k] >= NOUGHT * median]


def compare(run: Dict, ref: Dict) -> Dict[str, float]:
    """A run's update against the reference's. Each step from the run's
    own state before it (`steps`): loss_gap, the largest relative gap of a
    step's loss (over the larger of its magnitude and the median step's,
    since a PPO loss can pass through 0); grad_gap and step_gap, the largest
    over the steps of the median leaf's relative gap (`vector_gaps`) of the
    clipped gradient and of the step's change. The whole update from the
    same weights (`update`): update_gap_median, the median leaf's gap of
    norms of the change after the last step, over the leaves `moved_leaves`
    keeps (reference/train.py's leaf gaps)."""
    scale = max(float(np.median(np.abs(ref["losses"]))), 1e-12)
    loss_gap = max(abs(a - b) / max(abs(b), scale) for a, b in zip(run["losses"], ref["losses"]))
    return {"loss_gap": loss_gap,
            "grad_gap": max(_median(vector_gaps(a, r)) for a, r in zip(run["grads"], ref["grads"])),
            "step_gap": max(_median(vector_gaps(a, r)) for a, r in zip(run["changes"], ref["changes"])),
            "update_gap_median": _median(leaf_gaps(run["delta"], ref["delta"], moved_leaves(ref)))}
