"""The plain reference of one IL train step of the CMA policy and its Adam,
in f32: batches padded as the trajectory bank pads them, the policy run
over time from zero states, inflection-weighted cross-entropy per episode
plus the progress monitor's loss, gradients by autograd, then Adam as
torch states it (bias-corrected moments, eps outside the square root).

`compare` holds a run against the reference: each step's loss; the first
gradient by the worst leaf's gap of norms; and the parameters' change
after the steps by the median leaf's gap of norms. A leaf's gap is taken
over the larger of the reference's norm of that leaf and of the median
leaf. Leaves whose reference gradient is under a thousandth of the median
leaf's (a key's bias under softmax) move under Adam by round-off alone and
are left out of the change.

The change is held by its median leaf, not its worst: in f32, a gradient
element within rounding of nought, which Adam's first step turns into a
full step of either sign, or a ReLU input within rounding of zero, puts
one side on the other branch on a few seeds in a hundred. Either side may
take it: held against an f64 run of the same steps, the f32 reference
does so too, where the program does not. It moves the worst leaf of the change by
up to 8.5e-4, as far as the reference in TF32 moves it on some seeds,
and the median leaf by up to 3.7e-5.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from benchmark.reference import cma

NOUGHT = 1e-3  # a leaf's gradient under this share of the median leaf's is nought


def il_batch(episodes: List[Dict[str, torch.Tensor]], T: int, coef: float) -> Dict[str, torch.Tensor]:
    """Episodes (rgb [L, ...], depth [L, ...], progress [L], prev [L],
    oracle [L] and tokens [max_tokens]) padded to [T, N]: features and
    progress 1.0 and actions 0 past each length; weights coef where the
    oracle's action starts or changes, 1 elsewhere, 0 past the length."""
    N = len(episodes)
    dev = episodes[0]["rgb"].device
    out = {k: torch.ones((T, N) + tuple(episodes[0][k].shape[1:]), device=dev) for k in ("rgb", "depth")}
    out["progress"] = torch.ones(T, N, device=dev)
    prev = torch.zeros(T, N, dtype=torch.long, device=dev)
    oracle = torch.zeros(T, N, dtype=torch.long, device=dev)
    valid = torch.zeros(T, N, device=dev)
    for n, e in enumerate(episodes):
        L = e["prev"].shape[0]
        out["rgb"][:L, n] = e["rgb"].float()
        out["depth"][:L, n] = e["depth"].float()
        out["progress"][:L, n] = e["progress"].float()
        prev[:L, n] = e["prev"].long()
        oracle[:L, n] = e["oracle"].long()
        valid[:L, n] = 1.0
    change = torch.cat([torch.ones(1, N, dtype=torch.bool, device=dev), oracle[1:] != oracle[:-1]])
    masks = torch.ones(T, N, device=dev)
    masks[0] = 0.0
    out.update(prev=prev, oracle=oracle, masks=masks, weights=torch.where(change, coef, 1.0) * valid,
               tokens=torch.stack([e["tokens"] for e in episodes]))
    return out


def losses(p: Dict[str, torch.Tensor], arch: cma.Arch, b: Dict[str, torch.Tensor],
           prec: cma.Precision = cma.F32) -> Tuple[torch.Tensor, ...]:
    """(loss, action loss, progress loss) of one batch."""
    T, N = b["oracle"].shape
    emb = cma.instruction(p, b["tokens"], arch, prec)
    h1 = h2 = torch.zeros(N, arch.hidden, device=emb.device)
    logits, progress = [], []
    for t in range(T):
        lg, h1, h2, pg = cma.step(p, arch, b["rgb"][t], b["depth"][t], emb, b["prev"][t], b["masks"][t], h1, h2, prec)
        logits.append(lg)
        progress.append(pg)
    nll = -torch.log_softmax(torch.stack(logits), dim=-1).gather(2, b["oracle"][..., None])[..., 0]
    w = b["weights"]
    w_sum = w.sum(dim=0)
    per_env = (w * nll).sum(dim=0) / w_sum.clamp(min=1e-8)
    valid = (w_sum > 0).float()
    action = (per_env * valid).sum() / valid.sum().clamp(min=1.0)
    aux = torch.zeros((), device=emb.device)
    if arch.progress_monitor:
        m = (w > 0).float()
        aux = arch.pm_alpha * ((torch.stack(progress) - b["progress"]) ** 2 * m).sum() / m.sum().clamp(min=1.0)
    return action + aux, action, aux


def adam_steps(W: Dict[str, torch.Tensor], arch: cma.Arch, batches: List[Dict], lr: float, betas=(0.9, 0.999),
               eps: float = 1e-8, prec: cma.Precision = cma.F32) -> Dict:
    """Train steps from the weights W, one per batch: {"losses": [float],
    "grad": {leaf: the first step's gradient}, "delta": {leaf: the change
    after the last step}} over the trainable leaves."""
    names = [k for k in W if k in _param_names(arch) and cma.trainable(k, arch)]
    p = {k: v.detach().clone().float() for k, v in W.items()}
    m = {k: torch.zeros_like(p[k]) for k in names}
    v = {k: torch.zeros_like(p[k]) for k in names}
    out: Dict = {"losses": []}
    with cma.strict_f32():
        for t, b in enumerate(batches, start=1):
            leaves = {k: p[k].requires_grad_(True) for k in names}
            loss = losses(p, arch, b, prec)[0]
            grads = torch.autograd.grad(loss, [leaves[k] for k in names])
            out["losses"].append(float(loss.detach()))
            with torch.no_grad():
                if t == 1:
                    out["grad"] = {k: g.clone() for k, g in zip(names, grads)}
                for k, g in zip(names, grads):
                    q = p[k].detach()
                    m[k].mul_(betas[0]).add_(g, alpha=1 - betas[0])
                    v[k].mul_(betas[1]).addcmul_(g, g, value=1 - betas[1])
                    denom = (v[k].sqrt() / (1 - betas[1] ** t) ** 0.5).add_(eps)
                    p[k] = q.addcdiv(m[k], denom, value=-lr / (1 - betas[0] ** t))
    out["delta"] = {k: (p[k] - W[k].float()).detach() for k in names}
    return out


def _param_names(arch: cma.Arch):
    """The spec's parameters (its buffers hold no gradient)."""
    return {name for name, _, kind, _ in cma.param_spec(arch) if not name.endswith(("running_mean", "running_var"))}


def leaf_gaps(a: Dict[str, torch.Tensor], r: Dict[str, torch.Tensor], keep) -> Dict[str, float]:
    """Each leaf's gap of norms over the larger of its reference norm and
    the median leaf's."""
    ra = {k: float(torch.linalg.vector_norm(r[k].float())) for k in keep}
    median = float(torch.tensor(list(ra.values())).median())
    return {k: abs(float(torch.linalg.vector_norm(a[k].float())) - ra[k]) / max(ra[k], median) for k in keep}


def _median(values: Dict[str, float]) -> float:
    return float(torch.tensor(list(values.values()), dtype=torch.float64).median())


def moved_leaves(ref: Dict) -> list:
    """The leaves whose reference gradient is not nought (module docstring)."""
    g = {k: float(torch.linalg.vector_norm(v)) for k, v in ref["grad"].items()}
    median = float(torch.tensor(list(g.values())).median())
    return [k for k in g if g[k] >= NOUGHT * median]


def compare(run: Dict, ref: Dict) -> Dict[str, float]:
    """loss_gap: the largest relative gap of a step's loss; grad_gap: the
    worst leaf's gap of norms of the first gradient; update_gap_median: the
    median leaf's gap of norms of the change (module docstring)."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(run["losses"], ref["losses"]))
    return {"loss_gap": loss_gap, "grad_gap": max(leaf_gaps(run["grad"], ref["grad"], list(ref["grad"])).values()),
            "update_gap_median": _median(leaf_gaps(run["delta"], ref["delta"], moved_leaves(ref)))}
