"""Optimizer construction for the IL trainers (port of
vlnce_tpu/parallel/optim.py).

Frozen-parameter masking: the reference hands ALL policy parameters to torch
Adam (reference base_il_trainer.py:69-70), and torch skips parameters whose
.grad is None, i.e. the frozen ResNets (resnet_encoders.py:45-46,141-143) and
the frozen instruction-embedding table never get optimizer state or update
traffic. `masked_adam` makes that explicit: `torch.optim.Adam` is built over
the trainable parameters only, so the frozen ones (about 90% of the CMA
policy's bytes) hold no moment buffers and are bit-equal after any number of
steps.

`restore_optim_state` of the JAX package migrates flax checkpoints written
before it masked its optimizer. The port has no such files: its checkpoints
hold `optimizer.state_dict()`, which `load_state_dict` restores as it is, so
there is nothing to migrate. `load_optim_state` restores either that or the
Adam state of a JAX checkpoint, which `utils/checkpoints.load_checkpoint`
hands over keyed by parameter name (`{"optax_adam": ...}`).

Across ranks (`mesh`): the step is replicated. `masked_adam` broadcasts the
initial parameters and buffers from rank 0, the gradients it clips are the
all_reduce'd sums (`parallel/mesh.DataMesh.all_reduce_grads`, called
before `step()`), so every rank clips the same gradient and takes the same Adam
step, and after the first step it checks that the ranks' parameters agree.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

# Frozen subtrees are matched by state_dict PREFIX anchors (the JAX package's
# (parent key, child key) path anchors), not by bare names at any depth: a
# future module that happens to reuse "cnn" or "visual_encoder" under another
# parent cannot be frozen silently.
_FROZEN_ANCHORS = {
    "depth": "net.depth_encoder.visual_encoder.",
    "rgb": "net.rgb_encoder.cnn.",
    "embedding": "net.instruction_encoder.embedding",
}


def trainable_mask(policy, model_config) -> Dict[str, bool]:
    """{parameter name: True where Adam updates it} over
    `policy.named_parameters()`.

    `model_config=None` (a stub policy with no config) means no freezing
    information: every parameter trains, matching plain Adam.

    Fails LOUDLY when the config freezes an encoder whose anchored prefix
    matches no parameter (a renamed module would otherwise silently train
    weights the reference keeps frozen)."""
    names = [name for name, _ in policy.named_parameters()]
    if model_config is None:
        return {name: True for name in names}

    want = {}
    if not bool(model_config.DEPTH_ENCODER.trainable):
        want["depth"] = _FROZEN_ANCHORS["depth"]
    if not bool(model_config.RGB_ENCODER.trainable):
        want["rgb"] = _FROZEN_ANCHORS["rgb"]
    # only a PRETRAINED embedding table is frozen (reference
    # instruction_encoder.py:35-45); a fresh Gaussian table always trains.
    # An encoder of precomputed features (sensor_uuid rxr_instruction) has no
    # table, so there is nothing to freeze and nothing to miss: the JAX
    # package's mask raises for such a config, which keeps its trainers from
    # building an RxR policy; the port serves RxR and must not.
    ie = model_config.INSTRUCTION_ENCODER
    has_table = getattr(ie, "sensor_uuid", "instruction") == "instruction"
    if has_table and bool(getattr(ie, "use_pretrained_embeddings", False)) and not bool(getattr(ie, "fine_tune_embeddings", True)):
        want["embedding"] = _FROZEN_ANCHORS["embedding"]

    mask = {name: not any(name.startswith(prefix) for prefix in want.values()) for name in names}
    missing = [prefix for prefix in want.values() if not any(name.startswith(prefix) for name in names)]
    if missing:
        raise ValueError(
            f"trainable_mask: config freezes {sorted(missing)} but no parameter has such a prefix "
            f"(top-level modules: {sorted({n.split('.')[0] for n in names})[:8]}): a renamed module would "
            f"silently train weights the reference keeps frozen (resnet_encoders.py:45-46,141-143)"
        )
    return mask


def clip_by_global_norm_(parameters, max_norm: float) -> torch.Tensor:
    """Scale the gradients in place by max_norm / max(norm, max_norm), norm
    being the l2 norm over all of them (optax's clip_by_global_norm); returns
    the norm before scaling."""
    grads = [p.grad for p in parameters if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    scale = max_norm / torch.clamp(norm, min=max_norm)
    torch._foreach_mul_(grads, scale)
    return norm


def trainable_parameters(optimizer) -> list:
    """The optimizer's parameters, in its order (the same on every rank)."""
    return [p for group in optimizer.param_groups for p in group["params"]]


def broadcast_parameters(module: torch.nn.Module, mesh) -> None:
    """Every parameter and buffer of `module` from rank 0, in place."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            mesh.broadcast(t.data, 0)


def check_replicas_agree(module: torch.nn.Module, mesh, tag: str) -> None:
    """Raise unless every rank holds the same parameters: one all_reduce MAX
    of each parameter's f64 sum and of its negation (their max and min)."""
    names, params = zip(*module.named_parameters())
    sums = torch.stack([p.detach().double().sum() for p in params])
    both = mesh.all_reduce(torch.cat([sums, -sums]), op="max")
    differ = [name for name, hi, lo in zip(names, both[: len(names)].tolist(), (-both[len(names):]).tolist()) if hi != lo]
    if differ:
        raise RuntimeError(f"{tag}: the ranks' parameters differ after the first update ({len(differ)} of "
                           f"{len(names)}, first {differ[:3]}): the replicas diverged")


def masked_adam(lr: float, policy, model_config, eps: float = 1e-8,
                max_grad_norm: Optional[float] = None, mesh=None, capturable: bool = False) -> torch.optim.Adam:
    """Adam over the policy's trainable parameters only. The frozen ones get
    `requires_grad_(False)`, so backward computes no gradient for them and
    they hold no optimizer state. With max_grad_norm, every `step()` first
    clips the gradients by their global norm (the frozen parameters have
    none, so the norm is the trainable-only norm). With `mesh`, rank 0's
    parameters and buffers are broadcast now, and the first `step()` checks
    afterwards that the ranks agree; the caller sums the gradients over the
    ranks before each `step()`.

    `capturable` (parameters on CUDA) builds Adam with `capturable=True` and
    the learning rate a 0-d tensor on the parameters' device, so that a CUDA
    graph can capture `step()` and replay it with the rate written into
    that tensor since. `load_state_dict` keeps that form (and a
    non-capturable optimizer its float rate), whichever optimizer saved the
    state."""
    mask = trainable_mask(policy, model_config)
    trainable = []
    for name, p in policy.named_parameters():
        p.requires_grad_(mask[name])
        if mask[name]:
            trainable.append(p)
    rate = torch.tensor(float(lr), device=trainable[0].device) if capturable else lr
    optimizer = torch.optim.Adam(trainable, lr=rate, eps=eps, capturable=capturable)
    if capturable:  # the steps before a capture run eagerly by design: no misuse to warn of
        optimizer._warned_capturable_if_run_uncaptured = True

    def keep_form(opt) -> None:
        for group in opt.param_groups:
            group["capturable"] = capturable
            if capturable:
                if group["lr"] is not rate:  # the saved rate, into this optimizer's tensor
                    rate.copy_(torch.as_tensor(group["lr"]))
                    group["lr"] = rate
                for p in group["params"]:
                    state = opt.state.get(p)
                    if state and torch.is_tensor(state.get("step")):
                        state["step"] = state["step"].to(device=p.device, dtype=torch.float32)
            elif torch.is_tensor(group["lr"]):
                group["lr"] = float(group["lr"])

    optimizer.register_load_state_dict_post_hook(keep_form)
    if max_grad_norm is not None:
        def clip(opt, args, kwargs) -> None:
            # the norm stays on the device: testing its truth would read it back
            clip_by_global_norm_(trainable, max_grad_norm)

        optimizer.register_step_pre_hook(clip)
    if mesh is not None:
        broadcast_parameters(policy, mesh)

        def check_once(opt, args, kwargs) -> None:
            handle.remove()
            check_replicas_agree(policy, mesh, "masked_adam")

        handle = optimizer.register_step_post_hook(check_once)
    return optimizer


def load_optim_state(optimizer: torch.optim.Optimizer, policy, optim_state: Dict) -> None:
    """Restore a checkpoint's optimizer state into `optimizer`, which was
    built over `policy`'s parameters (`masked_adam`).

    A port checkpoint holds `optimizer.state_dict()` and is loaded as it is.
    A JAX checkpoint's optax Adam state (`{"optax_adam": {"step", "exp_avg",
    "exp_avg_sq", "moment_keys"}}`) becomes torch Adam's per-parameter
    `step`, `exp_avg` and `exp_avg_sq`: optax's count is the step t of the
    bias corrections in both, and its mu and nu are the two moments. It
    raises ValueError where the moments cannot be held equal: a parameter
    this optimizer trains that has no moments in the file (the JAX mask froze
    it), or one that it does not train with moments that are not zero."""
    if "optax_adam" not in optim_state:
        optimizer.load_state_dict(optim_state)
        return
    jax_state = optim_state["optax_adam"]
    held = set(jax_state["moment_keys"])
    name_of = {id(p): name for name, p in policy.named_parameters()}
    step = torch.tensor(float(jax_state["step"]), dtype=torch.float32)
    state, trained, index = {}, set(), 0
    for group in optimizer.param_groups:
        for p in group["params"]:
            name = name_of[id(p)]
            if name not in held:
                raise ValueError(
                    f"load_optim_state: the JAX checkpoint holds no Adam moments for {name}, which this optimizer "
                    f"trains (the JAX mask froze it), so Adam cannot resume equal to the JAX run"
                )
            state[index] = {
                "step": step.clone(),
                "exp_avg": jax_state["exp_avg"][name].reshape(p.shape).clone(),
                "exp_avg_sq": jax_state["exp_avg_sq"][name].reshape(p.shape).clone(),
            }
            trained.add(name)
            index += 1
    for name in sorted(held & set(name_of.values()) - trained):
        if bool(jax_state["exp_avg"][name].any()) or bool(jax_state["exp_avg_sq"][name].any()):
            raise ValueError(
                f"load_optim_state: the JAX checkpoint holds nonzero Adam moments for {name}, which this "
                f"optimizer keeps frozen, so Adam cannot resume equal to the JAX run"
            )
    current = optimizer.state_dict()
    optimizer.load_state_dict({"state": state, "param_groups": current["param_groups"]})
