#!/usr/bin/env python3
"""Where the time of the port's RxR CMA act step, of its R2R CMA train step,
or of its RxR CMA recollect train step goes on one CUDA card.

    python3 scripts/profile_torch_act.py              # the act step
    python3 scripts/profile_torch_act.py --train      # the IL train step
    python3 scripts/profile_torch_act.py --recollect  # the recollect train step
    python3 scripts/profile_torch_act.py --waypoint   # the PPO minibatch step and act step of 1-wpn-cc

Act mode builds the act step that chip_smoke.py drives (the RxR CMA policy of
rxr_cma_en.yaml at full width in bf16, seeded weights, B=32, the same seeded
observations), then reports:

- the whole step's time with CUDA events, and its device busy time from
  torch.profiler (the sum of its kernels' times); their difference is time the
  device waits for the host to launch work (the idle share);
- per layer, its device busy time: the obs transforms (resize kernel +
  crops), the instruction biLSTM, the depth and RGB encoders, and the rest
  (GRUs, attention, heads, the action draw) as the step minus those;
- device time by kernel family and by kernel name over PROFILED_STEPS steps.

Train mode builds the train step that chip_smoke.py times
(cma_pm_da_aug_tune.yaml at full width, one seeded batch of cached features
at T=32, N=5 on the card) and reports the step's time, its device busy time
and idle share, the busy time of the forward alone (the rest is backward and
optimizer), and device time by kernel family and name.

Recollect mode builds the recollect train step that chip_smoke.py holds
against the plain versions (rxr_cma_en.yaml at full width in bf16, one seeded
batch of raw 480x640 frames at T=48, N=3 already on the card: the obs
transforms, then the accumulation step, Adam applied) and reports the same,
with the busy time of the obs transforms and of the frozen encoders apart,
and the upload of that batch from pinned host memory.

Waypoint mode builds the PPO minibatch step that chip_smoke.py holds against
the plain loop (1-wpn-cc.yaml at full width in bf16, one seeded minibatch at
T=16, n=1 on the host, uploaded by the step as the trainer does) and reports
the step's time, busy time, idle share, the busy time of the upload and the
frozen encoders apart, then the act step at B=4 with its own breakdown.
"""

from __future__ import annotations

import collections
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (B, RECOLLECT_N, RECOLLECT_T, TRAIN_B, TRAIN_T, build_act_step, build_recollect_step,  # noqa: E402
                        WP_N, WP_T, build_train_step, build_waypoint_ppo_step, cuda_ms, device_ms,
                        episode_observations)

PROFILED_STEPS = 10
FAMILIES = (  # first match wins
    ("gru_sequence backward (B1)", ("gru_sequence_backward",)),
    ("gru weight gradient (B1 backward)", ("gru_weight_gradient",)),
    ("gru_sequence (B1)", ("gru_sequence",)),
    ("resize_normalize (B2)", ("resize_normalize",)),
    ("cuDNN LSTM", ("RNN", "LSTM", "lstm", "rnn")),
    ("group_norm", ("group_norm", "GroupNorm", "RowwiseMoments", "ComputeFused", "Moments")),
    ("convolution", ("conv", "Conv", "xmma", "implicit", "sm90_", "cutlass", "cudnn", "nchw", "nhwc")),
    ("gemm", ("gemm", "Gemm", "gemv", "cublas")),
    ("pooling", ("pool",)),
    ("elementwise/other", ("",)),
)


def _print_kernels(kernels, busy):
    """Device time by kernel family and of the top kernels; returns the families."""
    families = collections.Counter()
    for k, v in kernels.items():
        fam = next(f for f, keys in FAMILIES if any(s in k for s in keys))
        families[fam] += v
    print("device busy by kernel family:")
    for fam, v in families.most_common():
        print(f"  {fam:38s} {v:8.3f} ms  {v / busy:6.1%}")
    print("top kernels (ms/step):")
    for k, v in kernels.most_common(12):
        print(f"  {v:8.3f}  {k[:110]}")
    return families


def profile_train_step(dev) -> int:
    from vlnce_torch.parallel.il_step import il_losses

    _, policy, _, train_step, batch = build_train_step(dev, "bfloat16")
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}; train step at T={TRAIN_T}, N={TRAIN_B}, bf16 encoders (bypassed: cached features), "
          f"{policy.num_params() / 1e6:.1f}M weights")
    step = lambda: train_step(*batch)  # noqa: E731
    total = cuda_ms(step, iters=10, warmup=3)
    busy, kernels = device_ms(step, PROFILED_STEPS)
    forward, _ = device_ms(lambda: il_losses(policy, *batch), PROFILED_STEPS)
    print(f"train step: {total:.3f} ms/step (CUDA events); device busy {busy:.3f} ms/step (profiler), idle share "
          f"{max(0.0, 1 - busy / total):.1%}; forward alone {forward:.3f} ms busy, backward + optimizer {busy - forward:.3f}")
    families = _print_kernels(kernels, busy)
    print(json.dumps({"device": name, "T": TRAIN_T, "N": TRAIN_B, "train_step_ms": total, "device_busy_ms": busy,
                      "forward_busy_ms": forward, "families_ms": dict(families)}))
    return 0


def profile_recollect_step(dev) -> int:
    from vlnce_torch.ops.obs_transforms import apply_obs_transforms_batch, get_active_obs_transforms

    cfg, policy, _, step, (frames, *_) = build_recollect_step(dev, "bfloat16", RECOLLECT_T, RECOLLECT_N)
    name = torch.cuda.get_device_name(0)
    T, N = RECOLLECT_T, RECOLLECT_N
    print(f"device: {name}; recollect train step at T={T}, N={N} ({T * N} raw 480x640 frames on the card), bf16 "
          f"encoders, {policy.num_params() / 1e6:.1f}M weights")
    total = cuda_ms(step, iters=10, warmup=3)
    busy, kernels = device_ms(step, PROFILED_STEPS)
    transforms = get_active_obs_transforms(cfg)
    net = policy.net
    with torch.no_grad():
        obs = apply_obs_transforms_batch(frames, transforms)
        parts = {
            "obs transforms (B2 x2, crops)": device_ms(lambda: apply_obs_transforms_batch(frames, transforms), PROFILED_STEPS)[0],
            "depth encoder (frozen GN-ResNet50)": device_ms(lambda: net.depth_encoder.visual_encoder(
                obs["depth"].to(torch.bfloat16).permute(0, 3, 1, 2)), PROFILED_STEPS)[0],
            "rgb encoder (frozen ResNet50)": device_ms(lambda: net.rgb_encoder(obs), PROFILED_STEPS)[0],
        }
    host = {k: v.cpu().numpy() for k, v in frames.items()}
    from vlnce_torch.envs.batch import to_device

    upload = cuda_ms(lambda: to_device(host, dev), iters=5, warmup=1)
    nbytes = sum(v.nbytes for v in host.values())
    print(f"recollect train step: {total:.3f} ms/step (CUDA events, batch on the card); device busy {busy:.3f} ms/step "
          f"(profiler), idle share {max(0.0, 1 - busy / total):.1%}; upload of the batch's {nbytes / 1e6:.0f} MB of "
          f"observations from host memory through pinned copies {upload:.3f} ms ({nbytes / upload / 1e6:.1f} GB/s)")
    print("device busy of parts run alone:")
    for k, v in parts.items():
        print(f"  {k:38s} {v:8.3f} ms  {v / busy:6.1%}")
    families = _print_kernels(kernels, busy)
    print(json.dumps({"device": name, "T": T, "N": N, "recollect_step_ms": total, "device_busy_ms": busy,
                      "parts_busy_ms": parts, "upload_ms": upload, "upload_bytes": nbytes,
                      "families_ms": dict(families)}))
    return 0


def profile_waypoint(dev) -> int:
    """The PPO minibatch step of 1-wpn-cc (T=16, n=1, its minibatch uploaded
    from the host, as the trainer runs it) and the act step at B=4 on one
    batch already on the card."""
    cfg, policy, agent, sample = build_waypoint_ppo_step(dev, "bfloat16")
    name = torch.cuda.get_device_name(0)
    T = WP_T

    def minibatch_step():
        agent.optimizer.zero_grad(set_to_none=True)
        total, _ = agent.loss(agent.upload(sample), agent.clip_param(0), T)
        total.backward()
        agent.optimizer.step()

    dev_sample = agent.upload(sample)
    flat = lambda v: v.reshape((T,) + tuple(v.shape[2:]))  # noqa: E731
    obs, hidden0, actions, prev, _, _, masks, _, _ = dev_sample
    obs, prev, actions = ({k: flat(v) for k, v in d.items()} for d in (obs, prev, actions))
    masks = flat(masks)
    total = cuda_ms(minibatch_step, iters=5, warmup=2)
    busy, kernels = device_ms(minibatch_step, PROFILED_STEPS)
    upload = cuda_ms(lambda: agent.upload(sample), iters=5, warmup=1)
    nbytes = sum(v.nbytes for v in sample[0].values())
    net = policy.net
    with torch.no_grad():
        parts = {
            "upload (pinned copies)": device_ms(lambda: agent.upload(sample), PROFILED_STEPS)[0],
            f"depth encoder (frozen GN-ResNet50, {13 * T} frames)": device_ms(lambda: net.depth_encoder(
                {"depth": torch.cat([obs["depth"].flatten(0, 1), obs["depth_history"]])}), PROFILED_STEPS)[0],
            f"rgb encoder (frozen ResNet18, {13 * T} frames)": device_ms(lambda: net.rgb_encoder(
                {"rgb": torch.cat([obs["rgb"].flatten(0, 1), obs["rgb_history"]])}), PROFILED_STEPS)[0],
            f"instruction biLSTM ({T} rows)": device_ms(lambda: net.instruction_encoder(obs), PROFILED_STEPS)[0],
        }
    print(f"device: {name}; PPO minibatch step of 1-wpn-cc at T={T}, n=1, bf16 encoders, {policy.num_params() / 1e6:.1f}M "
          f"weights: {total:.3f} ms/step (CUDA events, upload of {nbytes / 1e6:.1f} MB included: {upload:.3f} ms, "
          f"{nbytes / upload / 1e6:.1f} GB/s); device busy {busy:.3f} ms/step (profiler), idle share "
          f"{max(0.0, 1 - busy / total):.1%}")
    print("device busy of parts run alone:")
    for k, v in parts.items():
        print(f"  {k:46s} {v:8.3f} ms  {v / busy:6.1%}")
    families = _print_kernels(kernels, busy)

    B = WP_N
    act_obs = {k: v[:B] for k, v in obs.items()}
    rnn, act_prev, act_masks = hidden0.expand(B, -1, -1).contiguous(), {k: v[:B] for k, v in prev.items()}, masks[:B]
    step = lambda: policy.act(act_obs, rnn, act_prev, act_masks, deterministic=True)  # noqa: E731
    act_total = cuda_ms(step, iters=10, warmup=2)
    act_busy, act_kernels = device_ms(step, PROFILED_STEPS)
    print(f"act step at B={B} (batch on the card): {act_total:.3f} ms/step (CUDA events); device busy {act_busy:.3f} "
          f"ms/step, idle share {max(0.0, 1 - act_busy / act_total):.1%}")
    act_families = _print_kernels(act_kernels, act_busy)
    print(json.dumps({"device": name, "T": T, "minibatch_ms": total, "device_busy_ms": busy, "upload_ms": upload,
                      "upload_bytes": nbytes, "parts_busy_ms": parts, "families_ms": dict(families), "act_B": B,
                      "act_ms": act_total, "act_busy_ms": act_busy, "act_families_ms": dict(act_families)}))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_act: no CUDA card visible", file=sys.stderr)
        return 1
    if "--train" in sys.argv[1:]:
        return profile_train_step(torch.device("cuda", 0))
    if "--recollect" in sys.argv[1:]:
        return profile_recollect_step(torch.device("cuda", 0))
    if "--waypoint" in sys.argv[1:]:
        return profile_waypoint(torch.device("cuda", 0))

    from vlnce_torch.envs.batch import batch_obs
    from vlnce_torch.ops.obs_transforms import apply_obs_transforms_batch, get_active_obs_transforms

    dev = torch.device("cuda", 0)
    cfg, policy, act_step = build_act_step(dev, "bfloat16")
    transforms = get_active_obs_transforms(cfg)
    obs = batch_obs(episode_observations(cfg.TASK_CONFIG, seed=3, steps=1)[0], dev)
    rnn = policy.initial_rnn_states(B)
    prev = torch.zeros(B, 1, dtype=torch.long, device=dev)
    masks = torch.ones(B, 1, device=dev)

    name = torch.cuda.get_device_name(0)
    print(f"device: {name}; B={B}, bf16 encoders, {policy.num_params() / 1e6:.1f}M weights")
    net = policy.net
    with torch.no_grad():
        batch = apply_obs_transforms_batch(obs, transforms)
        step = lambda: act_step(obs, rnn, prev, masks, True)  # noqa: E731
        total = cuda_ms(step, iters=10, warmup=2)
        busy, kernels = device_ms(step, PROFILED_STEPS)
        layers = {
            "obs transforms": device_ms(lambda: apply_obs_transforms_batch(obs, transforms), PROFILED_STEPS)[0],
            "instruction biLSTM": device_ms(lambda: net.instruction_encoder(batch), PROFILED_STEPS)[0],
            "depth encoder (GN-ResNet50)": device_ms(lambda: net.depth_encoder(batch), PROFILED_STEPS)[0],
            "rgb encoder (ResNet50)": device_ms(lambda: net.rgb_encoder(batch), PROFILED_STEPS)[0],
        }
    layers["rest (GRUs, attention, heads, draw)"] = busy - sum(layers.values())
    print(f"act step: {total:.3f} ms/step, {B / total * 1e3:.1f} env-steps/s (CUDA events); device busy "
          f"{busy:.3f} ms/step (profiler), idle share {max(0.0, 1 - busy / total):.1%}")
    print("device busy by layer:")
    for k, v in layers.items():
        print(f"  {k:38s} {v:8.3f} ms  {v / busy:6.1%}")
    families = _print_kernels(kernels, busy)
    print(json.dumps({"device": name, "batch": B, "act_ms": total, "device_busy_ms": busy,
                      "layers_busy_ms": layers, "families_ms": dict(families)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
