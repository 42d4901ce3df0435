#!/usr/bin/env python3
"""Card check of the PyTorch port: builds its CUDA kernels, holds each against
its plain PyTorch version, and drives the RxR CMA act step, eval and inference
at full width.

    python3 chip_smoke.py

Needs one CUDA card (it exits non-zero without one) and nvcc. Phases:

1. device: the card's name, and its power limit from nvidia-smi;
2. build: every kernel of vlnce_torch/csrc, one nvcc process each, at once;
3. B1 gru_sequence and B2 fused_resize_normalize: kernel against plain
   version at the act shapes and at edge shapes (strided h0, ragged batches,
   every type pair, rows that are no multiple of 16 bytes), then times at
   the act shapes: the device time of the kernel, the plain version and a
   one-call PyTorch yardstick, each as a CUDA graph of repeated calls
   replayed between two events (`graph_ms`), beside the bound and the eager
   Python-loop time of the wrapper (`cuda_ms`); for B1 also two empty
   launches (the floor) and the sequence shape T=16, B=4;
4. main path: the RxR CMA config (rxr_cma_en.yaml) at full width,
   CMAPolicy.from_config on the card with seeded weights, then
   make_fused_act_step for 8 act steps at B=32 in bf16 on seeded
   observations in the env's format; the kernels' launch counters must rise
   by 2 + 2 per step; then the same 8 steps in f32 with the kernels and with
   the plain versions swapped in must agree;
5. serving: a checkpoint of the seeded full-width policy, then
   `vlnce_torch.run.run_exp(..., "eval", ...)` over 8 forked simulator
   workers (synthetic scenes, 480x640 frames, 16 episodes of at most 40
   steps, bf16, sampled actions as the config says) and `run_exp(...,
   "inference", ...)` over 8 episodes in the rxr format; the stats file must
   hold finite values of the seven RxR measures, the episode ids must be
   distinct, the weights must be the checkpoint's and on the card, and each
   kernel's launch counter must have risen by exactly 2 per act step of each
   loop; then where an env step's time goes (render, pipe, upload, act,
   download), each measured apart;
6. a {"kernels": [...]} line, then the {"ok": true, ...} line last.

Any failed check raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import math
import os
import pickle
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
B = 32  # the act batch (bench.py)
STEPS = 8
N_ENVS = 8  # simulator workers of the serving phase


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Eager time of fn() in ms: CUDA events around a Python loop of `iters`
    calls. Where fn's kernels are shorter than the host's work to launch
    them, this reads the host's launch rate, not the device."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, reps: int = 20, replays: int = 10) -> float:
    """Device time of fn() in ms: `reps` calls of fn captured in one CUDA
    graph, the graph replayed `replays` times between two CUDA events. The
    host launches only the replays, so its launch rate cannot enter. fn must
    be capturable: launches on the current stream, allocates with torch
    only, copies nothing from the host and never synchronises."""
    fn()  # first call outside the capture: builds, uploads and caches
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def bound_ms(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)
    return name


PTXAS = {  # what `nvcc -Xptxas -v` reports per kernel
    "registers": r"Used (\d+) registers", "bytes of stack": r"(\d+) bytes stack frame",
    "bytes of spill stores": r"(\d+) bytes spill stores", "bytes of spill loads": r"(\d+) bytes spill loads",
}


def phase_build():
    from vlnce_torch.ops import _build

    t0 = time.perf_counter()
    seconds = _build.build(_build.KERNELS)
    print(f"build: {time.perf_counter() - t0:.1f} s wall, per kernel {json.dumps({k: round(v, 1) for k, v in seconds.items()})}")
    for name in _build.KERNELS:
        log = _build.build_log(name)
        worst = {what: max((int(n) for n in re.findall(pattern, log)), default=0) for what, pattern in PTXAS.items()}
        print(f"  ptxas {name}: {log.count('Used ')} kernels, at most " + ", ".join(f"{n} {what}" for what, n in worst.items()))


# ---------------------------------------------------------------------------
# B1: masked GRU sequence
# ---------------------------------------------------------------------------


def phase_gru(dev):
    from vlnce_torch.ops import _build
    from vlnce_torch.ops.rnn import gru_sequence, gru_sequence_plain

    g = torch.Generator(device="cpu").manual_seed(1)

    def inputs(T, Bn, H, D, reset_at=None):
        xi = torch.randn(T, Bn, 3 * H, generator=g)
        masks = torch.ones(T, Bn, 1)
        if reset_at is not None:
            masks[reset_at, ::2] = 0.0
        h0 = torch.randn(Bn, H, generator=g)
        w_hh = torch.randn(3 * H, H, generator=g) * H**-0.5
        b_hh = torch.randn(3 * H, generator=g) * 0.1
        w_ih = torch.randn(3 * H, D, generator=g) * D**-0.5
        b_ih = torch.randn(3 * H, generator=g) * 0.1
        x = torch.randn(Bn, D, generator=g)
        return [t.to(dev) for t in (xi, masks, h0, w_hh, b_hh, w_ih, b_ih, x)]

    def strided(h0):
        """h0 as `states[:, 0]` of a [B, 2, H] recurrent state: rows 2H apart."""
        states = torch.stack([h0, torch.full_like(h0, float("nan"))], dim=1)
        return states[:, 0]

    # (T, B, H, step with resets, strided h0, atol): the act shape, the eval
    # loop's shape, the IL sequence shape, then edges (one row, batches that are no multiple of the
    # kernel's 4-row tasks, narrow H where most lanes have no part of a row)
    cases = [(1, B, 512, 0, True, 1e-5), (1, N_ENVS, 512, 0, True, 1e-5), (16, 4, 512, 7, True, 1e-4), (2, 1, 64, 1, False, 1e-4),
             (16, 3, 128, 8, True, 1e-4), (2, 40, 512, 1, True, 1e-4), (1, 40, 64, None, True, 1e-5)]
    errs = []
    for T, Bn, H, reset, is_strided, atol in cases:
        xi, masks, h0, w_hh, b_hh, *_ = inputs(T, Bn, H, 416, reset)
        h0 = strided(h0) if is_strided else h0
        out = gru_sequence(xi, masks, h0, w_hh, b_hh)
        ref = gru_sequence_plain(xi, masks, h0, w_hh, b_hh)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        print(f"B1 T={T} B={Bn} H={H} reset at {reset}, h0 {'strided' if is_strided else 'contiguous'}: "
              f"max_abs_err {err:.3e} (atol {atol:g})")
        assert err <= atol, f"B1 kernel disagrees with its plain version at T={T} B={Bn} H={H}: {err}"
        errs.append(err)

    # the act step: two launches (state_encoder over D=416, second over D=512)
    layers = [inputs(1, B, 512, D, 0) for D in (416, 512)]
    for layer in layers:
        layer[2] = strided(layer[2])

    def kernel():
        for xi, masks, h0, w_hh, b_hh, *_ in layers:
            gru_sequence(xi, masks, h0, w_hh, b_hh)

    def plain():
        for xi, masks, h0, w_hh, b_hh, *_ in layers:
            gru_sequence_plain(xi, masks, h0, w_hh, b_hh)

    def projection_and_kernel():
        for _, masks, h0, w_hh, b_hh, w_ih, b_ih, x in layers:
            gru_sequence(torch.nn.functional.linear(x, w_ih, b_ih)[None], masks, h0, w_hh, b_hh)

    def library():  # yardstick only: the port never calls torch.gru_cell
        for _, masks, h0, w_hh, b_hh, w_ih, b_ih, x in layers:
            torch.gru_cell(x, h0 * masks[0], w_ih, w_hh, b_ih, b_hh)

    ms, plain_ms, proj_ms, lib_ms = (graph_ms(f, reps=50) for f in (kernel, plain, projection_and_kernel, library))
    eager_ms = cuda_ms(kernel, iters=200)
    moved = sum(nbytes(xi, masks, h0, w_hh, b_hh) + nbytes(h0) for xi, masks, h0, w_hh, b_hh, *_ in layers)
    flops = sum(2 * 3 * 512 * 512 * B + 12 * 512 * B for _ in layers)
    b_ms, b_by = bound_ms(moved, flops)
    print(f"B1 act step (2 launches, L2-warm), device time by graph replay: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"projection+kernel {proj_ms:.4f} ms, torch.gru_cell {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
          f"eager loop of the wrapper {eager_ms:.4f} ms")

    # the floor of any launch, and the sequence shape of an IL train step
    empty = _build.load("gru_sequence").empty_launch
    empty.argtypes, empty.restype = [ctypes.c_void_p], ctypes.c_int

    def two_empty_launches():
        for _ in layers:
            _build.check("empty_launch", empty(torch.cuda.current_stream().cuda_stream))

    floor_ms = graph_ms(two_empty_launches, reps=50)
    seq = inputs(16, 4, 512, 416, 7)[:5]
    seq[2] = strided(seq[2])
    seq_ms = graph_ms(lambda: gru_sequence(*seq), reps=10)
    seq_plain_ms = graph_ms(lambda: gru_sequence_plain(*seq), reps=10)
    print(f"B1 floor: two empty launches {floor_ms:.4f} ms by the same replay; "
          f"T=16 B=4 H=512, one launch: kernel {seq_ms:.4f} ms, plain {seq_plain_ms:.4f} ms")
    return {
        "name": "gru_sequence", "route": "cuda", "source": "vlnce_torch/csrc/gru_sequence.cu",
        "replaces": "vlnce_tpu/ops/pallas_rnn.py:55", "max_abs_err": errs[0],
        "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        "eager_ms": eager_ms, "empty_launch_ms": floor_ms, "seq_T16_B4_ms": seq_ms,
    }


# ---------------------------------------------------------------------------
# B2: fused bilinear resize + normalize
# ---------------------------------------------------------------------------


def _resize_err(out, ref, out_dtype, scale_values):
    """Max |kernel - plain| after checking the stated tolerance: u8 within 1
    on at most 0.01% of values (summation order can flip a .5 tie), bf16
    within one bf16 ulp, f32 1e-5 on [0, 1]-scaled values and 1e-3 on raw
    [0, 255] values."""
    diff = (out.float() - ref.float()).abs()
    if out_dtype == torch.uint8:
        assert float(diff.max()) <= 1 and float((diff > 0).float().mean()) <= 1e-4, "u8 resize mismatch"
    elif out_dtype == torch.bfloat16:
        assert bool((diff <= ref.float().abs() * 2.0**-7 + 1e-6).all()), "bf16 resize beyond one ulp"
    else:
        assert float(diff.max()) <= (1e-5 if scale_values else 1e-3), "f32 resize mismatch"
    return float(diff.max())


def phase_resize(dev):
    import torch.nn.functional as F

    from vlnce_torch.ops.preprocess import fused_resize_normalize, fused_resize_normalize_plain

    g = torch.Generator(device="cpu").manual_seed(2)
    rgb = torch.randint(0, 256, (B, 480, 640, 3), generator=g, dtype=torch.uint8).to(dev)
    depth = torch.rand(B, 480, 640, 1, generator=g).to(dev)
    act_calls = [  # what ResizeShortestEdge(256) runs on an RxR act step
        (rgb, dict(normalize=False, out_dtype=torch.uint8, scale_values=False)),
        (depth, dict(normalize=False, out_dtype=torch.float32, scale_values=False)),
    ]
    small = torch.randint(0, 256, (3, 37, 53, 4), generator=g, dtype=torch.uint8).to(dev)
    ragged = torch.randint(0, 256, (4, 250, 333, 3), generator=g, dtype=torch.uint8).to(dev)  # rows of 999 bytes
    odd = torch.rand(1, 45, 61, 3, generator=g).to(dev)  # rows of 732 bytes: not a multiple of 16
    f32, bf16, u8 = torch.float32, torch.bfloat16, torch.uint8
    modes = {  # label: (images, out_hw, arguments); every allowed type pair, C in {1, 3, 4}
        "act rgb u8 480x640->256x341": (rgb, (256, 341), act_calls[0][1]),
        "act depth f32 480x640->256x341": (depth, (256, 341), act_calls[1][1]),
        f"act rgb u8, eval batch N={N_ENVS}": (rgb[:N_ENVS], (256, 341), act_calls[0][1]),
        f"act depth f32, eval batch N={N_ENVS}": (depth[:N_ENVS], (256, 341), act_calls[1][1]),
        "identity u8->f32 224x224": (rgb[:, :224, :224].contiguous(), (224, 224), dict(normalize=False, out_dtype=f32)),
        "normalize u8->bf16": (rgb, (256, 341), dict(normalize=True, out_dtype=bf16)),
        "depth f32->bf16": (depth, (256, 341), dict(normalize=False, out_dtype=bf16)),
        "u8->u8 C=3 250x333->133x177, element loads": (ragged, (133, 177), dict(out_dtype=u8, scale_values=False)),
        "upscale u8->bf16 C=4 37x53->64x75, element loads": (small, (64, 75), dict(out_dtype=bf16)),
        "downscale u8->f32 C=4 37x53->9x11": (small, (9, 11), dict(out_dtype=f32)),
        "B=1 f32->f32 C=3 45x61->32x42, element loads": (odd, (32, 42), dict(out_dtype=f32, scale_values=False)),
        "B=1 f32->bf16 C=3 45x61->45x80": (odd, (45, 80), dict(out_dtype=bf16)),
        "unaligned base f32 C=1": (depth.flatten()[1:1 + 2 * 480 * 640].reshape(2, 480, 640, 1), (256, 341),
                                   dict(out_dtype=f32, scale_values=False)),
    }
    act_err = 0.0
    for label, (x, hw, kw) in modes.items():
        out = fused_resize_normalize(x, hw, **kw)
        ref = fused_resize_normalize_plain(x, hw, **kw)
        torch.cuda.synchronize()
        err = _resize_err(out, ref, kw["out_dtype"], kw.get("scale_values", True))
        print(f"B2 {label}: max_abs_err {err:.3e}")
        if label.startswith("act"):
            act_err = max(act_err, err)

    floats = [x.permute(0, 3, 1, 2).float() for x, _ in act_calls]  # yardstick input, prepared untimed

    def kernel():
        for x, kw in act_calls:
            fused_resize_normalize(x, (256, 341), **kw)

    def plain():
        for x, kw in act_calls:
            fused_resize_normalize_plain(x, (256, 341), **kw)

    def library():  # yardstick only: the port never calls F.interpolate
        for xf in floats:
            F.interpolate(xf, size=(256, 341), mode="bilinear", align_corners=False, antialias=False)

    ms, lib_ms = graph_ms(kernel), graph_ms(library)
    plain_ms = graph_ms(plain, reps=3, replays=3)
    eager_ms = cuda_ms(kernel)
    moved = sum(nbytes(x) + x.shape[0] * 256 * 341 * x.shape[3] * kw["out_dtype"].itemsize for x, kw in act_calls)
    flops = sum(11 * x.shape[0] * 256 * 341 * x.shape[3] for x, _ in act_calls)
    b_ms, b_by = bound_ms(moved, flops)
    print(f"B2 act step (rgb + depth), device time by graph replay: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"F.interpolate on f32 {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, {moved / 1e6:.1f} MB); "
          f"eager loop of the wrapper {eager_ms:.4f} ms")
    return {
        "name": "fused_resize_normalize", "route": "cuda", "source": "vlnce_torch/csrc/resize_normalize.cu",
        "replaces": "vlnce_tpu/ops/pallas_preprocess.py:66", "max_abs_err": act_err,
        "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        "eager_ms": eager_ms,
    }


# ---------------------------------------------------------------------------
# main path: the RxR CMA act step
# ---------------------------------------------------------------------------


EXP = "vlnce_torch/config/experiments/rxr_baselines/rxr_cma_en.yaml"


def build_act_step(dev, dtype: str):
    """The RxR CMA config at full width on `dev` in compute dtype `dtype`, its
    policy with seeded weights, and the fused act step."""
    from vlnce_torch.config import get_config
    from vlnce_torch.envs.spaces import action_space_from_config, observation_space_from_config
    from vlnce_torch.models.cma_policy import CMAPolicy
    from vlnce_torch.ops.obs_transforms import apply_obs_transforms_obs_space, get_active_obs_transforms
    from vlnce_torch.trainers.base_trainer import make_fused_act_step

    cfg = get_config(EXP, ["CUDA.DEVICE", str(dev), "CUDA.PRECISION.compute_dtype", dtype])
    transforms = get_active_obs_transforms(cfg)
    space = apply_obs_transforms_obs_space(observation_space_from_config(cfg.TASK_CONFIG), transforms)
    policy = CMAPolicy.from_config(cfg, space, action_space_from_config(cfg.TASK_CONFIG))
    return cfg, policy, make_fused_act_step(policy, transforms)


def episode_observations(task_config, seed, steps=STEPS):
    """`steps` lists of B per-env observation dicts in the env's format: u8
    rgb and f32 depth frames, BERT-feature instructions [512, 768] zero past
    a ragged length, constant over an episode."""
    rng = np.random.RandomState(seed)
    sim, rxr = task_config.SIMULATOR, task_config.TASK.RXR_INSTRUCTION_SENSOR
    instr = np.zeros((B, rxr.max_text_len, rxr.feature_dim), np.float32)
    for b in range(B):
        n = rng.randint(16, rxr.max_text_len + 1)
        instr[b, :n] = rng.randn(n, rxr.feature_dim)
    batches = []
    for _ in range(steps):
        rgb = rng.randint(0, 256, (B, sim.RGB_SENSOR.HEIGHT, sim.RGB_SENSOR.WIDTH, 3), dtype=np.uint8)
        depth = rng.rand(B, sim.DEPTH_SENSOR.HEIGHT, sim.DEPTH_SENSOR.WIDTH, 1).astype(np.float32)
        batches.append([{"rgb": rgb[b], "depth": depth[b], "rxr_instruction": instr[b]} for b in range(B)])
    return batches


def _masks(step, dev):
    m = torch.ones(B, 1, device=dev)
    if step == 0:
        m[:] = 0.0
    if step == 4:
        m[: B // 2] = 0.0
    return m


def _run(act_step, policy, batches, dev, deterministic, generator=None):
    rnn = policy.initial_rnn_states(B)
    prev = torch.zeros(B, 1, dtype=torch.long, device=dev)
    logits, states, actions = [], [], []
    for step, obs in enumerate(batches):
        action, rnn, lg = act_step(obs, rnn, prev, _masks(step, dev), deterministic, generator)
        prev = action
        logits.append(lg)
        states.append(rnn)
        actions.append(action)
    torch.cuda.synchronize()
    return torch.stack(logits), torch.stack(states), torch.stack(actions)


@contextlib.contextmanager
def plain_versions():
    """Swap the plain PyTorch versions in where the act step calls the
    kernels' wrappers, for the whole-path reference run."""
    import vlnce_torch.models.rnn_state_encoder as rse
    import vlnce_torch.ops.obs_transforms as ot
    from vlnce_torch.ops.preprocess import fused_resize_normalize_plain
    from vlnce_torch.ops.rnn import gru_sequence_plain

    saved = rse.gru_sequence, ot.fused_resize_normalize
    rse.gru_sequence, ot.fused_resize_normalize = gru_sequence_plain, fused_resize_normalize_plain
    try:
        yield
    finally:
        rse.gru_sequence, ot.fused_resize_normalize = saved


def _reset_launches():
    from vlnce_torch.ops.preprocess import fused_resize_normalize
    from vlnce_torch.ops.rnn import gru_sequence

    gru_sequence.launches = 0
    fused_resize_normalize.launches = 0


def _read_launches():
    from vlnce_torch.ops.preprocess import fused_resize_normalize
    from vlnce_torch.ops.rnn import gru_sequence

    return {"gru_sequence": gru_sequence.launches, "fused_resize_normalize": fused_resize_normalize.launches}


def phase_main_path(dev):
    from vlnce_torch.envs.batch import batch_obs

    t0 = time.perf_counter()
    cfg, policy, act_step = build_act_step(dev, "bfloat16")
    print(f"main path: RxR CMA ({cfg.MODEL.RGB_ENCODER.cnn_type} rgb, GN-{cfg.MODEL.DEPTH_ENCODER.backbone} depth, "
          f"H={cfg.MODEL.STATE_ENCODER.hidden_size}, {policy.num_params() / 1e6:.1f}M weights), "
          f"built in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    batches = [batch_obs(obs, dev) for obs in episode_observations(cfg.TASK_CONFIG, seed=3)]
    torch.cuda.synchronize()
    print(f"observations: {STEPS} steps x B={B} of rgb {tuple(batches[0]['rgb'].shape)} u8, depth "
          f"{tuple(batches[0]['depth'].shape)} f32, rxr_instruction {tuple(batches[0]['rxr_instruction'].shape)} "
          f"batched to the card in {time.perf_counter() - t0:.1f} s")

    sampler = torch.Generator(device=dev).manual_seed(int(cfg.TASK_CONFIG.SEED))
    _reset_launches()
    logits, states, actions = _run(act_step, policy, batches, dev, not cfg.EVAL.SAMPLE, sampler)
    launches = _read_launches()
    print(f"main path launches over {STEPS} act steps: {json.dumps(launches)}")
    assert launches == {"gru_sequence": 2 * STEPS, "fused_resize_normalize": 2 * STEPS}, launches
    assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(states).all()), "non-finite act outputs"
    assert tuple(logits.shape) == (STEPS, B, 6) and tuple(states.shape) == (STEPS, B, 2, 512)
    assert int(actions.min()) >= 0 and int(actions.max()) < 6, "action out of range"
    print(f"bf16 act: {'sampled' if cfg.EVAL.SAMPLE else 'greedy'} actions in [0, 6), "
          f"|logits| max {float(logits.abs().max()):.4f}, action counts {torch.bincount(actions.flatten(), minlength=6).tolist()}")

    # act-step time in bf16, after the warm-up above
    peak0 = torch.cuda.max_memory_allocated()
    rnn, prev, masks = states[-1], actions[-1], torch.ones(B, 1, device=dev)
    step_ms = cuda_ms(lambda: act_step(batches[-1], rnn, prev, masks, True), iters=20, warmup=2)
    print(f"bf16 act step: {step_ms:.3f} ms/step, {B / step_ms * 1e3:.1f} env-steps/s (CUDA events, 20 steps at B={B}); "
          f"peak memory {max(peak0, torch.cuda.max_memory_allocated()) / 2**30:.2f} GiB")

    # f32 with the kernels against f32 with the plain versions, TF32 off
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _, policy32, act32 = build_act_step(dev, "float32")
    policy32.load_state_dict(policy.state_dict(), strict=True)
    k_logits, k_states, k_actions = _run(act32, policy32, batches, dev, True)
    with plain_versions():
        p_logits, p_states, p_actions = _run(act32, policy32, batches, dev, True)
    # the seeded head's logits are small (|logit| ~ 5e-3), so they are held
    # relative to their own scale; the RNN states are of order 1
    scale_l = float(p_logits.abs().max())
    err_l = float((k_logits - p_logits).abs().max())
    err_s = float((k_states - p_states).abs().max())
    same = bool(torch.equal(k_actions, p_actions))
    print(f"f32 act, kernels vs plain versions: greedy actions equal {same}, max |logits diff| {err_l:.3e} "
          f"(<= 1e-4 x max |logit| {scale_l:.3e}), max |state diff| {err_s:.3e} (atol 1e-3)")
    assert same and err_l <= 1e-4 * scale_l and err_s <= 1e-3, "f32 act step with kernels disagrees with the plain versions"
    f32_ms = cuda_ms(lambda: act32(batches[-1], rnn, prev, masks, True), iters=5, warmup=1)
    print(f"f32 act step (TF32 off): {f32_ms:.3f} ms/step")
    return launches, step_ms


# ---------------------------------------------------------------------------
# serving: eval and inference through the entry point, over forked simulators
# ---------------------------------------------------------------------------

RXR_MEASURES = ("steps_taken", "path_length", "distance_to_goal", "success", "oracle_success", "spl", "ndtw")


def _run_loop(run_type, opts):
    """One `run_exp` with the launch counters set to 0 just before and read
    just after; both must have risen by exactly 2 per act step of the loop."""
    from vlnce_torch.run import run_exp

    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    trainer = run_exp(EXP, run_type, opts)
    wall = time.perf_counter() - t0
    launches, timing = _read_launches(), trainer.last_loop_timing
    print(f"{run_type} launches over {timing['act_steps']} act steps: {json.dumps(launches)}")
    assert timing["act_steps"] > 0 and launches == {k: 2 * timing["act_steps"] for k in launches}, (launches, timing)
    assert {p.device.type for p in trainer.policy.parameters()} == {"cuda"}, "the policy is not on the card"
    return trainer, launches, wall


def phase_serving(dev):
    from vlnce_torch.utils.checkpoints import save_checkpoint

    with tempfile.TemporaryDirectory(prefix="vlnce_torch_smoke_") as tmp:
        # a checkpoint of the seeded full-width policy, its head's bias marked
        # so that loading it can be told from building the policy anew
        cfg, policy, _ = build_act_step(dev, "bfloat16")
        mark = torch.arange(6, dtype=torch.float32) * 0.01
        with torch.no_grad():
            policy.action_distribution.linear.bias.copy_(mark)
        ckpt = os.path.join(tmp, "ckpt.0.pth")
        save_checkpoint(ckpt, policy.state_dict(), config=cfg)
        del policy
        print(f"serving: checkpoint of {os.path.getsize(ckpt) / 1e6:.1f} MB written")

        common = [
            "TASK_CONFIG.DATASET.TYPE", "Synthetic-VLN-v0",
            "TASK_CONFIG.DATASET.NUM_SCENES", N_ENVS,  # one scene per worker
            "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", 40,
            "NUM_ENVIRONMENTS", N_ENVS,
            "TENSORBOARD_DIR", "", "VERBOSE", False, "LOG_FILE", os.path.join(tmp, "run.log"),
        ]
        trainer, eval_launches, wall = _run_loop("eval", common + [
            "TASK_CONFIG.DATASET.NUM_EPISODES", 32, "EVAL.EPISODE_COUNT", 16, "EVAL.USE_CKPT_CONFIG", False,
            "EVAL_CKPT_PATH_DIR", ckpt, "RESULTS_DIR", os.path.join(tmp, "evals"),
        ])
        assert torch.equal(trainer.policy.action_distribution.linear.bias.cpu(), mark), "the checkpoint's weights were not loaded"
        with open(os.path.join(tmp, "evals", f"stats_ckpt_0_{cfg.EVAL.SPLIT}.json")) as f:
            stats = json.load(f)
        assert sorted(stats) == sorted(RXR_MEASURES), stats
        assert all(math.isfinite(v) for v in stats.values()), stats
        episodes = trainer._last_eval_episode_stats
        assert 16 <= len(set(episodes)) == len(episodes) <= 16 + N_ENVS - 1, sorted(episodes)
        t = trainer.last_loop_timing
        print(f"eval: {len(episodes)} episodes, stats {json.dumps({k: round(v, 4) for k, v in stats.items()})}")
        print(f"eval wall time: {wall:.2f} s for run_exp (envs forked, policy built, checkpoint loaded), {t['total_time']:.2f} s in the loop")
        print(f"eval act steps: {t['act_steps']} at N={N_ENVS}, {t['env_steps']} env steps")
        print(f"eval env-steps/s of the whole loop: {t['env_steps'] / t['total_time']:.1f}")
        print(f"eval pth_time {t['pth_time']:.3f} s : env_time {t['env_time']:.3f} s "
              f"({1e3 * t['pth_time'] / t['act_steps']:.1f} ms and {1e3 * t['env_time'] / t['act_steps']:.1f} ms per act step; "
              f"act share {t['pth_time'] / t['total_time']:.1%} of the loop; the first act step took {t['first_act_time']:.3f} s)")
        print(f"eval time outside both clocks: {t['total_time'] - t['pth_time'] - t['env_time']:.3f} s "
              f"(resets of finished episodes, slot copies, current_episodes)")
        print(f"eval peak card memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

        predictions = os.path.join(tmp, "predictions.jsonl")
        inf_trainer, inf_launches, wall = _run_loop("inference", common + [
            "TASK_CONFIG.DATASET.NUM_EPISODES", N_ENVS, "INFERENCE.FORMAT", "rxr", "INFERENCE.USE_CKPT_CONFIG", False,
            "INFERENCE.CKPT_PATH", ckpt, "INFERENCE.PREDICTIONS_FILE", predictions,
        ])
        with open(predictions) as f:
            lines = [json.loads(line) for line in f]
        assert len(lines) == N_ENVS and len({str(e["instruction_id"]) for e in lines}) == N_ENVS, lines
        for entry in lines:
            path = entry["path"]
            assert len(path) >= 1 and all(len(p) == 3 and all(math.isfinite(x) for x in p) for p in path), entry
            assert all(a != b for a, b in zip(path[:-1], path[1:])), "consecutive duplicates in an rxr path"
        t = inf_trainer.last_loop_timing
        print(f"inference: {len(lines)} rxr entries, {t['act_steps']} act steps, {t['env_steps']} env steps in {t['total_time']:.2f} s "
              f"(run_exp {wall:.2f} s), pth_time {t['pth_time']:.3f} s : env_time {t['env_time']:.3f} s")

        phase_env_step_parts(trainer, dev)
    return eval_launches, inf_launches


def phase_env_step_parts(trainer, dev, steps: int = 6):
    """Where an env step of the eval loop goes, each part measured apart at
    N = N_ENVS with the eval's own policy: render (one in-process env step),
    pipe (pickling one observation there and back), the 8 workers' step as the
    loop sees it, one worker's reset to its next episode, upload, act and
    download."""
    from vlnce_torch.envs.batch import ObsSlots
    from vlnce_torch.envs.env_utils import construct_envs_auto_reset_false, get_env_class
    from vlnce_torch.trainers.base_trainer import make_fused_act_step

    config = trainer.config.clone().defrost()
    config.TASK_CONFIG.DATASET.TYPE = "Synthetic-VLN-v0"
    config.TASK_CONFIG.DATASET.NUM_SCENES = N_ENVS
    config.TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS = 500
    config.NUM_ENVIRONMENTS = N_ENVS
    config.freeze()

    env = get_env_class(config.ENV_NAME)(config)
    obs = env.reset()
    t0 = time.perf_counter()
    for i in range(steps):
        obs = env.step(1 + i % 3)[0]
    render_ms = 1e3 * (time.perf_counter() - t0) / steps
    env.close()
    t0 = time.perf_counter()
    for _ in range(steps):
        blob = pickle.dumps(obs, protocol=pickle.HIGHEST_PROTOCOL)
        pickle.loads(blob)
    pickle_ms = 1e3 * (time.perf_counter() - t0) / steps

    envs = construct_envs_auto_reset_false(config, get_env_class(config.ENV_NAME))
    observations = envs.reset()
    ids = list(range(N_ENVS))
    envs.step_at(ids, [1] * N_ENVS)
    t0 = time.perf_counter()
    for i in range(steps):
        stepped = envs.step_at(ids, [1 + i % 3] * N_ENVS)
    workers_ms = 1e3 * (time.perf_counter() - t0) / steps
    t0 = time.perf_counter()
    for i in range(steps):
        envs.reset_at(i % N_ENVS)
        envs.call_at(i % N_ENVS, "current_episode")
    reset_ms = 1e3 * (time.perf_counter() - t0) / steps
    envs.close()

    slots = ObsSlots(observations, dev)
    for i, (o, _, _, _) in enumerate(stepped):
        slots.update(i, o)
    upload_ms = cuda_ms(slots.to_device, iters=10)
    policy = trainer.policy
    act_step = make_fused_act_step(policy, trainer.obs_transforms)
    batch = slots.to_device()
    rnn, prev = policy.initial_rnn_states(N_ENVS), torch.zeros(N_ENVS, 1, dtype=torch.long, device=dev)
    masks = torch.ones(N_ENVS, 1, device=dev)
    act_ms = cuda_ms(lambda: act_step(batch, rnn, prev, masks, True), iters=10, warmup=2)
    actions = act_step(batch, rnn, prev, masks, True)[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        actions.reshape(-1).cpu().numpy()
    download_ms = 1e3 * (time.perf_counter() - t0) / steps
    print(f"env step parts at N={N_ENVS} (ms): render {render_ms:.1f} per env in-process, pickle round trip of one "
          f"{len(blob) / 1e6:.2f} MB observation {pickle_ms:.1f}, all {N_ENVS} forked workers' step as the loop sees it {workers_ms:.1f}, "
          f"one worker's reset to its next episode {reset_ms:.1f}, "
          f"upload of {slots.nbytes() / 1e6:.1f} MB from pinned memory {upload_ms:.2f} "
          f"({slots.nbytes() / upload_ms / 1e6:.1f} GB/s), act step {act_ms:.2f}, download of the actions {download_ms:.3f}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    import vlnce_torch  # noqa: F401  (fails where the repository is absent)

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    name = phase_device()
    phase_build()
    kernels = [phase_gru(dev), phase_resize(dev)]
    launches, _ = phase_main_path(dev)
    eval_launches, inference_launches = phase_serving(dev)
    for k in kernels:
        k["launches_act_phase"] = launches[k["name"]]
        k["launches_eval"] = eval_launches[k["name"]]
        k["launches_inference"] = inference_launches[k["name"]]
        k["launches"] = k["launches_act_phase"] + k["launches_eval"] + k["launches_inference"]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
