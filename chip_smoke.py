#!/usr/bin/env python3
"""Card check of the PyTorch port: builds its CUDA kernels, holds each against
its plain PyTorch version, and drives the RxR CMA act step, eval and inference,
the R2R CMA DAgger training, the RxR CMA and Seq2Seq recollect training, and
the DD-PPO training of the waypoint policy at full width.

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
6. B1's backward (the gradient of gru_sequence) by both routes, the cluster
   route that reads the training forward's gates and the grid route that
   recomputes them, and its weight-gradient kernel, each against its plain
   version at the training shapes (T in {16, 32, 48}, B=5, H=512) and at
   T=1 (B=8 takes the grid route, B=5 the cluster route); the cluster size
   granted and the card's most active clusters; device times by graph replay
   of each route's recurrence alone, the weight gradient and the wrapper,
   beside the plain loop's, autograd through cuDNN's GRU, the torch ops the
   weight-gradient kernel replaced, and each launch's bound from the work it
   does (the recurrence: one product, given the gates);
7. training: `run_exp(cma_pm_da_aug_tune.yaml, "train")` at full width in
   bf16 over 8 forked workers (synthetic scenes, 224x224 / 256x256 frames):
   2 DAgger iterations (beta 1.0, then 0.5) of 16 episodes and 2 epochs at
   batch size 5, then `run_exp(..., "eval")` of the last checkpoint; B1 must
   be launched exactly twice forward per collection step and twice forward
   and twice backward (on the cluster route, each with one weight-gradient
   launch) per train step, B2 never; frozen weights must not
   move, the others must; the optimizer holds state for the trainable ones
   only; the action loss must fall; then the train step alone on a seeded
   batch at T=32, N=5 for its warm split (forward, backward, optimizer);
8. the recollect trainer's shapes (`phase_recollect_shapes`): the cluster
   granted at B in {1, 2, 3}; B1's forward storing the gates, its
   cluster-route backward and weight gradient against their plain versions
   at B in {1, 2, 3}, T in {1, 57, 250}; their device times at T=32, B=5
   and T in {48, 256}, B=3 beside bound, plain loop and cuDNN's GRU; B2 over
   one batch of 144 collated frames beside bound and F.interpolate;
9. recollect training (`phase_recollect`): `run_exp(rxr_cma_en.yaml,
   "train")` at full width over 3 forked workers (synthetic scenes, 480x640
   frames, GT actions from the shortest-path oracle), IL.batch_size 3,
   preload_size 3, 6 episodes of at most 40 steps, 2 epochs,
   effective_batch_size 6 (two batches per Adam step); per train step B2
   twice, B1 twice forward, twice backward on the cluster route and twice
   the weight gradient; frozen weights bit-equal, losses finite, ckpt.1.ckpt
   with its epoch and step, then eval of it over the forked pool; the train
   step's split by CUDA events, the batches' T and the re-simulation's
   env-steps/s;
10. `phase_recollect_against_plain`: one seeded f32 accumulation step of RxR
   CMA at T=32, N=3 from raw frames (TF32 off), through the kernels (B2 and
   both B1 kernels), through the plain versions under autograd, and with B1
   plain and B2 the kernel: the losses must agree, B2 within its u8
   tolerance on those frames, and every gradient against the B1-plain run
   (the same frames) at the tolerance of step 7's f32 check;
11. `phase_seq2seq`: `run_exp(rxr_seq2seq.yaml, "train")` for one epoch
   (one B1 forward, backward and weight gradient and two B2 launches per
   train step), then eval of its checkpoint;
12. `phase_waypoint_shapes`: B1 at the waypoint configs' H=256: the cluster
   granted at B in {1, 2, 4} (4 blocks); the forward at T=1, B in {2, 4}
   with h0 either slice of a [B, 2, H] state; the forward storing the
   gates, the cluster-route backward and the weight gradient at T=16, B in
   {1, 2, 4}, each against its plain version; device times at the act
   step's launch (T=1, B=4) and a PPO minibatch's (T=16, B=1) beside the
   bound, the plain loop and cuDNN's GRU;
13. `phase_waypoint`: `run_exp(r2r_waypoint/1-wpn-cc.yaml, "train")` at full
   width in bf16 over 4 forked workers (12 pano RGB 224² and depth 256²
   frames a step, episodes of at most 40 waypoints): 2 updates of 16 steps,
   ppo_epoch 2, num_mini_batch 4; B1 exactly 2 forward launches per act step
   and per bootstrap value, and per PPO minibatch 2 forward, 2 backward on
   the cluster route and 2 weight gradients; B2 never; frozen weights
   bit-equal, the others moved; then `run_exp(..., "eval")` of the last
   checkpoint over 8 episodes with sampled actions (2 B1 launches per act
   step); the rollout's env-steps/s, the act step's ms, the PPO minibatch
   step's split by CUDA events, and one minibatch step alone with its
   device idle share;
14. `phase_waypoint_against_plain`: one seeded f32 PPO minibatch step at
   T=16, n=1 (TF32 off) through B1's kernels and through the plain loop
   under autograd: losses within 1e-5, gradients at step 7's tolerance;
15. a {"kernels": [...]} line, then the {"ok": true, ...} line last.

Any failed check raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
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
    # loop's shape, the shapes of the training path (a collection group of N_ENVS / 2 rows at T = 1;
    # IL.batch_size 5 rows, no multiple of the kernel's 4-row tasks, at every T a batch takes), then
    # edges (one row, other batches off the 4-row tasks, narrow H where most lanes have no part of a row)
    cases = [(1, B, 512, 0, True, 1e-5), (1, N_ENVS, 512, 0, True, 1e-5), (1, N_ENVS // 2, 512, 0, True, 1e-5),
             (16, TRAIN_B, 512, 7, True, 1e-4), (TRAIN_T, TRAIN_B, 512, 11, True, 1e-4), (48, TRAIN_B, 512, 20, True, 1e-4),
             (16, 4, 512, 7, True, 1e-4), (2, 1, 64, 1, False, 1e-4),
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
    # the training forward: one launch at the training shape, storing the gates for the backward or not
    from vlnce_torch.ops.rnn import _forward_launch

    train = inputs(TRAIN_T, TRAIN_B, 512, 416, 11)[:5]
    train[2] = strided(train[2])
    bare_ms = graph_ms(lambda: _forward_launch(*train), reps=10)
    reserve_ms = graph_ms(lambda: _forward_launch(*train, reserve=True), reps=10)
    reserve_bytes = TRAIN_T * TRAIN_B * 4 * 512 * 4
    print(f"B1 floor: two empty launches {floor_ms:.4f} ms by the same replay; "
          f"T=16 B=4 H=512, one launch: kernel {seq_ms:.4f} ms, plain {seq_plain_ms:.4f} ms; "
          f"T={TRAIN_T} B={TRAIN_B} H=512, one launch: {bare_ms:.4f} ms, storing the gates ({reserve_bytes / 1e6:.2f} MB) {reserve_ms:.4f} ms")
    return {
        "name": "gru_sequence", "route": "cuda", "source": "vlnce_torch/csrc/gru_sequence.cu",
        "replaces": "vlnce_tpu/ops/pallas_rnn.py:55", "max_abs_err": max(errs),  # over every shape above
        "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        "eager_ms": eager_ms, "empty_launch_ms": floor_ms, "seq_T16_B4_ms": seq_ms,
        "train_T32_B5_ms": bare_ms, "train_T32_B5_reserve_ms": reserve_ms, "reserve_bytes_T32_B5": reserve_bytes,
    }


# ---------------------------------------------------------------------------
# B1 backward: the gradient of the masked GRU sequence
# ---------------------------------------------------------------------------

TRAIN_T, TRAIN_B = 32, 5  # one R2R CMA DAgger batch: IL.batch_size 5, padded to a multiple of 16


def phase_gru_backward(dev):
    """B1's gradient: the recurrence by both routes (the cluster route, which
    reads the training forward's gates, and the grid route, which recomputes
    them) and the weight-gradient kernel, each against its plain version at
    the training shapes and at T=1, then device times by CUDA-graph replay.
    Returns the kernels-line entries of the backward and of the weight
    gradient."""
    from vlnce_torch.ops.rnn import (_backward_launch, _BLOCK_UNITS, _cluster_launch, _forward_launch,
                                     _weight_gradient_launch, backward_cluster_plan, gru_sequence_backward,
                                     gru_sequence_backward_plain, gru_sequence_plain, gru_weight_gradient,
                                     gru_weight_gradient_plain)

    g = torch.Generator(device="cpu").manual_seed(4)
    H = 512

    def inputs(T, Bn, reset_at):
        xi = torch.randn(T, Bn, 3 * H, generator=g)
        masks = torch.ones(T, Bn, 1)
        masks[reset_at, ::2] = 0.0
        states = torch.stack([torch.randn(Bn, H, generator=g), torch.full((Bn, H), float("nan"))], dim=1)
        w_hh = torch.randn(3 * H, H, generator=g) * H**-0.5
        b_hh = torch.randn(3 * H, generator=g) * 0.1
        # the policy hands d_out over as a view of a [T * B, H] gradient; a
        # transposed view here, so the wrapper's copy is exercised
        d_out = torch.randn(Bn, T, H, generator=g)
        xi, masks, states, w_hh, b_hh, d_out = (t.to(dev) for t in (xi, masks, states, w_hh, b_hh, d_out))
        h0 = states[:, 0]  # rows 2H apart
        out, gates = gru_sequence_plain(xi, masks, h0, w_hh, b_hh, return_gates=True)
        return d_out.transpose(0, 1), xi, masks, h0, w_hh, b_hh, out, gates

    cluster, active = backward_cluster_plan(dev.index, TRAIN_B, H)
    print(f"B1 backward cluster route at B={TRAIN_B} H={H}: cluster of {cluster} blocks granted, "
          f"cudaOccupancyMaxActiveClusters {active}")
    assert cluster > 0 and active >= 1, "the cluster route does not take the training shape"

    names = ("d_xi", "d_h0", "d_w_hh", "d_b_hh")
    shapes = {"train": inputs(TRAIN_T, TRAIN_B, 11), "T16": inputs(16, TRAIN_B, 7), "long": inputs(48, TRAIN_B, 20),
              "step": inputs(1, N_ENVS, 0), "step_B5": inputs(1, TRAIN_B, 0)}
    worst = {}
    for label, (*args, gates) in shapes.items():
        for route, given in (("cluster", gates), ("grid", None)):
            T, Bn = args[1].shape[:2]
            if route == "cluster" and not backward_cluster_plan(dev.index, Bn, H)[0]:
                continue  # B=8 at H=512: the two planes do not fit beside w_hh's slice; the grid route serves it
            before = gru_sequence_backward.cluster_launches
            got = gru_sequence_backward(*args, gates=given)
            ref = gru_sequence_backward_plain(*args, gates=given)
            torch.cuda.synchronize()
            assert gru_sequence_backward.cluster_launches - before == (route == "cluster"), route
            errs = {}
            for name, a, b in zip(names, got, ref):
                scale = max(1.0, float(b.abs().max()))  # d_w_hh sums T * B rows: held relative to its scale
                errs[name] = float((a - b).abs().max())
                assert a.shape == b.shape and errs[name] <= 1e-5 * scale, f"B1 backward {route} {label} {name}: {errs[name]} at scale {scale}"
            print(f"B1 backward {route} route T={T} B={Bn} H={H}, strided h0, transposed d_out: max_abs_err "
                  + ", ".join(f"{n} {e:.3e}" for n, e in errs.items()) + " (atol 1e-5 x max(1, scale))")
            worst[f"{route}_{label}"] = errs

    # the whole route on the card: the forward kernel's own reserve into the cluster route
    *args, _ = shapes["train"]
    d_out, xi, masks, h0, w_hh, b_hh, _ = args
    out, reserve = _forward_launch(xi, masks, h0, w_hh, b_hh, reserve=True)
    got = gru_sequence_backward(d_out, xi, masks, h0, w_hh, b_hh, out, gates=reserve)
    ref = gru_sequence_backward_plain(d_out, xi, masks, h0, w_hh, b_hh, out)
    torch.cuda.synchronize()
    chain = max(float((a - b).abs().max()) / max(1.0, float(b.abs().max())) for a, b in zip(got, ref))
    print(f"B1 forward kernel's reserve -> cluster route at T={TRAIN_T} B={TRAIN_B}, against the recomputing plain "
          f"backward on the kernel's out: max err relative to max(1, scale) {chain:.3e} (1e-4: the reserve is the forward kernel's)")
    assert chain <= 1e-4

    # device times at the training shape by CUDA-graph replay: each route's
    # recurrence alone into buffers allocated once, the weight gradient alone,
    # and the wrapper (allocations, d_out's copy, recurrence, weight gradient)
    train = tuple(t.contiguous() if i == 0 else t for i, t in enumerate(shapes["train"]))
    d_out, xi, masks, h0, w_hh, b_hh, out, gates = train
    d_xi, d_gh, d_h0 = torch.empty_like(xi), torch.empty_like(xi), torch.empty(TRAIN_B, H, device=dev)
    d_w_hh, d_b_hh = torch.empty_like(w_hh), torch.empty_like(b_hh)
    scratch = torch.empty(2, H // _BLOCK_UNITS, TRAIN_B, H, device=dev)
    gru_sequence_backward(*train)  # d_gh for the weight gradient's own timing
    cluster_kernel_ms = graph_ms(lambda: _cluster_launch(d_out, gates, masks, h0, w_hh, out, d_xi, d_h0, d_gh, cluster))
    grid_kernel_ms = graph_ms(lambda: _backward_launch(d_out, xi, masks, h0, w_hh, b_hh, out, d_xi, d_h0, d_gh, scratch))
    weight_ms = graph_ms(lambda: _weight_gradient_launch(d_gh, masks, h0, out, d_w_hh, d_b_hh))
    cluster_ms = graph_ms(lambda: gru_sequence_backward(*train))
    grid_ms = graph_ms(lambda: gru_sequence_backward(*train[:-1]))
    # the plain version is the torch ops that compute the weight gradient's function (cat, multiply, matmul,
    # sum); no one PyTorch call does, so there is no library yardstick: the matmul on an h_prev formed
    # beforehand is printed beside it, and does less than the kernel
    weight_plain_ms = graph_ms(lambda: gru_weight_gradient_plain(d_gh, masks, h0, out))
    h_prev = torch.cat([h0[None], out[:-1]]) * masks
    matmul_ms = graph_ms(lambda: d_gh.reshape(-1, 3 * H).T @ h_prev.reshape(-1, H))
    plain_ms = cuda_ms(lambda: gru_sequence_backward_plain(*train[:-1]), iters=5, warmup=1)
    # yardstick only, the port never calls it: autograd through cuDNN's GRU on
    # [T, B, H] inputs (no resets, and it also differentiates the input
    # projection, which B1 leaves to a matmul outside); autograd's calls
    # cannot be captured, so CUDA events around back-to-back calls
    gru = torch.nn.GRU(H, H).to(dev)
    x = torch.randn(TRAIN_T, TRAIN_B, H, device=dev, requires_grad=True)
    y, _ = gru(x, h0[None].contiguous())
    lib_ms = cuda_ms(lambda: torch.autograd.grad(y, [x] + list(gru.parameters()), d_out, retain_graph=True), iters=50)
    rows = TRAIN_T * TRAIN_B
    product = 2 * rows * 3 * H * H  # the FLOPs of one [rows, 3H] x [3H, H] product
    # the recurrence (the cluster launch): reads d_out, the gates, masks, h0,
    # out and w_hh, writes d_xi, d_gh and d_h0; one product, d_gh . w_hh, and
    # about 20 operations per (row, unit) for the gates' gradients
    moved = nbytes(d_out, gates, masks, h0, out, w_hh) + nbytes(d_xi, d_gh, d_h0)
    b_ms, b_by = bound_ms(moved, product + rows * 20 * H)
    # the weight gradient's launch: reads d_gh, masks, h0 and out, writes d_w_hh and d_b_hh; d_gh^T . h_prev
    w_moved = nbytes(d_gh, masks, h0, out, d_w_hh, d_b_hh)
    wb_ms, wb_by = bound_ms(w_moved, product + rows * 3 * H)
    # for comparison only: the whole gradient given the gates (the wrapper's work: two products, d_gh not
    # stored), and PR 4's figure for a kernel that recomputed the gates (a third product, h_prev . w_hh^T)
    whole_ms, _ = bound_ms(nbytes(d_out, gates, masks, h0, out, w_hh) + nbytes(d_xi, d_h0, d_w_hh, d_b_hh),
                           2 * product + rows * 23 * H)
    recompute_ms, _ = bound_ms(nbytes(*train[:-1]) + nbytes(xi, h0, w_hh, b_hh), 3 * product + rows * 40 * H)
    print(f"B1 backward at T={TRAIN_T} B={TRAIN_B} H={H}, device time by graph replay: cluster route (cluster of {cluster}) "
          f"recurrence alone {cluster_kernel_ms:.4f} ms "
          f"({1e3 * cluster_kernel_ms / TRAIN_T:.2f} us per step), wrapper {cluster_ms:.4f} ms; grid route recurrence alone "
          f"{grid_kernel_ms:.4f} ms ({1e3 * grid_kernel_ms / TRAIN_T:.2f} us per step), wrapper {grid_ms:.4f} ms; "
          f"weight gradient kernel {weight_ms:.4f} ms against its plain torch ops {weight_plain_ms:.4f} ms (torch.matmul alone {matmul_ms:.4f}, "
          f"bound {wb_ms:.4f} {wb_by}); plain loop {plain_ms:.4f} ms (CUDA events, host-bound); autograd through cuDNN GRU "
          f"{lib_ms:.4f} ms (CUDA events); recurrence's bound {b_ms:.4f} ms ({b_by}, {moved / 1e6:.2f} MB, "
          f"{(product + rows * 20 * H) / 1e9:.3f} GFLOP); the whole gradient's given the gates {whole_ms:.4f} ms; "
          f"recomputing the gates (PR 4's definition) {recompute_ms:.4f} ms")

    # T = 1 by both routes
    step = tuple(t.contiguous() if i == 0 else t for i, t in enumerate(shapes["step"]))
    step5 = tuple(t.contiguous() if i == 0 else t for i, t in enumerate(shapes["step_B5"]))
    step_ms = graph_ms(lambda: gru_sequence_backward(*step[:-1]))
    step5_ms = graph_ms(lambda: gru_sequence_backward(*step5))
    step_plain_ms = graph_ms(lambda: gru_sequence_backward_plain(*step[:-1]))
    print(f"B1 backward at T=1, device time by graph replay: grid route B={N_ENVS} wrapper {step_ms:.4f} ms (plain "
          f"{step_plain_ms:.4f}); cluster route B={TRAIN_B} wrapper {step5_ms:.4f} ms")
    backward = {
        "name": "gru_sequence_backward", "route": "cuda", "source": "vlnce_torch/csrc/gru_sequence.cu",
        "replaces": "vlnce_tpu/ops/pallas_rnn.py:55",
        "note": "the gradient of B1; the JAX package differentiates the lax.scan of vlnce_tpu/models/rnn_state_encoder.py:133",
        # max_abs_err: the largest over all four outputs at the training shape on the cluster route; ms (and
        # kernel_ms) and bound_ms: the recurrence's launch alone, the weight gradient has its own entry;
        # wrapper_ms: the wrapper on that route (its launch, the allocations, d_out's copy and the weight
        # gradient's launch) beside bound_ms_gradient; earlier_ms: the grid route's recurrence alone (the earlier
        # design, recomputing the gates) beside bound_ms_recompute
        "max_abs_err": max(worst["cluster_train"].values()), "max_abs_err_by_output": worst["cluster_train"],
        "max_abs_err_grid": max(worst["grid_train"].values()),
        "ms": cluster_kernel_ms, "kernel_ms": cluster_kernel_ms, "wrapper_ms": cluster_ms, "earlier_ms": grid_kernel_ms,
        "grid_ms": grid_ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "bound_ms_gradient": whole_ms, "bound_ms_recompute": recompute_ms,
        "library_ms": lib_ms, "weight_gradient_ms": weight_ms, "weight_gradient_torch_ms": weight_plain_ms,
        "cluster": cluster, "max_active_clusters": active, "step_T1_B8_ms": step_ms, "step_T1_B8_plain_ms": step_plain_ms,
        "step_T1_B5_ms": step5_ms,
    }
    got = gru_weight_gradient(d_gh, masks, h0, out)
    ref = gru_weight_gradient_plain(d_gh, masks, h0, out)
    torch.cuda.synchronize()
    w_err = max(float((a - b).abs().max()) / max(1.0, float(b.abs().max())) for a, b in zip(got, ref))
    assert w_err <= 1e-5, w_err
    weight = {
        "name": "gru_weight_gradient", "route": "cuda", "source": "vlnce_torch/csrc/gru_sequence.cu",
        "replaces": "vlnce_tpu/ops/pallas_rnn.py:55",
        "note": "d_w_hh and d_b_hh of B1's gradient over all T * B rows; max_abs_err relative to max(1, scale); no one "
                "PyTorch call computes this function (library_ms null): plain_ms is the torch ops that do (gather of h0, "
                "masking, matmul, sum), matmul_ready_h_prev_ms the product alone on an h_prev formed beforehand",
        "max_abs_err": w_err, "ms": weight_ms, "kernel_ms": weight_ms, "plain_ms": weight_plain_ms,
        "bound_ms": wb_ms, "bound_by": wb_by, "library_ms": None, "matmul_ready_h_prev_ms": matmul_ms,
    }
    return backward, weight


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
def plain_versions(resize: bool = True):
    """Swap the plain PyTorch versions in where the act step calls the
    kernels' wrappers, for the whole-path reference run; with `resize`
    False B2 stays the kernel and only B1 is swapped."""
    import vlnce_torch.models.rnn_state_encoder as rse
    import vlnce_torch.ops.obs_transforms as ot
    from vlnce_torch.ops.preprocess import fused_resize_normalize_plain
    from vlnce_torch.ops.rnn import gru_sequence_plain

    saved = rse.gru_sequence, ot.fused_resize_normalize
    rse.gru_sequence = gru_sequence_plain
    if resize:
        ot.fused_resize_normalize = fused_resize_normalize_plain
    try:
        yield
    finally:
        rse.gru_sequence, ot.fused_resize_normalize = saved


def _counted():
    from vlnce_torch.ops.preprocess import fused_resize_normalize
    from vlnce_torch.ops.rnn import gru_sequence, gru_sequence_backward, gru_weight_gradient

    return {"gru_sequence": gru_sequence, "gru_sequence_backward": gru_sequence_backward,
            "gru_weight_gradient": gru_weight_gradient, "fused_resize_normalize": fused_resize_normalize}


def _reset_launches():
    for wrapper in _counted().values():
        wrapper.launches = 0
    _counted()["gru_sequence_backward"].cluster_launches = 0


def _cluster_launches():
    """How many of B1's backward launches since the last reset took the cluster route."""
    return _counted()["gru_sequence_backward"].cluster_launches


def _read_launches():
    return {name: wrapper.launches for name, wrapper in _counted().items()}


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
    assert launches == {"gru_sequence": 2 * STEPS, "gru_sequence_backward": 0, "gru_weight_gradient": 0,
                        "fused_resize_normalize": 2 * STEPS}, launches
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


def _run_loop(run_type, opts, exp=EXP, per_act_step=(2, 0, 0, 2)):
    """One `run_exp` with the launch counters set to 0 just before and read
    just after; B1, its backward, its weight gradient and B2 must have risen
    by exactly `per_act_step` per act step of the loop."""
    from vlnce_torch.run import run_exp

    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    trainer = run_exp(exp, run_type, opts)
    wall = time.perf_counter() - t0
    launches, timing = _read_launches(), trainer.last_loop_timing
    print(f"{run_type} launches over {timing['act_steps']} act steps: {json.dumps(launches)}")
    assert timing["act_steps"] > 0 and list(launches.values()) == [n * timing["act_steps"] for n in per_act_step], (launches, timing)
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


# ---------------------------------------------------------------------------
# training: R2R CMA DAgger through the entry point, then eval of its checkpoint
# ---------------------------------------------------------------------------

R2R_EXP = "vlnce_torch/config/experiments/r2r_baselines/cma_pm_da_aug_tune.yaml"
TRAIN_EPISODES, TRAIN_EPOCHS, TRAIN_ITERATIONS = 16, 2, 2


def build_train_step(dev, dtype: str, T: int = TRAIN_T, N: int = TRAIN_B, seed: int = 5, mark=None):
    """The R2R CMA DAgger config at full width on `dev`, its policy with
    seeded weights, masked Adam, the IL train step, and one seeded [T, N] batch
    on `dev` as the trainer hands it over (cached features of the frozen
    encoders, 200-token instructions, progress): (cfg, policy, optimizer,
    train_step, batch)."""
    from vlnce_torch.config import get_config
    from vlnce_torch.envs.spaces import action_space_from_config, observation_space_from_config
    from vlnce_torch.models.cma_policy import CMAPolicy
    from vlnce_torch.parallel.il_step import build_il_train_step
    from vlnce_torch.parallel.optim import masked_adam

    cfg = get_config(R2R_EXP, ["CUDA.DEVICE", str(dev), "CUDA.PRECISION.compute_dtype", dtype])
    space = observation_space_from_config(cfg.TASK_CONFIG)
    policy = CMAPolicy.from_config(cfg, space, action_space_from_config(cfg.TASK_CONFIG))
    optimizer = masked_adam(cfg.IL.lr, policy, cfg.MODEL)
    rng = np.random.RandomState(seed)
    tokens = np.zeros((N,) + space["instruction"].shape, np.int64)
    for n in range(N):
        length = rng.randint(8, 30)
        tokens[n, :length] = rng.randint(2, 32, length)
    depth_chw = policy.net.depth_encoder.visual_encoder.output_shape_chw()
    masks = np.ones((T, N), np.float32)
    masks[0] = 0.0
    weights = np.where(rng.rand(T, N) < 0.3, 3.2, 1.0).astype(np.float32)
    weights[T - 3:, 0] = 0.0  # one episode shorter than the batch's length
    arrays = (
        {
            "instruction": np.broadcast_to(tokens, (T,) + tokens.shape).astype(np.int32),
            "progress": np.broadcast_to(np.linspace(0, 1, T, dtype=np.float32)[:, None, None], (T, N, 1)),
            "rgb_features": rng.randn(T, N, policy.net.rgb_encoder.resnet_layer_size, 4, 4).astype(np.float32),
            "depth_features": np.abs(rng.randn(T, N, *depth_chw)).astype(np.float32),
        },
        rng.randint(0, 4, (T, N)), masks, rng.randint(0, 4, (T, N)), weights,
    )
    obs, *rest = arrays
    batch = ({k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in obs.items()},
             *(torch.from_numpy(a).to(dev) for a in rest))
    train_step = build_il_train_step(policy, optimizer, **({"mark": mark} if mark else {}))
    return cfg, policy, optimizer, train_step, batch


def phase_train_step(dev, steps: int = 10):
    """The train step alone at the training shape (T = TRAIN_T, N = TRAIN_B),
    its batch already on the card: the split by CUDA events over `steps` warm
    steps, and B1's launches per step."""
    from vlnce_torch.utils.profiling import StepClock

    clock = StepClock(dev)
    _, policy, _, train_step, batch = build_train_step(dev, "bfloat16", mark=clock.mark)
    for _ in range(3):
        clock.start()
        train_step(*batch)
    warm_up = clock.totals()
    _reset_launches()
    t0 = time.perf_counter()
    losses = []
    for _ in range(steps):
        clock.start()
        losses.append(train_step(*batch)[0])
    totals = {k: v - warm_up[k] for k, v in clock.totals().items()}
    wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    launches = _read_launches()
    assert launches == {"gru_sequence": 2 * steps, "gru_sequence_backward": 2 * steps, "gru_weight_gradient": 2 * steps,
                        "fused_resize_normalize": 0}, launches
    assert _cluster_launches() == 2 * steps, "B1's backward did not take the cluster route on the train step"
    losses = torch.stack(losses).tolist()
    assert all(math.isfinite(x) for x in losses) and losses[-1] < losses[0], losses  # one batch, repeated: the loss must fall
    print(f"train step alone at T={TRAIN_T} N={TRAIN_B}, batch on the card, {steps} warm steps: {wall_ms:.2f} ms per step by the host's clock; "
          + ", ".join(f"{k} {totals[k] / steps:.2f}" for k in ("forward", "backward", "optimizer")) + " ms by CUDA events; "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; launches {json.dumps(launches)}")
    return launches


def phase_train_step_against_plain(dev):
    """The train step's forward and backward in f32 (TF32 off) from one set of
    seeded weights and one batch at the training shape, once through both B1
    kernels and once with the plain loop under ordinary autograd: the three
    losses must agree within 1e-5 relative, and every trainable gradient
    within 1e-5 of the tensor's own scale (max |plain|) plus 1e-8 of the
    largest gradient of all: a gradient that is zero by the formula (the
    bias of the attention keys, which softmax shifts out) is rounding noise
    in both runs and has no scale of its own."""
    from vlnce_torch.parallel.il_step import il_losses

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _, policy, _, _, batch = build_train_step(dev, "float32")

    def losses_and_gradients():
        policy.zero_grad(set_to_none=True)
        losses = il_losses(policy, *batch)
        losses[0].backward()
        return torch.stack(losses).detach(), {k: p.grad.clone() for k, p in policy.named_parameters() if p.requires_grad}

    _reset_launches()
    k_losses, k_grads = losses_and_gradients()
    launches = _read_launches()
    assert launches == {"gru_sequence": 2, "gru_sequence_backward": 2, "gru_weight_gradient": 2,
                        "fused_resize_normalize": 0}, launches
    assert _cluster_launches() == 2, "B1's backward did not take the cluster route"
    with plain_versions():
        p_losses, p_grads = losses_and_gradients()
    assert _read_launches() == launches, "the plain run launched a kernel"
    assert sorted(k_grads) == sorted(p_grads) and len(p_grads) > 0
    err_l = float(((k_losses - p_losses).abs() / p_losses.abs()).max())
    largest = max(float(ref.abs().max()) for ref in p_grads.values())
    ratios = {}
    for name, ref in p_grads.items():
        scale = float(ref.abs().max())
        err = float((k_grads[name] - ref).abs().max())
        ratios[name] = (err / (1e-5 * scale + 1e-8 * largest), err, scale)  # 1.0 is the tolerance
    worst = sorted(ratios.items(), key=lambda kv: -kv[1][0])[:3]
    print(f"f32 train step at T={TRAIN_T} N={TRAIN_B}, kernels vs plain loop under autograd: losses {k_losses.tolist()} vs {p_losses.tolist()} "
          f"(max relative diff {err_l:.3e}, held at 1e-5); {len(p_grads)} gradients, the largest max |plain| {largest:.3e}; nearest to "
          f"the tolerance 1e-5 x max |plain| + 1e-8 x that: "
          + "; ".join(f"{name} at {r:.3f} of it (|diff| {e:.3e}, max |plain| {sc:.3e})" for name, (r, e, sc) in worst))
    assert all(bool(torch.isfinite(g).all()) for g in k_grads.values()), "non-finite gradient"
    assert err_l <= 1e-5 and worst[0][1][0] <= 1.0, "the f32 train step through the kernels disagrees with the plain loop"


def phase_training(dev):
    from vlnce_torch.config import get_config
    from vlnce_torch.envs.spaces import action_space_from_config, observation_space_from_config
    from vlnce_torch.models.cma_policy import CMAPolicy
    from vlnce_torch.parallel.optim import trainable_mask
    from vlnce_torch.run import run_exp
    from vlnce_torch.trainers.dagger_trainer import DaggerTrainer
    from vlnce_torch.utils.checkpoints import load_checkpoint

    with tempfile.TemporaryDirectory(prefix="vlnce_torch_smoke_") as tmp:
        ckpts = os.path.join(tmp, "checkpoints")
        common = [
            "TASK_CONFIG.DATASET.TYPE", "Synthetic-VLN-v0",
            "TASK_CONFIG.DATASET.NUM_SCENES", N_ENVS,  # one scene per worker
            "TASK_CONFIG.DATASET.NUM_EPISODES", 64,
            "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", 40,  # T of a batch is then 16, 32 or 48
            "NUM_ENVIRONMENTS", N_ENVS,
            "TENSORBOARD_DIR", "", "VERBOSE", False, "LOG_FILE", os.path.join(tmp, "run.log"),
            "CHECKPOINT_FOLDER", ckpts,
        ]
        train_opts = common + [
            "IL.load_from_ckpt", False, "IL.DAGGER.iterations", TRAIN_ITERATIONS, "IL.DAGGER.update_size", TRAIN_EPISODES,
            "IL.epochs", TRAIN_EPOCHS, "IL.batch_size", TRAIN_B, "CUDA.PIPELINED_COLLECTION", True,
            "IL.DAGGER.lmdb_features_dir", os.path.join(tmp, "trajectories"),
        ]
        # the seeded weights the trainer starts from: the same config gives the same draw
        cfg = get_config(R2R_EXP, train_opts)
        start = CMAPolicy.from_config(cfg, observation_space_from_config(cfg.TASK_CONFIG), action_space_from_config(cfg.TASK_CONFIG))
        mask = trainable_mask(start, cfg.MODEL)
        start = {k: v.cpu() for k, v in start.state_dict().items()}

        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t0 = time.perf_counter()
        DaggerTrainer.time_train_steps = True  # the split of every train step by CUDA events
        try:
            trainer = run_exp(R2R_EXP, "train", train_opts)
        finally:
            DaggerTrainer.time_train_steps = False
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_launches()
        peak = torch.cuda.max_memory_allocated()

        rounds, history = trainer.collection_stats, trainer.loss_history
        collect_steps = sum(r["collect_steps"] for r in rounds)
        train_steps = len(history)
        print(f"training: {R2R_EXP} at full width ({trainer.policy.num_params() / 1e6:.1f}M weights, "
              f"{sum(mask.values())} of {len(mask)} parameter tensors trainable), run_exp took {wall:.1f} s")
        print(f"training launches over {collect_steps} collection steps and {train_steps} train steps: {json.dumps(launches)}")
        assert train_steps > 0 and collect_steps > 0
        assert launches == {"gru_sequence": 2 * collect_steps + 2 * train_steps, "gru_sequence_backward": 2 * train_steps,
                            "gru_weight_gradient": 2 * train_steps, "fused_resize_normalize": 0}, launches
        assert _cluster_launches() == 2 * train_steps, "B1's backward did not take the cluster route in training"
        assert [r["beta"] for r in rounds] == [1.0, 0.5] and all(r["episodes"] >= TRAIN_EPISODES for r in rounds), rounds
        for r in rounds:
            print(f"collection round {r['data_it']} (beta {r['beta']}): {r['episodes']} episodes, {r['env_steps']} env steps in "
                  f"{r['collect_steps']} collect steps of two groups of {N_ENVS // 2}; {r['env_steps'] / r['total_time']:.1f} env-steps/s "
                  f"of the whole round ({r['total_time']:.2f} s with the workers' start), pth_time {r['pth_time']:.3f} s : env_time {r['env_time']:.3f} s "
                  f"({1e3 * r['pth_time'] / r['collect_steps']:.1f} ms per collect step)")

        losses = np.array([h[2:] for h in history])
        assert np.isfinite(losses).all(), "non-finite training loss"
        # the action loss (cross-entropy) starts at ln 4 for every batch, since the seeded head is
        # near uniform, so its fall shows across batches; the aux loss (squared progress error)
        # follows each batch's share of early and late steps, and with it the sum
        first = [h for h in history if h[0] == 0]
        last_epoch = np.mean([h[2:] for h in first if h[1] == TRAIN_EPOCHS - 1], axis=0)
        print("losses (loss, action, aux) of iteration 0: first batch " + " ".join(f"{x:.4f}" for x in first[0][2:])
              + "; mean of its last epoch " + " ".join(f"{x:.4f}" for x in last_epoch)
              + "; last batch of the run " + " ".join(f"{x:.4f}" for x in history[-1][2:]))
        assert last_epoch[1] < first[0][3], "the action loss of iteration 0 did not fall"

        clock = trainer.step_clock.totals()
        assert sorted(clock) == ["backward", "forward", "optimizer", "upload"] and trainer.step_clock.steps == train_steps
        first_step = dict(trainer.step_clock.first)
        warm = {k: (clock[k] - first_step[k]) / (train_steps - 1) for k in clock}  # the first step warms the libraries up
        step_ms = sum(warm.values())
        order = ("upload", "forward", "backward", "optimizer")
        print(f"train step by CUDA events, mean of the {train_steps - 1} steps after the first: {step_ms:.2f} ms per step = "
              + ", ".join(f"{k} {warm[k]:.2f}" for k in order) + f" ms; {1e3 / step_ms:.1f} steps/s; the first step "
              + ", ".join(f"{k} {first_step[k]:.1f}" for k in order) + f" ms; T values seen {json.dumps(trainer.train_lengths, sort_keys=True)}; "
              f"peak card memory {peak / 2**30:.2f} GiB")

        after = trainer.policy.state_dict()
        assert {p.device.type for p in trainer.policy.parameters()} == {"cuda"}, "the policy is not on the card"
        moved = {k for k in mask if not torch.equal(after[k].cpu(), start[k])}
        frozen = {k for k, trains in mask.items() if not trains}
        assert moved == set(mask) - frozen, (sorted(moved & frozen)[:3], sorted(set(mask) - frozen - moved)[:3])
        named = dict(trainer.policy.named_parameters())
        with_state = {k for k, p in named.items() if p in trainer.optimizer.state}
        assert with_state == set(mask) - frozen and all(named[k].grad is None for k in frozen)
        print(f"weights: {len(frozen)} frozen tensors bit-equal to the seeded start, {len(moved)} trainable tensors changed, "
              f"Adam state for {len(with_state)} tensors")

        last = os.path.join(ckpts, f"ckpt.{TRAIN_ITERATIONS * TRAIN_EPOCHS - 1}.ckpt")
        saved = load_checkpoint(last)
        assert len(saved["optim_state"]["state"]) == len(with_state) and saved["extra_state"]["dagger_it"] == TRAIN_ITERATIONS - 1
        evaluator, eval_launches, eval_wall = _run_loop("eval", common + [
            "EVAL.EPISODE_COUNT", 8, "EVAL.USE_CKPT_CONFIG", False, "EVAL_CKPT_PATH_DIR", last,
            "RESULTS_DIR", os.path.join(tmp, "evals"),
        ], exp=R2R_EXP, per_act_step=(2, 0, 0, 0))
        head = "action_distribution.linear.weight"
        assert torch.equal(evaluator.policy.state_dict()[head], after[head]), "eval did not load the trained weights"
        with open(os.path.join(tmp, "evals", f"stats_ckpt_0_{cfg.EVAL.SPLIT}.json")) as f:
            stats = json.load(f)
        assert sorted(stats) == sorted(RXR_MEASURES) and all(math.isfinite(v) for v in stats.values()), stats
        print(f"eval of {os.path.basename(last)} ({os.path.getsize(last) / 1e6:.1f} MB with optimizer state): "
              f"{len(evaluator._last_eval_episode_stats)} episodes in {eval_wall:.1f} s, stats {json.dumps({k: round(v, 4) for k, v in stats.items()})}")
    return launches, eval_launches


# ---------------------------------------------------------------------------
# the recollect trainer's shapes: B1 at B = IL.batch_size 3 up to the YAML's
# longest episode, B2 over every collated frame of a batch
# ---------------------------------------------------------------------------

RECOLLECT_N = 3  # IL.batch_size of the RxR baselines
RECOLLECT_T = 48  # the longest padded batch of phase_recollect (episodes of at most 40 steps)
RECOLLECT_T_MAX = 256  # max_traj_len 250 of the YAMLs, padded to a multiple of 16


def _gru_bound(T, Bn, H, reserve):
    """The B1 forward's bound at [T, Bn, H]: it reads xi, masks, h0, w_hh and
    b_hh once, writes out (and the gates with `reserve`); one product per
    step and about 12 operations per (row, unit) for the gates."""
    moved = 4 * (T * Bn * 3 * H + T * Bn + Bn * H + 3 * H * H + 3 * H + T * Bn * H + (T * Bn * 4 * H if reserve else 0))
    return bound_ms(moved, T * (2 * 3 * H * H * Bn + 12 * H * Bn))


def phase_recollect_shapes(dev):
    """B1 at the recollect trainer's batch (B <= 3) and lengths up to the
    YAMLs' 250 steps: the cluster granted at B in {1, 2, 3}; the forward
    storing the gates, the cluster-route backward and the weight gradient
    against their plain versions at T in {1, 57, 250}; device times at the
    train step's shapes (T=32, B=5 and the recollect T in {48, 256}, B=3)
    beside the bound and cuDNN's GRU. B2 over one batch of collated frames
    (T=48 x N=3 = 144 RGB and depth frames at 480x640) against its plain
    version, timed beside the bound and F.interpolate. Returns fields for the
    kernels line of B1, its backward, its weight gradient and B2."""
    import torch.nn.functional as F

    from vlnce_torch.ops.preprocess import fused_resize_normalize, fused_resize_normalize_plain
    from vlnce_torch.ops.rnn import (_forward_launch, backward_cluster_plan, gru_sequence_backward,
                                     gru_sequence_backward_plain, gru_sequence_plain, gru_weight_gradient)

    H = 512
    g = torch.Generator(device="cpu").manual_seed(6)
    for Bn in (1, 2, 3):
        cluster, active = backward_cluster_plan(dev.index, Bn, H)
        print(f"B1 backward cluster route at B={Bn} H={H}: cluster of {cluster} blocks granted, "
              f"cudaOccupancyMaxActiveClusters {active}")
        assert cluster > 0 and active >= 1, f"the cluster route does not take B={Bn}"

    def inputs(T, Bn):
        xi = torch.randn(T, Bn, 3 * H, generator=g)
        masks = torch.ones(T, Bn, 1)
        masks[T // 3, ::2] = 0.0
        masks[(2 * T) // 3, 1::2] = 0.0
        states = torch.stack([torch.randn(Bn, H, generator=g), torch.full((Bn, H), float("nan"))], dim=1)
        w_hh = torch.randn(3 * H, H, generator=g) * H**-0.5
        b_hh = torch.randn(3 * H, generator=g) * 0.1
        d_out = torch.randn(T, Bn, H, generator=g)
        xi, masks, states, w_hh, b_hh, d_out = (t.to(dev) for t in (xi, masks, states, w_hh, b_hh, d_out))
        return d_out, xi, masks, states[:, 0], w_hh, b_hh

    worst = {"forward": 0.0, "gates": 0.0, "backward": 0.0}
    for T in (1, 57, 250):
        for Bn in (1, 2, 3):
            d_out, xi, masks, h0, w_hh, b_hh = inputs(T, Bn)
            out, gates = _forward_launch(xi, masks, h0, w_hh, b_hh, reserve=True)
            ref_out, ref_gates = gru_sequence_plain(xi, masks, h0, w_hh, b_hh, return_gates=True)
            before = gru_sequence_backward.cluster_launches
            got = gru_sequence_backward(d_out, xi, masks, h0, w_hh, b_hh, ref_out, gates=ref_gates)
            ref = gru_sequence_backward_plain(d_out, xi, masks, h0, w_hh, b_hh, ref_out, gates=ref_gates)
            torch.cuda.synchronize()
            assert gru_sequence_backward.cluster_launches == before + 1, "the backward left the cluster route"
            errs = {"forward": float((out - ref_out).abs().max()), "gates": float((gates - ref_gates).abs().max())}
            by_output = {}
            for name, a, b in zip(("d_xi", "d_h0", "d_w_hh", "d_b_hh"), got, ref):
                scale = max(1.0, float(b.abs().max()))
                by_output[name] = float((a - b).abs().max()) / scale
            errs["backward"] = max(by_output.values())
            print(f"B1 at T={T} B={Bn} H={H}, strided h0, resets at T/3 and 2T/3: forward storing the gates max_abs_err "
                  f"out {errs['forward']:.3e} gates {errs['gates']:.3e} (atol 1e-4); cluster-route backward and weight "
                  f"gradient, max err relative to max(1, scale): " + ", ".join(f"{n} {e:.3e}" for n, e in by_output.items())
                  + " (1e-5)")
            assert errs["forward"] <= 1e-4 and errs["gates"] <= 1e-4 and errs["backward"] <= 1e-5, (T, Bn, errs)
            worst = {k: max(worst[k], errs[k]) for k in worst}

    # device times at the train steps' shapes
    fields = {"forward": {}, "backward": {}, "weight": {}}
    for T, Bn in ((TRAIN_T, TRAIN_B), (RECOLLECT_T, RECOLLECT_N), (RECOLLECT_T_MAX, RECOLLECT_N)):
        d_out, xi, masks, h0, w_hh, b_hh = inputs(T, Bn)
        out, gates = _forward_launch(xi, masks, h0, w_hh, b_hh, reserve=True)
        fwd_ms = graph_ms(lambda: _forward_launch(xi, masks, h0, w_hh, b_hh, reserve=True), reps=5)
        plain_ms = cuda_ms(lambda: gru_sequence_plain(xi, masks, h0, w_hh, b_hh), iters=3, warmup=1)
        bwd_ms = graph_ms(lambda: gru_sequence_backward(d_out, xi, masks, h0, w_hh, b_hh, out, gates=gates), reps=5)
        _, _, d_w, _ = gru_sequence_backward(d_out, xi, masks, h0, w_hh, b_hh, out, gates=gates)
        d_gh = torch.randn(T, Bn, 3 * H, device=dev)
        w_ms = graph_ms(lambda: gru_weight_gradient(d_gh, masks, h0, out), reps=5)
        # yardsticks only, the port never calls them: cuDNN's GRU over [T, Bn, H]
        # (no resets), forward, and autograd's backward through it (CUDA events)
        gru = torch.nn.GRU(H, H).to(dev)
        x = torch.randn(T, Bn, H, device=dev, requires_grad=True)
        h0c = h0[None].contiguous()
        with torch.no_grad():
            lib_fwd_ms = cuda_ms(lambda: gru(x, h0c), iters=20)
        y, _ = gru(x, h0c)
        lib_bwd_ms = cuda_ms(lambda: torch.autograd.grad(y, [x] + list(gru.parameters()), d_out, retain_graph=True), iters=20)
        fb_ms, fb_by = _gru_bound(T, Bn, H, reserve=True)
        rows, product = T * Bn, 2 * T * Bn * 3 * H * H
        # the wrapper's work given the gates: two products (d_gh . w_hh and the weight gradient), d_gh not stored
        bb_ms, bb_by = bound_ms(nbytes(d_out, gates, masks, h0, out, w_hh) + nbytes(xi, h0, w_hh, b_hh), 2 * product + rows * 23 * H)
        wb_ms, wb_by = bound_ms(nbytes(d_gh, masks, h0, out, w_hh, b_hh), product + rows * 3 * H)
        tag = f"T{T}_B{Bn}"
        print(f"B1 at T={T} B={Bn} H={H}, device time by graph replay: forward storing the gates {fwd_ms:.4f} ms (bound "
              f"{fb_ms:.4f} {fb_by}; plain loop {plain_ms:.4f} by CUDA events; cuDNN nn.GRU forward, no resets, {lib_fwd_ms:.4f} "
              f"by CUDA events); backward wrapper (cluster route + weight gradient) {bwd_ms:.4f} ms (its bound given the gates "
              f"{bb_ms:.4f} {bb_by}; autograd through cuDNN nn.GRU {lib_bwd_ms:.4f} by CUDA events); weight gradient "
              f"{w_ms:.4f} ms (bound {wb_ms:.4f} {wb_by}); |d_w_hh| max {float(d_w.abs().max()):.3e}")
        fields["forward"].update({f"{tag}_ms": fwd_ms, f"{tag}_bound_ms": fb_ms, f"{tag}_plain_ms": plain_ms,
                                  f"{tag}_library_ms": lib_fwd_ms})
        fields["backward"].update({f"{tag}_wrapper_ms": bwd_ms, f"{tag}_bound_ms": bb_ms, f"{tag}_library_ms": lib_bwd_ms})
        fields["weight"].update({f"{tag}_ms": w_ms, f"{tag}_bound_ms": wb_ms})
    fields["forward"]["max_abs_err_recollect"] = max(worst["forward"], worst["gates"])
    fields["backward"]["max_err_recollect"] = worst["backward"]

    # B2 over one batch of collated frames, as the recollect train step runs it
    frames = RECOLLECT_T * RECOLLECT_N
    rgb = torch.randint(0, 256, (frames, 480, 640, 3), generator=g, dtype=torch.uint8).to(dev)
    depth = torch.rand(frames, 480, 640, 1, generator=g).to(dev)
    depth[-RECOLLECT_N:] = 1.0  # a padded step: collate fills it with ones
    calls = [(rgb, dict(normalize=False, out_dtype=torch.uint8, scale_values=False)),
             (depth, dict(normalize=False, out_dtype=torch.float32, scale_values=False))]
    err = 0.0
    for x, kw in calls:
        out = fused_resize_normalize(x, (256, 341), **kw)
        ref = fused_resize_normalize_plain(x, (256, 341), **kw)
        torch.cuda.synchronize()
        err = max(err, _resize_err(out, ref, kw["out_dtype"], False))
    floats = [x.permute(0, 3, 1, 2).float() for x, _ in calls]

    def kernel():
        for x, kw in calls:
            fused_resize_normalize(x, (256, 341), **kw)

    def plain():
        for x, kw in calls:
            fused_resize_normalize_plain(x, (256, 341), **kw)

    def library():  # yardstick only: the port never calls F.interpolate
        for xf in floats:
            F.interpolate(xf, size=(256, 341), mode="bilinear", align_corners=False, antialias=False)

    ms, lib_ms = graph_ms(kernel, reps=3, replays=5), graph_ms(library, reps=3, replays=5)
    plain_ms = cuda_ms(plain, iters=2, warmup=1)
    moved = sum(nbytes(x) + x.shape[0] * 256 * 341 * x.shape[3] * kw["out_dtype"].itemsize for x, kw in calls)
    b_ms, b_by = bound_ms(moved, sum(11 * x.shape[0] * 256 * 341 * x.shape[3] for x, _ in calls))
    print(f"B2 on a recollect batch (T={RECOLLECT_T} x N={RECOLLECT_N} = {frames} frames, rgb u8 + depth f32, 480x640 -> "
          f"256x341), device time by graph replay: kernel {ms:.4f} ms, F.interpolate on f32 {lib_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}, {moved / 1e6:.0f} MB); plain {plain_ms:.4f} ms (CUDA events); max_abs_err {err:.3e}")
    del rgb, depth, floats
    fields["resize"] = {"recollect_batch_frames": frames, "recollect_batch_ms": ms, "recollect_batch_bound_ms": b_ms,
                        "recollect_batch_library_ms": lib_ms, "recollect_batch_plain_ms": plain_ms,
                        "max_abs_err_recollect": err}
    return fields


# ---------------------------------------------------------------------------
# the recollect trainer: RxR CMA over live re-simulated frames, through the
# entry point, then eval of its checkpoint; Seq2Seq the same way
# ---------------------------------------------------------------------------

RECOLLECT_EPISODES, RECOLLECT_EPOCHS = 6, 2


def _recollect_opts(tmp, epochs, effective_batch_size):
    """Options of a recollect run at full width over RECOLLECT_N forked
    workers: synthetic scenes at 480x640, RECOLLECT_EPISODES episodes of at
    most 40 steps (GT actions from the shortest-path oracle: the repository
    has no GT file), `preload_size` at the batch size."""
    common = [
        "TASK_CONFIG.DATASET.TYPE", "Synthetic-VLN-v0",
        "TASK_CONFIG.DATASET.NUM_SCENES", RECOLLECT_N,  # one scene per worker
        "TASK_CONFIG.DATASET.NUM_EPISODES", RECOLLECT_EPISODES,
        "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", 40,
        "NUM_ENVIRONMENTS", RECOLLECT_N,
        "TENSORBOARD_DIR", "", "VERBOSE", False, "LOG_FILE", os.path.join(tmp, "run.log"),
        "CHECKPOINT_FOLDER", os.path.join(tmp, "checkpoints"),
    ]
    train = common + [
        "IL.load_from_ckpt", False, "IL.epochs", epochs, "IL.batch_size", RECOLLECT_N,
        "IL.RECOLLECT_TRAINER.preload_size", RECOLLECT_N,
        "IL.RECOLLECT_TRAINER.effective_batch_size", effective_batch_size,
        "IL.RECOLLECT_TRAINER.trajectories_file", os.path.join(tmp, "trajectories.json.gz"),
        "IL.RECOLLECT_TRAINER.gt_file", os.path.join(tmp, "no_gt_{split}_{role}.json.gz"),
    ]
    return common, train


def _run_recollect(exp, train_opts, per_step):
    """`run_exp(exp, "train")` with the launch counters set to 0 just before
    and read just after; each kernel must have risen by `per_step` (B1, its
    backward, its weight gradient, B2) per train step, and every backward
    must have taken the cluster route. Returns (trainer, launches, wall)."""
    from vlnce_torch.run import run_exp
    from vlnce_torch.trainers.recollect_trainer import RecollectTrainer

    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    RecollectTrainer.time_train_steps = True  # the split of every train step by CUDA events
    try:
        trainer = run_exp(exp, "train", train_opts)
    finally:
        RecollectTrainer.time_train_steps = False
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    steps = len(trainer.loss_history)
    print(f"{exp}: train launches over {steps} train steps: {json.dumps(launches)}")
    assert steps > 0 and list(launches.values()) == [n * steps for n in per_step], (launches, steps)
    assert _cluster_launches() == launches["gru_sequence_backward"], "B1's backward left the cluster route"
    losses = np.array([h[1:] for h in trainer.loss_history])
    assert np.isfinite(losses).all(), "non-finite training loss"

    clock, first = trainer.step_clock.totals(), dict(trainer.step_clock.first)
    order = ("upload", "forward", "backward", "optimizer")
    assert sorted(clock) == sorted(order) and trainer.step_clock.steps == steps
    warm = {k: (clock[k] - first[k]) / max(steps - 1, 1) for k in order}  # the first step warms the libraries up
    sim = trainer.resimulation
    print(f"{exp}: run_exp took {wall:.1f} s; train step by CUDA events, mean of the {steps - 1} steps after the first: "
          f"{sum(warm.values()):.2f} ms = " + ", ".join(f"{k} {warm[k]:.2f}" for k in order) + " ms; the first step "
          + ", ".join(f"{k} {first[k]:.1f}" for k in order) + f" ms; T values seen {json.dumps(trainer.train_lengths, sort_keys=True)}"
          f" at N={RECOLLECT_N}; losses (loss, action, aux) first {losses[0].round(4).tolist()}, last {losses[-1].round(4).tolist()}; "
          f"re-simulation {sim['env_steps']} env steps, {sim['episodes']} episodes in {sim['seconds']:.2f} s on the prefetch thread, "
          f"{sim['env_steps'] / sim['seconds']:.1f} env-steps/s; peak card memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return trainer, launches, wall


def phase_recollect(dev):
    """`run_exp(rxr_cma_en.yaml, "train")` at full width: the recollect
    trainer over RECOLLECT_N forked workers, IL.batch_size 3, 2 epochs,
    effective_batch_size 6 so that two batches accumulate per Adam step. Per
    train step B2 twice (RGB and depth of every collated frame), B1 twice
    forward (storing the gates), twice backward on the cluster route, twice
    the weight gradient. Frozen weights stay bit-equal; `ckpt.1.ckpt` is
    written, then evaluated over the forked pool."""
    from vlnce_torch.config import get_config
    from vlnce_torch.envs.spaces import action_space_from_config, observation_space_from_config
    from vlnce_torch.models.cma_policy import CMAPolicy
    from vlnce_torch.ops.obs_transforms import apply_obs_transforms_obs_space, get_active_obs_transforms
    from vlnce_torch.parallel.optim import trainable_mask
    from vlnce_torch.utils.checkpoints import load_checkpoint

    with tempfile.TemporaryDirectory(prefix="vlnce_torch_smoke_") as tmp:
        common, train_opts = _recollect_opts(tmp, RECOLLECT_EPOCHS, 2 * RECOLLECT_N)
        # the seeded weights the trainer starts from: the same config gives the same draw
        cfg = get_config(EXP, train_opts)
        space = apply_obs_transforms_obs_space(observation_space_from_config(cfg.TASK_CONFIG), get_active_obs_transforms(cfg))
        start = CMAPolicy.from_config(cfg, space, action_space_from_config(cfg.TASK_CONFIG))
        mask = trainable_mask(start, cfg.MODEL)
        start = {k: v.cpu() for k, v in start.state_dict().items()}

        trainer, launches, _ = _run_recollect(EXP, train_opts, per_step=(2, 2, 2, 2))
        steps = len(trainer.loss_history)
        assert steps == RECOLLECT_EPOCHS * math.ceil(RECOLLECT_EPISODES / RECOLLECT_N), steps
        after = trainer.policy.state_dict()
        frozen = {k for k, trains in mask.items() if not trains}
        moved = {k for k in mask if not torch.equal(after[k].cpu(), start[k])}
        assert moved == set(mask) - frozen, (sorted(moved & frozen)[:3], sorted(set(mask) - frozen - moved)[:3])
        assert all(torch.equal(after[k].cpu(), start[k]) for k in start if k not in mask), "a buffer moved"
        print(f"recollect weights: {len(frozen)} frozen tensors and every buffer bit-equal to the seeded start, "
              f"{len(moved)} trainable tensors changed; {steps // 2} Adam steps over {steps} batches")

        last = os.path.join(tmp, "checkpoints", f"ckpt.{RECOLLECT_EPOCHS - 1}.ckpt")
        saved = load_checkpoint(last)
        assert saved["extra_state"] == {"epoch": RECOLLECT_EPOCHS - 1, "step_id": steps}, saved["extra_state"]
        assert len(saved["optim_state"]["state"]) == len(set(mask) - frozen)
        evaluator, eval_launches, eval_wall = _run_loop("eval", common + [
            "TASK_CONFIG.DATASET.NUM_EPISODES", 2 * RECOLLECT_N, "EVAL.EPISODE_COUNT", 2 * RECOLLECT_N,
            "EVAL.USE_CKPT_CONFIG", False, "EVAL_CKPT_PATH_DIR", last, "RESULTS_DIR", os.path.join(tmp, "evals"),
        ])
        head = "action_distribution.linear.weight"
        assert torch.equal(evaluator.policy.state_dict()[head], after[head]), "eval did not load the trained weights"
        with open(os.path.join(tmp, "evals", f"stats_ckpt_0_{cfg.EVAL.SPLIT}.json")) as f:
            stats = json.load(f)
        assert sorted(stats) == sorted(RXR_MEASURES) and all(math.isfinite(v) for v in stats.values()), stats
        print(f"eval of {os.path.basename(last)} ({os.path.getsize(last) / 1e6:.1f} MB): "
              f"{len(evaluator._last_eval_episode_stats)} episodes in {eval_wall:.1f} s, stats "
              f"{json.dumps({k: round(v, 4) for k, v in stats.items()})}")
    return launches, eval_launches


def build_recollect_step(dev, dtype: str, T: int = RECOLLECT_T, N: int = RECOLLECT_N, seed: int = 21,
                         apply: bool = True):
    """The RxR CMA config at full width on `dev` in compute dtype `dtype`, its
    policy with seeded weights, masked Adam, and one recollect train step
    on a seeded [T, N] batch already on the card as the trainer uploads it:
    raw frames (u8 RGB, f32 depth at 480x640, BERT-feature instructions of
    the env's format), time-major [T*N, ...], with prev actions, masks,
    oracle actions and inflection weights [T, N]. The step runs the obs
    transforms (B2 twice) and the accumulation step at scale 2, stepping
    Adam with `apply`; it returns (loss, action_loss, aux_loss). Returns
    (cfg, policy, optimizer, step, batch)."""
    from vlnce_torch.envs.batch import stack_obs
    from vlnce_torch.ops.obs_transforms import apply_obs_transforms_batch, get_active_obs_transforms
    from vlnce_torch.parallel.il_step import build_il_accum_step
    from vlnce_torch.parallel.optim import masked_adam

    cfg, policy, _ = build_act_step(dev, dtype)
    transforms = get_active_obs_transforms(cfg)
    optimizer = masked_adam(cfg.IL.lr, policy, cfg.MODEL)
    rng = np.random.RandomState(seed)
    raw = stack_obs([o for step in episode_observations(cfg.TASK_CONFIG, seed=seed + 1, steps=1) for o in step][:N])
    frames = {k: np.concatenate([v] * T) for k, v in raw.items()}  # time-major [T*N]: each env's instruction over T
    frames["rgb"] = rng.randint(0, 256, frames["rgb"].shape, dtype=np.uint8)
    frames["depth"] = rng.rand(*frames["depth"].shape).astype(np.float32)
    frames = {k: torch.from_numpy(v).to(dev) for k, v in frames.items()}
    masks = torch.ones(T, N, device=dev)
    masks[0] = 0.0
    weights = torch.from_numpy(np.where(rng.rand(T, N) < 0.3, 1.9, 1.0).astype(np.float32)).to(dev)
    weights[T - 5:, 0] = 0.0  # one episode shorter than the batch
    prev, corrected = (torch.from_numpy(rng.randint(0, 6, (T, N))).to(dev) for _ in range(2))
    accum_step = build_il_accum_step(policy, optimizer, apply)

    def step():
        obs = apply_obs_transforms_batch(frames, transforms)
        obs = {k: v.reshape((T, N) + tuple(v.shape[1:])) for k, v in obs.items()}
        return accum_step(2.0, obs, prev, masks, corrected, weights)

    return cfg, policy, optimizer, step, (frames, prev, masks, corrected, weights)


def phase_recollect_against_plain(dev, T: int = 32, N: int = RECOLLECT_N):
    """One seeded f32 accumulation step of RxR CMA at [T, N] from raw frames
    (TF32 off): through the kernels (B2 twice, B1 forward, backward and
    weight gradient twice), through the plain versions under ordinary
    autograd, and with only B1 plain (B2 the kernel). The losses of all
    three must agree within 1e-5 relative. B2's u8 RGB output may round a .5
    tie the other way from its plain version (its stated tolerance: 1 on at
    most 0.01% of values, held here on these frames), and every gradient of
    the step follows those pixels; so the gradients are held at the
    tolerance of phase_train_step_against_plain (1e-5 of their own scale
    plus 1e-8 of the largest) against the B1-plain run, which reads the same
    frames, and their distance from the all-plain run is printed beside the
    B1-plain run's own."""
    from vlnce_torch.ops.preprocess import fused_resize_normalize, fused_resize_normalize_plain

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _, policy, optimizer, step, (frames, *_) = build_recollect_step(dev, "float32", T, N, apply=False)

    def losses_and_gradients():
        optimizer.zero_grad(set_to_none=True)
        return torch.stack(step()), {k: p.grad.clone() for k, p in policy.named_parameters() if p.requires_grad}

    _reset_launches()
    k_losses, k_grads = losses_and_gradients()
    launches = _read_launches()
    assert launches == {"gru_sequence": 2, "gru_sequence_backward": 2, "gru_weight_gradient": 2,
                        "fused_resize_normalize": 2}, launches
    assert _cluster_launches() == 2, "B1's backward did not take the cluster route"
    with plain_versions():
        p_losses, p_grads = losses_and_gradients()
    assert _read_launches() == launches, "the plain run launched a kernel"
    with plain_versions(resize=False):
        b_losses, b_grads = losses_and_gradients()
    assert _read_launches()["gru_sequence"] == 2, "the B1-plain run launched B1"
    assert sorted(k_grads) == sorted(p_grads) == sorted(b_grads) and len(p_grads) > 0
    rgb = frames["rgb"].reshape(-1, 480, 640, 3)
    flips = int((fused_resize_normalize(rgb, (256, 341), out_dtype=torch.uint8, scale_values=False).int()
                 - fused_resize_normalize_plain(rgb, (256, 341), out_dtype=torch.uint8, scale_values=False).int()).abs().sum())
    err_l = max(float(((k_losses - ref).abs() / ref.abs().clamp(min=1e-30)).max()) for ref in (p_losses, b_losses))
    largest = max(float(ref.abs().max()) for ref in p_grads.values())
    values = rgb.shape[0] * 256 * 341 * 3
    ratios = {}
    for name, ref in p_grads.items():
        tol = 1e-5 * float(b_grads[name].abs().max()) + 1e-8 * largest
        against_b1 = float((k_grads[name] - b_grads[name]).abs().max())
        ratios[name] = (against_b1 / tol, against_b1, float((k_grads[name] - ref).abs().max()),
                        float((b_grads[name] - ref).abs().max()), float(ref.abs().max()))
    worst = sorted(ratios.items(), key=lambda kv: -kv[1][0])[:3]
    print(f"f32 recollect accumulation step at T={T} N={N} from raw 480x640 frames (TF32 off): losses through the kernels "
          f"{k_losses.tolist()}, plain {p_losses.tolist()}, B1 plain {b_losses.tolist()} (max relative diff {err_l:.3e}, "
          f"held at 1e-5); B2's u8 RGB kernel vs plain: {flips} of {values} values differ by 1 (held at 0.01%); "
          f"{len(p_grads)} gradients, the largest max |plain| {largest:.3e}; nearest to the tolerance against the B1-plain "
          f"run (1e-5 x max |B1 plain| + 1e-8 x that): "
          + "; ".join(f"{name} at {r:.3f} of it (|diff| {a:.3e}; against the all-plain run {c:.3e}, the B1-plain run's "
                      f"own {d:.3e}, max |plain| {e:.3e})" for name, (r, a, c, d, e) in worst))
    assert all(bool(torch.isfinite(g).all()) for g in k_grads.values()), "non-finite gradient"
    assert flips <= 1e-4 * values, "B2 differs from its plain version beyond its tolerance"
    assert err_l <= 1e-5 and worst[0][1][0] <= 1.0, "the f32 recollect step through the kernels disagrees with the plain versions"
    torch.backends.cudnn.allow_tf32 = True  # the default of the later phases


SEQ2SEQ_EXP = "vlnce_torch/config/experiments/rxr_baselines/rxr_seq2seq.yaml"


def phase_seq2seq(dev):
    """`run_exp(rxr_seq2seq.yaml, "train")` for one short epoch at full
    width (one GRU: per train step one B1 forward, backward and weight
    gradient, and B2 twice), then eval of `ckpt.0.ckpt` (per act step one B1
    launch, two of B2)."""
    with tempfile.TemporaryDirectory(prefix="vlnce_torch_smoke_") as tmp:
        common, train_opts = _recollect_opts(tmp, 1, -1)
        trainer, launches, _ = _run_recollect(SEQ2SEQ_EXP, train_opts, per_step=(1, 1, 1, 2))
        assert type(trainer.policy).__name__ == "Seq2SeqPolicy"
        last = os.path.join(tmp, "checkpoints", "ckpt.0.ckpt")
        evaluator, eval_launches, eval_wall = _run_loop("eval", common + [
            "TASK_CONFIG.DATASET.NUM_EPISODES", RECOLLECT_N, "EVAL.EPISODE_COUNT", RECOLLECT_N,
            "EVAL.USE_CKPT_CONFIG", False, "EVAL_CKPT_PATH_DIR", last, "RESULTS_DIR", os.path.join(tmp, "evals"),
        ], exp=SEQ2SEQ_EXP, per_act_step=(1, 0, 0, 2))
        head = "action_distribution.linear.weight"
        assert torch.equal(evaluator.policy.state_dict()[head], trainer.policy.state_dict()[head])
        with open(os.path.join(tmp, "evals", "stats_ckpt_0_val_unseen.json")) as f:
            stats = json.load(f)
        assert sorted(stats) == sorted(RXR_MEASURES) and all(math.isfinite(v) for v in stats.values()), stats
        print(f"eval of the Seq2Seq {os.path.basename(last)}: {len(evaluator._last_eval_episode_stats)} episodes in "
              f"{eval_wall:.1f} s, stats {json.dumps({k: round(v, 4) for k, v in stats.items()})}")
    return launches, eval_launches


# ---------------------------------------------------------------------------
# DD-PPO waypoint RL: B1 at H=256 in two GRUs, the ddppo-waypoint trainer
# through the entry point, one PPO minibatch step against the plain versions
# ---------------------------------------------------------------------------

WP_EXP = "vlnce_torch/config/experiments/r2r_waypoint/1-wpn-cc.yaml"
WP_H = 256  # STATE_ENCODER.hidden_size of every r2r_waypoint/*.yaml
WP_N = 4  # NUM_ENVIRONMENTS of the YAMLs
WP_T = 16  # RL.PPO.num_steps: the T of a PPO minibatch
WP_UPDATES = 2


def device_ms(fn, steps):
    """Device busy ms per call of fn (the sum of its kernels' times under
    torch.profiler, over `steps` calls) and that time by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    kernels = collections.Counter()
    for ev in prof.key_averages():
        if ev.self_device_time_total > 0:
            kernels[ev.key] += ev.self_device_time_total / 1e3 / steps
    return sum(kernels.values()), kernels


def phase_waypoint_shapes(dev):
    """B1 at the waypoint configs' H=256: the cluster granted at B in {1, 2,
    4}; the forward at T=1, B in {2, 4} with h0 either slice of a [B, 2, H]
    state (the two GRUs' states), the forward storing the gates and the
    cluster-route backward and weight gradient at T=16, B in {1, 2, 4}, each
    against its plain version; then device times at the act step's shape
    (T=1, B=4) and the PPO minibatch's (T=16, B=1) beside the bound, the
    plain loop and cuDNN's GRU. Returns fields for the kernels line of B1,
    its backward and its weight gradient."""
    from vlnce_torch.ops.rnn import (_forward_launch, backward_cluster_plan, gru_sequence, gru_sequence_backward,
                                     gru_sequence_backward_plain, gru_sequence_plain, gru_weight_gradient,
                                     gru_weight_gradient_plain)

    H = WP_H
    g = torch.Generator(device="cpu").manual_seed(9)
    clusters = {}
    for Bn in (1, 2, 4):
        clusters[Bn], active = backward_cluster_plan(dev.index, Bn, H)
        print(f"B1 backward cluster route at B={Bn} H={H}: cluster of {clusters[Bn]} blocks granted, "
              f"cudaOccupancyMaxActiveClusters {active}")
        assert clusters[Bn] > 0 and active >= 1, f"the cluster route does not take B={Bn} at H={H}"

    def inputs(T, Bn):
        xi = torch.randn(T, Bn, 3 * H, generator=g)
        masks = torch.ones(T, Bn, 1)
        masks[T // 2, ::2] = 0.0
        states = torch.randn(Bn, 2, H, generator=g)  # the policy's [B, 2, H] state: one slice per GRU
        w_hh = torch.randn(3 * H, H, generator=g) * H**-0.5
        b_hh = torch.randn(3 * H, generator=g) * 0.1
        d_out = torch.randn(T, Bn, H, generator=g)
        return tuple(t.to(dev) for t in (d_out, xi, masks, states, w_hh, b_hh))

    worst = {"forward": 0.0, "gates": 0.0, "backward": 0.0}
    for Bn in (2, 4):
        _, xi, masks, states, w_hh, b_hh = inputs(1, Bn)
        for layer in (0, 1):
            h0 = states[:, layer]  # rows 2H apart; the second GRU's starts H floats in
            err = float((gru_sequence(xi, masks, h0, w_hh, b_hh) - gru_sequence_plain(xi, masks, h0, w_hh, b_hh)).abs().max())
            print(f"B1 T=1 B={Bn} H={H}, h0 = states[:, {layer}] of [B, 2, H]: max_abs_err {err:.3e} (atol 1e-5)")
            assert err <= 1e-5, (Bn, layer, err)
            worst["forward"] = max(worst["forward"], err)
    for Bn in (1, 2, 4):
        d_out, xi, masks, states, w_hh, b_hh = inputs(WP_T, Bn)
        h0 = states[:, 1]
        out, gates = _forward_launch(xi, masks, h0, w_hh, b_hh, reserve=True)
        ref_out, ref_gates = gru_sequence_plain(xi, masks, h0, w_hh, b_hh, return_gates=True)
        before = gru_sequence_backward.cluster_launches
        got = gru_sequence_backward(d_out, xi, masks, h0, w_hh, b_hh, ref_out, gates=ref_gates)
        ref = gru_sequence_backward_plain(d_out, xi, masks, h0, w_hh, b_hh, ref_out, gates=ref_gates)
        torch.cuda.synchronize()
        assert gru_sequence_backward.cluster_launches == before + 1, "the backward left the cluster route"
        errs = {"forward": float((out - ref_out).abs().max()), "gates": float((gates - ref_gates).abs().max())}
        by_output = {n: float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
                     for n, a, b in zip(("d_xi", "d_h0", "d_w_hh", "d_b_hh"), got, ref)}
        errs["backward"] = max(by_output.values())
        print(f"B1 at T={WP_T} B={Bn} H={H}, h0 = states[:, 1]: forward storing the gates max_abs_err out "
              f"{errs['forward']:.3e} gates {errs['gates']:.3e} (atol 1e-4); cluster-route backward and weight gradient, "
              f"max err relative to max(1, scale): " + ", ".join(f"{n} {e:.3e}" for n, e in by_output.items()) + " (1e-5)")
        assert errs["forward"] <= 1e-4 and errs["gates"] <= 1e-4 and errs["backward"] <= 1e-5, (Bn, errs)
        worst = {k: max(worst[k], errs[k]) for k in worst}

    fields = {"forward": {"max_abs_err_waypoint": max(worst["forward"], worst["gates"])},
              "backward": {"max_err_waypoint": worst["backward"], "cluster_waypoint": clusters},
              "weight": {}}
    # the act step's launch (T=1, B=N) and the PPO minibatch's (T=16, B=1)
    _, xi, masks, states, w_hh, b_hh = inputs(1, WP_N)
    h0 = states[:, 0]
    act_ms = graph_ms(lambda: gru_sequence(xi, masks, h0, w_hh, b_hh), reps=50)
    act_plain_ms = graph_ms(lambda: gru_sequence_plain(xi, masks, h0, w_hh, b_hh), reps=50)
    act_b_ms, act_b_by = _gru_bound(1, WP_N, H, reserve=False)
    x1 = torch.randn(WP_N, H, device=dev)
    w_ih = torch.randn(3 * H, H, device=dev) * H**-0.5
    act_lib_ms = graph_ms(lambda: torch.gru_cell(x1, h0 * masks[0], w_ih, w_hh, None, b_hh), reps=50)
    print(f"B1 act step launch at T=1 B={WP_N} H={H}, device time by graph replay: kernel {act_ms:.4f} ms, plain "
          f"{act_plain_ms:.4f} ms, torch.gru_cell {act_lib_ms:.4f} ms, bound {act_b_ms:.4f} ms ({act_b_by})")
    fields["forward"].update({"wp_T1_B4_ms": act_ms, "wp_T1_B4_plain_ms": act_plain_ms, "wp_T1_B4_bound_ms": act_b_ms,
                              "wp_T1_B4_library_ms": act_lib_ms})

    d_out, xi, masks, states, w_hh, b_hh = inputs(WP_T, 1)
    h0 = states[:, 1]
    out, gates = _forward_launch(xi, masks, h0, w_hh, b_hh, reserve=True)
    fwd_ms = graph_ms(lambda: _forward_launch(xi, masks, h0, w_hh, b_hh, reserve=True), reps=10)
    fwd_plain_ms = cuda_ms(lambda: gru_sequence_plain(xi, masks, h0, w_hh, b_hh), iters=5, warmup=1)
    bwd_ms = graph_ms(lambda: gru_sequence_backward(d_out, xi, masks, h0, w_hh, b_hh, out, gates=gates), reps=10)
    bwd_plain_ms = cuda_ms(lambda: gru_sequence_backward_plain(d_out, xi, masks, h0, w_hh, b_hh, out, gates=gates), iters=5, warmup=1)
    d_gh = torch.randn(WP_T, 1, 3 * H, device=dev)
    w_ms = graph_ms(lambda: gru_weight_gradient(d_gh, masks, h0, out), reps=10)
    w_plain_ms = graph_ms(lambda: gru_weight_gradient_plain(d_gh, masks, h0, out), reps=10)
    got = gru_weight_gradient(d_gh, masks, h0, out)
    ref = gru_weight_gradient_plain(d_gh, masks, h0, out)
    w_err = max(float((a - b).abs().max()) / max(1.0, float(b.abs().max())) for a, b in zip(got, ref))
    assert w_err <= 1e-5, w_err
    # yardsticks only, the port never calls them: cuDNN's GRU over [T, 1, H]
    # (no resets), forward, and autograd's backward through it (CUDA events)
    gru = torch.nn.GRU(H, H).to(dev)
    x = torch.randn(WP_T, 1, H, device=dev, requires_grad=True)
    h0c = h0[None].contiguous()
    with torch.no_grad():
        lib_fwd_ms = cuda_ms(lambda: gru(x, h0c), iters=20)
    y, _ = gru(x, h0c)
    lib_bwd_ms = cuda_ms(lambda: torch.autograd.grad(y, [x] + list(gru.parameters()), d_out, retain_graph=True), iters=20)
    fb_ms, fb_by = _gru_bound(WP_T, 1, H, reserve=True)
    rows, product = WP_T, 2 * WP_T * 3 * H * H
    bb_ms, bb_by = bound_ms(nbytes(d_out, gates, masks, h0, out, w_hh) + nbytes(xi, h0, w_hh, b_hh), 2 * product + rows * 23 * H)
    wb_ms, wb_by = bound_ms(nbytes(d_gh, masks, h0, out, w_hh, b_hh), product + rows * 3 * H)
    print(f"B1 at T={WP_T} B=1 H={H} (a PPO minibatch), device time by graph replay: forward storing the gates {fwd_ms:.4f} ms "
          f"(bound {fb_ms:.4f} {fb_by}; plain loop {fwd_plain_ms:.4f} by CUDA events; cuDNN nn.GRU forward, no resets, "
          f"{lib_fwd_ms:.4f} by CUDA events); backward wrapper (cluster route + weight gradient) {bwd_ms:.4f} ms (its bound "
          f"given the gates {bb_ms:.4f} {bb_by}; plain {bwd_plain_ms:.4f} by CUDA events; autograd through cuDNN nn.GRU "
          f"{lib_bwd_ms:.4f} by CUDA events); weight gradient {w_ms:.4f} ms (bound {wb_ms:.4f} {wb_by}; its plain torch ops "
          f"{w_plain_ms:.4f}); weight gradient max err relative to max(1, scale) {w_err:.3e}")
    fields["forward"].update({"wp_T16_B1_ms": fwd_ms, "wp_T16_B1_bound_ms": fb_ms, "wp_T16_B1_plain_ms": fwd_plain_ms,
                              "wp_T16_B1_library_ms": lib_fwd_ms})
    fields["backward"].update({"wp_T16_B1_wrapper_ms": bwd_ms, "wp_T16_B1_bound_ms": bb_ms, "wp_T16_B1_plain_ms": bwd_plain_ms,
                               "wp_T16_B1_library_ms": lib_bwd_ms})
    fields["weight"].update({"wp_T16_B1_ms": w_ms, "wp_T16_B1_bound_ms": wb_ms, "wp_T16_B1_plain_ms": w_plain_ms,
                             "max_err_waypoint": w_err})
    return fields


def waypoint_space(cfg):
    """The observation space the ddppo-waypoint trainer hands the policy for
    `cfg`: the 12 stacked pano frames of each sensor, the history frames,
    the instruction tokens and the angle features."""
    from vlnce_torch.envs import spaces

    sim, P = cfg.TASK_CONFIG.SIMULATOR, int(cfg.TASK_CONFIG.TASK.PANO_ROTATIONS)
    rgb = (sim.RGB_SENSOR.HEIGHT, sim.RGB_SENSOR.WIDTH, 3)
    depth = (sim.DEPTH_SENSOR.HEIGHT, sim.DEPTH_SENSOR.WIDTH, 1)
    return spaces.Dict({
        "rgb": spaces.Box(0, 255, (P,) + rgb, np.uint8), "depth": spaces.Box(0.0, 1.0, (P,) + depth, np.float32),
        "rgb_history": spaces.Box(0, 255, rgb, np.uint8), "depth_history": spaces.Box(0.0, 1.0, depth, np.float32),
        "instruction": spaces.Box(0, 2**31 - 1, (200,), np.int32), "angle_features": spaces.Box(-1.0, 1.0, (P, 4), np.float32),
    })


def build_waypoint_ppo_step(dev, dtype: str, T: int = WP_T, n: int = 1, seed: int = 31):
    """The 1-wpn-cc.yaml config at full width on `dev` in compute dtype
    `dtype`, the WaypointPolicy with seeded weights, WDDPPO (masked Adam)
    and one seeded host minibatch [T, n, ...] as the rollout storage yields
    it: random frames, instructions and prev actions, stored actions drawn
    in range, old log-probs near the policy's own (so that the surrogate is
    not clipped everywhere). Returns (cfg, policy, agent, sample)."""
    from vlnce_torch.config import get_config
    from vlnce_torch.models.waypoint_policy import WaypointPolicy
    from vlnce_torch.rl.ppo import WDDPPO

    cfg = get_config(WP_EXP, ["CUDA.DEVICE", str(dev), "CUDA.PRECISION.compute_dtype", dtype])
    space = waypoint_space(cfg)
    policy = WaypointPolicy.from_config(cfg, space)
    ppo = cfg.RL.PPO
    agent = WDDPPO(policy, ppo, ppo.offset_regularize_coef, ppo.pano_entropy_coef, ppo.offset_entropy_coef,
                   ppo.distance_entropy_coef, num_updates=int(cfg.RL.NUM_UPDATES))
    rng = np.random.RandomState(seed)
    obs = {}
    for k, sp in space.spaces.items():
        shape = (T, n) + tuple(sp.shape)
        obs[k] = (rng.randint(0, 256, shape).astype(np.uint8) if sp.dtype == np.uint8 else rng.rand(*shape).astype(np.float32))
    tokens = np.zeros((n, 200), np.int32)
    for i in range(n):
        length = rng.randint(20, 80)
        tokens[i, :length] = rng.randint(2, 2000, length)
    obs["instruction"] = np.broadcast_to(tokens, (T, n, 200)).copy()
    obs["angle_features"] = np.broadcast_to(np.stack([[np.sin(a), np.cos(a), 0.0, 1.0] for a in np.arange(12) * np.pi / 6]),
                                            (T, n, 12, 4)).astype(np.float32)
    wc, lim = cfg.MODEL.WAYPOINT, np.pi / 12

    def draws():
        return {"pano": rng.randint(0, 13, (T, n, 1)).astype(np.float32),
                "offset": rng.uniform(-lim, lim, (T, n, 1)).astype(np.float32),
                "distance": rng.uniform(wc.min_distance_prediction, wc.max_distance_prediction, (T, n, 1)).astype(np.float32)}

    actions, prev = draws(), draws()
    masks = np.ones((T, n, 1), np.float32)
    masks[0] = 0.0
    masks[T // 2, ::2] = 0.0
    hidden0 = (rng.randn(n, 2, WP_H) * 0.5).astype(np.float32)
    value_preds = rng.randn(T, n, 1).astype(np.float32)
    returns = (value_preds + rng.randn(T, n, 1) * 0.5).astype(np.float32)
    adv = rng.randn(T, n, 1).astype(np.float32)
    sample = [obs, hidden0, actions, prev, value_preds, returns, masks, np.zeros((T, n, 1), np.float32), adv]
    with torch.no_grad():  # the stored log-probs: the policy's own, perturbed
        obs_d, h_d, act_d, prev_d, _, _, masks_d, _, _ = agent.upload(sample)
        flat = lambda v: v.reshape((T * n,) + tuple(v.shape[2:]))  # noqa: E731
        _, logp, _, _ = policy.evaluate_actions({k: flat(v) for k, v in obs_d.items()}, h_d, {k: flat(v) for k, v in prev_d.items()},
                                                flat(masks_d), {k: flat(v) for k, v in act_d.items()}, seq_len=T)
    sample[7] = (logp.float().cpu().numpy().reshape(T, n, 1) + rng.randn(T, n, 1) * 0.1).astype(np.float32)
    return cfg, policy, agent, sample


def phase_waypoint(dev):
    """`run_exp(1-wpn-cc.yaml, "train")` at full width in bf16 over WP_N
    forked workers (synthetic scenes, 12 pano RGB 224² and depth 256² frames
    a step, episodes of at most 40 waypoints): WP_UPDATES updates of
    num_steps 16, ppo_epoch 2, num_mini_batch 4, a checkpoint each; then
    `run_exp(..., "eval")` of the last checkpoint over 8 episodes. B1 must be
    launched exactly 2 times per act step, 2 per bootstrap value, and per PPO
    minibatch 2 forward, 2 backward on the cluster route and 2 weight
    gradients; B2 never. Frozen weights bit-equal, the others moved; then the
    rollout's env-steps/s, the act step's ms, the PPO minibatch step's split
    by CUDA events, and the idle share of one minibatch step alone."""
    from vlnce_torch.config import get_config
    from vlnce_torch.models.waypoint_policy import WaypointPolicy
    from vlnce_torch.parallel.optim import trainable_mask
    from vlnce_torch.run import run_exp
    from vlnce_torch.trainers.ddppo_waypoint_trainer import DDPPOWaypointTrainer
    from vlnce_torch.utils.checkpoints import load_checkpoint

    with tempfile.TemporaryDirectory(prefix="vlnce_torch_smoke_") as tmp:
        ckpts = os.path.join(tmp, "checkpoints")
        common = [
            "TASK_CONFIG.DATASET.TYPE", "Synthetic-VLN-v0",
            "TASK_CONFIG.DATASET.NUM_SCENES", WP_N,  # one scene per worker
            "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", 40,
            "NUM_ENVIRONMENTS", WP_N,
            "TENSORBOARD_DIR", "", "VERBOSE", False, "LOG_FILE", os.path.join(tmp, "run.log"),
            "CHECKPOINT_FOLDER", ckpts,
        ]
        train_opts = common + ["RL.NUM_UPDATES", WP_UPDATES, "RL.CHECKPOINT_INTERVAL", 1, "RL.LOG_INTERVAL", 1]
        # the seeded weights the trainer starts from: the same config gives the same draw
        cfg = get_config(WP_EXP, train_opts)
        start = {k: v.cpu() for k, v in WaypointPolicy.from_config(cfg, waypoint_space(cfg)).state_dict().items()}

        torch.cuda.reset_peak_memory_stats()
        DDPPOWaypointTrainer.time_train_steps = True
        _reset_launches()
        t0 = time.perf_counter()
        try:
            trainer = run_exp(WP_EXP, "train", train_opts)
        finally:
            DDPPOWaypointTrainer.time_train_steps = False
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_launches()
        ppo = trainer.config.RL.PPO
        minibatches = WP_UPDATES * ppo.ppo_epoch * ppo.num_mini_batch
        act_steps = WP_UPDATES * ppo.num_steps
        print(f"waypoint training: {WP_EXP} at full width ({trainer.policy.num_params() / 1e6:.1f}M weights), "
              f"{WP_UPDATES} updates of {ppo.num_steps} steps at N={WP_N}, run_exp took {wall:.1f} s; launches "
              f"{json.dumps(launches)} over {act_steps} act steps, {WP_UPDATES} bootstrap values, {minibatches} PPO minibatches")
        assert trainer.rollout_stats["act_steps"] == act_steps, trainer.rollout_stats
        assert launches == {"gru_sequence": 2 * act_steps + 2 * WP_UPDATES + 2 * minibatches,
                            "gru_sequence_backward": 2 * minibatches, "gru_weight_gradient": 2 * minibatches,
                            "fused_resize_normalize": 0}, launches
        assert _cluster_launches() == 2 * minibatches, "B1's backward left the cluster route"

        history = trainer.update_history
        assert len(history) == WP_UPDATES and all(math.isfinite(v) for h in history for v in h.values()), history
        print("PPO stats per update: " + "; ".join(json.dumps({k: round(v, 4) for k, v in h.items()}) for h in history))
        mask = trainable_mask(trainer.policy, trainer.config.MODEL)
        after = {k: v.detach().cpu() for k, v in trainer.policy.state_dict().items()}
        frozen = {k for k, trains in mask.items() if not trains}
        moved = {k for k in mask if not torch.equal(after[k], start[k])}
        assert not moved & frozen and all(torch.equal(after[k], start[k]) for k in after if k not in mask), "a frozen tensor moved"
        assert moved == set(mask) - frozen, sorted(set(mask) - frozen - moved)
        named = dict(trainer.policy.named_parameters())
        with_state = {k for k, p in named.items() if p in trainer.optimizer.state}
        assert with_state == set(mask) - frozen
        print(f"weights: {len(frozen)} frozen tensors and every buffer bit-equal to the seeded start, {len(moved)} trainable "
              f"tensors changed, Adam state for {len(with_state)}")

        r = trainer.rollout_stats
        clock, first = trainer.step_clock.totals(), dict(trainer.step_clock.first)
        order = ("upload", "forward", "backward", "optimizer")
        assert sorted(clock) == sorted(order) and trainer.step_clock.steps == minibatches
        warm = {k: (clock[k] - first[k]) / (minibatches - 1) for k in order}
        warm_act_ms = 1e3 * (r["act_time"] - r["first_act_time"]) / (r["act_steps"] - 1)
        print(f"rollout: {r['env_steps']} env steps in {r['rollout_time']:.2f} s, {r['env_steps'] / r['rollout_time']:.1f} env-steps/s "
              f"(the first act step's warm-up included; {r['env_steps'] / (r['rollout_time'] - r['first_act_time']):.1f} without it); "
              f"act step {warm_act_ms:.1f} ms after the first (host clock, B={WP_N}: upload of the state, act, download of the "
              f"actions; the first {1e3 * r['first_act_time']:.0f} ms), env_time {1e3 * r['env_time'] / r['act_steps']:.1f} ms per "
              f"step; PPO updates {r['update_time']:.2f} s")
        print(f"PPO minibatch step (T={ppo.num_steps}, n={WP_N // ppo.num_mini_batch}) by CUDA events, mean of the "
              f"{minibatches - 1} after the first: {sum(warm.values()):.2f} ms = " + ", ".join(f"{k} {warm[k]:.2f}" for k in order)
              + " ms; the first " + ", ".join(f"{k} {first[k]:.1f}" for k in order) + f" ms; peak card memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

        last = os.path.join(ckpts, f"ckpt.{WP_UPDATES - 1}.ckpt")
        saved = load_checkpoint(last)
        assert saved["extra_state"] == {"update": WP_UPDATES - 1, "count_steps": act_steps * WP_N}, saved["extra_state"]
        assert len(saved["optim_state"]["state"]) == len(with_state)
        evaluator, eval_launches, eval_wall = _run_loop("eval", common + [
            # sampled actions: greedy ones of the seeded policy STOP at once
            "TASK_CONFIG.DATASET.NUM_EPISODES", 16, "EVAL.EPISODE_COUNT", 8, "EVAL.SAMPLE", True, "EVAL_CKPT_PATH_DIR", last,
            "RESULTS_DIR", os.path.join(tmp, "evals"),
        ], exp=WP_EXP, per_act_step=(2, 0, 0, 0))
        head = "critic.fc.weight"
        assert torch.equal(evaluator.policy.state_dict()[head].cpu(), after[head]), "eval did not load the trained weights"
        with open(os.path.join(tmp, "evals", f"stats_ckpt_0_{trainer.config.EVAL.SPLIT}.json")) as f:
            stats = json.load(f)
        assert "waypoint_reward_measure" in stats and "spl" in stats and all(math.isfinite(v) for v in stats.values()), stats
        t = evaluator.last_loop_timing
        print(f"waypoint eval of {os.path.basename(last)}: {len(evaluator._last_eval_episode_stats)} episodes, {t['act_steps']} "
              f"act steps, {t['env_steps']} env steps in {t['total_time']:.2f} s ({t['env_steps'] / t['total_time']:.1f} "
              f"env-steps/s; run_exp {eval_wall:.1f} s), stats {json.dumps({k: round(v, 4) for k, v in stats.items()})}")

    # one PPO minibatch step alone, its minibatch on the host as the storage yields it
    _, policy, agent, sample = build_waypoint_ppo_step(dev, "bfloat16")

    def minibatch_step():
        agent.optimizer.zero_grad(set_to_none=True)
        total, _ = agent.loss(agent.upload(sample), agent.clip_param(0), WP_T)
        total.backward()
        agent.optimizer.step()

    step_ms = cuda_ms(minibatch_step, iters=5, warmup=2)
    busy, kernels = device_ms(minibatch_step, 3)
    b1 = sum(v for k, v in kernels.items() if "gru_" in k)
    print(f"PPO minibatch step alone (T={WP_T}, n=1, upload of {sum(v.nbytes for v in sample[0].values()) / 1e6:.1f} MB from "
          f"the host included): {step_ms:.2f} ms by CUDA events, device busy {busy:.2f} ms (profiler), idle share "
          f"{max(0.0, 1 - busy / step_ms):.1%}; B1's kernels {b1:.3f} ms of the busy time")
    return launches, eval_launches


def phase_waypoint_against_plain(dev):
    """One seeded f32 PPO minibatch step of 1-wpn-cc at T=16, n=1 (TF32 off):
    the loss and every trainable gradient through B1 (forward storing the
    gates, cluster-route backward, weight gradient; 2 launches each) and
    again with the plain loop under autograd. The losses must agree within
    1e-5 relative, the gradients at the tolerance of
    phase_train_step_against_plain (1e-5 of their own scale plus 1e-8 of
    the largest)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _, policy, agent, sample = build_waypoint_ppo_step(dev, "float32")
    dev_sample = agent.upload(sample)

    def losses_and_gradients():
        policy.zero_grad(set_to_none=True)
        total, stats = agent.loss(dev_sample, agent.clip_param(0), WP_T)
        total.backward()
        losses = torch.stack([total.detach()] + [stats[k].detach() for k in ("value_loss", "action_loss", "entropy_loss")])
        return losses, {k: p.grad.clone() for k, p in policy.named_parameters() if p.requires_grad and p.grad is not None}

    _reset_launches()
    k_losses, k_grads = losses_and_gradients()
    launches = _read_launches()
    assert launches == {"gru_sequence": 2, "gru_sequence_backward": 2, "gru_weight_gradient": 2,
                        "fused_resize_normalize": 0}, launches
    assert _cluster_launches() == 2, "B1's backward did not take the cluster route"
    with plain_versions():
        p_losses, p_grads = losses_and_gradients()
    assert _read_launches() == launches, "the plain run launched a kernel"
    assert sorted(k_grads) == sorted(p_grads) and len(p_grads) > 0
    err_l = float(((k_losses - p_losses).abs() / p_losses.abs().clamp(min=1e-30)).max())
    largest = max(float(ref.abs().max()) for ref in p_grads.values())
    ratios = {}
    for name, ref in p_grads.items():
        scale = float(ref.abs().max())
        err = float((k_grads[name] - ref).abs().max())
        ratios[name] = (err / (1e-5 * scale + 1e-8 * largest), err, scale)
    worst = sorted(ratios.items(), key=lambda kv: -kv[1][0])[:3]
    print(f"f32 PPO minibatch step at T={WP_T} n=1 (TF32 off), B1 kernels vs plain loop under autograd: losses (total, value, "
          f"action, entropy) {k_losses.tolist()} vs {p_losses.tolist()} (max relative diff {err_l:.3e}, held at 1e-5); "
          f"{len(p_grads)} gradients, the largest max |plain| {largest:.3e}; nearest to the tolerance 1e-5 x max |plain| + "
          f"1e-8 x that: " + "; ".join(f"{name} at {r:.3f} of it (|diff| {e:.3e}, max |plain| {sc:.3e})" for name, (r, e, sc) in worst))
    assert all(bool(torch.isfinite(g).all()) for g in k_grads.values()), "non-finite gradient"
    assert err_l <= 1e-5 and worst[0][1][0] <= 1.0, "the f32 PPO step through the kernels disagrees with the plain loop"
    torch.backends.cudnn.allow_tf32 = True


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    import vlnce_torch  # noqa: F401  (fails where the repository is absent)

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    name = phase_device()
    phase_build()
    kernels = [phase_gru(dev), *phase_gru_backward(dev), phase_resize(dev)]
    paths = {"act_phase": phase_main_path(dev)[0]}
    paths["eval"], paths["inference"] = phase_serving(dev)
    paths["training"], paths["training_eval"] = phase_training(dev)
    paths["train_step"] = phase_train_step(dev)
    phase_train_step_against_plain(dev)
    shapes = phase_recollect_shapes(dev)
    paths["recollect"], paths["recollect_eval"] = phase_recollect(dev)
    phase_recollect_against_plain(dev)
    paths["seq2seq"], paths["seq2seq_eval"] = phase_seq2seq(dev)
    wp_shapes = phase_waypoint_shapes(dev)
    paths["waypoint"], paths["waypoint_eval"] = phase_waypoint(dev)
    phase_waypoint_against_plain(dev)
    for k, extra, wp in zip(kernels, (shapes["forward"], shapes["backward"], shapes["weight"], shapes["resize"]),
                            (wp_shapes["forward"], wp_shapes["backward"], wp_shapes["weight"], {})):
        k.update(extra)
        k.update(wp)
    for k in kernels:
        for path, launches in paths.items():
            k[f"launches_{path}"] = launches[k["name"]]
        k["launches"] = sum(launches[k["name"]] for launches in paths.values())
    assert all(k["launches"] > 0 for k in kernels), "a kernel was launched on no path"
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s (the build included)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
