#!/usr/bin/env python3
"""Card check of the PyTorch port: builds its CUDA kernels, holds each against
its plain PyTorch version, and drives the RxR CMA act step, eval and inference
(over host simulators and in the closed loop on the card), the R2R CMA DAgger
training (with host and on-device collection, the latter also with the
trajectory bank on the card), the feature-bank route of the scan eval, the
RxR CMA and Seq2Seq
recollect training (re-simulated on the host, and rendered on the card), and
the DD-PPO training of the waypoint policy (with host and on-device rollouts)
and the asset-day parity check at full width.

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
   2 DAgger iterations (beta 1.0, then 0.5) of 8 episodes and 2 epochs at
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
15. `phase_scan_eval` (after phase 5): `run_exp(rxr_cma_en.yaml, "eval")`
   with EVAL.ON_DEVICE_SCAN, the closed loop on the card (renderer,
   transforms, act, step; one CUDA graph of one env step, replayed): 64
   synthetic episodes of at most 40 steps, SCAN_BATCH 32, SCAN_SEGMENT 64,
   480x640 frames, bf16; the capture must record 2 launches of B1 and 2 of
   B2 per step, every segment one read-back, a profiled segment 2 x steps
   kernels of each; then scan inference over 8 episodes (rxr format);
16. `phase_scan_against_plain`: the graphed scan step through the kernels
   against the eager step with the plain versions (f32, greedy, B=8): RNN
   states and logits at phase 4's tolerance, actions equal where the top-2
   gap exceeds it; the card's renderer at 480x640 against the host
   GridWorldSim at 8 seeded poses (depth atol 1e-3, RGB off by more than 1
   on under 2% of the pixels);
17. `phase_device_dagger` (after phase 7): phase 7's training, with rounds
   of 16 episodes, with CUDA.ON_DEVICE_DAGGER (the collection on the card: renderer, act, the
   device expert, the beta mix, the step, one graph replay per step): B1
   captured twice per collect step, frozen weights bit-equal, the store's
   32 episodes with round 0's actions the expert's, the action loss
   falling; then the scan eval of the last checkpoint;
18. `phase_device_recollect` (after phase 9): phase 9's training, cut to
   its first epoch, with CUDA.ON_DEVICE_RECOLLECT (the GT trajectories
   rendered on the card, one graph replay per step, one read-back per
   chunk), then with CUDA.RECOLLECT_RESIDENT as well (B2 captured twice per render step, the
   batch kept on the card); one chunk's frames against the host simulator
   stepped along the same actions, and the render's env-steps/s beside
   phase 9's re-simulation;
19. `phase_device_waypoint` (after phase 13): phase 13's training with
   CUDA.ON_DEVICE_ROLLOUT (no worker; each env step one replay, B1 twice in
   it; the bootstrap value a second graph; one read-back per rollout; the
   PPO minibatches gathered on the card by update_device_scan), first with
   the step clock (every minibatch step eager), then without it (the first
   update eager, the second captures the minibatch step and replays it;
   launches counted as the card ran them, the profiler's launches a
   replayed step); the replays and the enqueued minibatch loop under
   set_sync_debug_mode("error"); every minibatch step on the rollout's
   stored backbone features, no frame recomputed; frozen weights
   bit-equal, the checkpoint's eval; the rollout's and the update's times
   beside phase 13's;
20. `phase_device_waypoint_against_plain`: the graphed rollout through B1's
   kernel against the eager one with its plain version (f32, N=4, T=8, the
   same uniforms): values and log-probs at phase 4's tolerance, positions
   and rewards within 1e-5 while the actions agree;
21. `phase_device_dagger_resident` (after phase 17): phase 17's training
   with CUDA.DAGGER_RESIDENT (the collected rows kept on the card in the
   trajectory bank, the train batches gathered there: no upload, no store),
   in three runs: per batch, with RESIDENT_EPOCH_SCAN (each run of an
   epoch's batches enqueued under set_sync_debug_mode("error"), one
   read-back per run), and with DAGGER_ARCHIVE_STORE (the store must hold
   the bank's rows); per train step 2 + 2 + 2 launches of B1 on the cluster
   route; the losses against phase 17's and each other's within
   RESIDENT_LOSS_RTOL; the bank's size, the collection's rate beside phase
   17's, the train step's split, the enqueued epoch's ms per batch;
22. `phase_feature_bank`: the port's encode_scene_bank writes the banks of
   two synthetic scenes at full width (2 m lattice, 24 headings), then the
   R2R CMA scan eval with CUDA.FEATURE_BANK_DIR (the lookup in place of the
   renderer inside the graph, B1 twice per step), its actions against the
   same rollouts run eagerly, its rate beside the rendered scan eval's;
23. `phase_imported_scenes`: two lattice scenes exported in native frames
   away from the origin (168 and 104 cells a side), then through
   SIMULATOR.GEOMETRY_DIR only: the RxR CMA scan eval of 64 episodes at
   B=32 (one graph per grid size, B1 and B2 twice per step in each), the
   feature banks at the graphs' nodes by the port's generate_feature_bank
   CLI and the R2R bank scan eval (against its eager run), the graphed RxR
   step against the eager plain step on a chunk of both scenes, and a
   nonlearning eval (no kernel); every scene run must be an ImportedScene;
24. `phase_eval_parity`: the asset-day parity check
   (`vlnce_torch.scripts.eval_parity`'s main) on those two scenes, which it
   exports itself from a connectivity pickle: (a) R2R CMA cma_pm_da.yaml at
   full width with --resident and a bank dir (the banks, the host loop over
   2 forked workers, the bank route's scan eval; resident-vs-host at 2.0, as
   the JAX dry run), (b) RxR CMA rxr_cma_en.yaml with --resident, rendered
   (B2 in the graph; resident-vs-host at the default 0.02; then each stage
   with the plain versions, the scan eager, must give the kernels' actions
   episode by episode), (c) --expected-spl
   a point off (a)'s host SPL must exit 1; 8 greedy episodes of at most 30
   steps per stage; B1 (and B2 in b) counted in both stages of each; per
   episode the host and scan loops' actions against each other; each
   stage's env-steps/s, the export's and the banks' seconds;
25. `phase_video`: VIDEO_OPTION [disk] at full width on procedural scenes
   (MAP_RESOLUTION 1024, fog of war on) in the RxR CMA host eval (8 forked
   workers, 8 episodes), the RxR CMA scan eval (B=32, 16 episodes) and the
   WPN eval (4 workers, 4 episodes), each beside the same eval without
   video: the same actions and per-episode metrics, B1 and B2 launched per
   act step as without video, one AVI per episode with a frame per step
   that `read_video` gives back bit for bit; env-steps/s with and without
   video, ms per composed frame, MB per file, the map's bytes per step;
26. `phase_shm_ring`: /dev/shm's size, then the shared-memory observation
   ring (VLNCE_TORCH_SHM_OBS=1) against the pipes (=0) in the RxR CMA host
   eval at N=8 (equal actions and per-episode measures, B1 and B2 twice per
   act step in both, env-steps/s of each, where an env step's time goes
   with the ring, the bytes a pool step still sends through the pipes) and
   in the WPN DD-PPO host rollout at N=4, one update (equal rollout
   storage, env-steps/s of each);
27. `phase_two_ranks`: two rank processes on this card (gloo, TF32 off,
   f32) through vlnce_torch.parallel.mp_smoke against one process on the
   whole batch: the R2R CMA IL update at full width (3 + 3 envs, T=32) and
   one WPN PPO minibatch (2 + 2 envs, T=16): losses within 1e-5 relative,
   the ranks bit-equal, every gradient within step 7's f32 tolerance, B1's
   three kernels twice per GRU on each rank; a resident DAgger train() of
   two ranks at the widths of cma_pm_da_aug_tune.yaml (disjoint slices
   covering the plan, equal losses, only rank 0's checkpoint); the DD-PPO
   waypoint trainer's train() of two ranks at the widths of 1-wpn-cc.yaml,
   one update with the rollout on the card (equal stats and final weights,
   only rank 0's checkpoint); then `python -m vlnce_torch.run --run-type
   train` of that resident DAgger at world size 1 through NCCL (torchrun's
   variables set by hand);
28. `phase_goal_field` (after phase 3): the goal-field kernel
   (csrc/goal_field.cu, no TPU counterpart) against its plain version and
   the host's Dijkstra (BaseScene._dijkstra), bit for bit: 22 fields on
   procedural 64 x 64 scenes (a chunk of the benchmark's rollout cell; the
   fields in shared memory), 4 on rasterised lattices of 80 x 80 and
   160 x 160 (shared memory above the default 48 KB, which the kernel asks
   for; at n = 80 first inside a graph capture, the process's first launch
   at that size) and 4 on one of 256 x 256 (in device memory); then the kernel's device time by graph replay beside its
   bound (F n^2 9 bytes at 3.35 TB/s), the plain version's (events: it reads
   back a flag each sweep) and the host Dijkstra's (host clock); the scan
   eval and scan inference of phase 15 check one launch per chunk, counted
   from 0, and the kernels line reports those launches;
29. a {"kernels": [...]} line, then the {"ok": true, ...} line last.

Any failed check raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import gzip
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
# the goal fields of the closed loops' chunks
# ---------------------------------------------------------------------------


def phase_goal_field(dev):
    from vlnce_torch.envs.device_sim import _pad_grid
    from vlnce_torch.envs.gridworld import _RES, get_scene
    from vlnce_torch.envs.scene_import import scene_from_graph
    from vlnce_torch.ops.goal_field import goal_distance_fields, goal_distance_fields_plain, shared_bytes
    from vlnce_torch.utils.nav_graph import synthetic_lattice_graph

    rng = np.random.RandomState(19)

    def lattice(world):
        return [scene_from_graph(f"goal_field_lattice_{int(world)}", synthetic_lattice_graph(world_size=world))]

    cases = {  # label: (scenes, goals per scene)
        "F=22 n=64": ([get_scene(f"goal_field_smoke_{k}") for k in range(22)], 1),
        "F=4 n=80": (lattice(20.0), 4),
        "F=4 n=160": (lattice(40.0), 4),
        "F=4 n=256": (lattice(64.0), 4),
    }
    out = {"name": "goal_distance_fields", "route": "cuda", "source": "vlnce_torch/csrc/goal_field.cu",
           "replaces": "none (the host's BaseScene._dijkstra)"}
    for label, (scenes, per_scene) in cases.items():
        n = max(s.n for s in scenes)
        cells, want, host_s = [], [], 0.0
        for row, scene in enumerate(scenes):
            free, blocked = np.argwhere(~scene.occupancy), np.argwhere(scene.occupancy)
            for k in range(per_scene):
                pool = blocked if (row + k) % 5 == 4 else free  # some goals on blocked cells: snapped
                cell = tuple(int(v) for v in pool[rng.randint(len(pool))])
                t0 = time.perf_counter()
                want.append(_pad_grid(scene._dijkstra(cell), n, np.inf))
                host_s += time.perf_counter() - t0
                cells.append((row, *scene.snap_goal_cell(*cell)))
        occ = torch.from_numpy(np.stack([_pad_grid(s.occupancy, n, True) for s in scenes])).to(dev)
        cells = torch.tensor(cells, dtype=torch.int32, device=dev)
        want = np.stack(want)
        F = cells.shape[0]
        assert n == int(label.split("n=")[1]) and bool(shared_bytes(n)) == (n <= 160), (label, n)
        captured = ""
        if n == 80:  # the first launch at a size above 48 KB of shared memory: inside a capture
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                in_graph = goal_distance_fields(occ, cells, _RES)
            graph.replay()
            torch.cuda.synchronize()
            assert np.array_equal(in_graph.cpu().numpy(), want), f"goal field kernel {label}: captured, not the host's fields"
            captured = "; its first launch, in a graph capture, too"
        launches, fields = goal_distance_fields.launches, goal_distance_fields.fields
        got = goal_distance_fields(occ, cells, _RES)
        plain = goal_distance_fields_plain(occ, cells, _RES)
        torch.cuda.synchronize()
        assert (goal_distance_fields.launches - launches, goal_distance_fields.fields - fields) == (1, F)
        assert np.array_equal(got.cpu().numpy(), want), f"goal field kernel {label}: not the host's fields"
        assert np.array_equal(plain.cpu().numpy(), want), f"goal field plain {label}: not the host's fields"
        reached = float(np.isfinite(want).mean())
        ms = graph_ms(lambda: goal_distance_fields(occ, cells, _RES), reps=10, replays=5)
        plain_ms = cuda_ms(lambda: goal_distance_fields_plain(occ, cells, _RES), iters=3, warmup=1)
        b_ms, b_by = bound_ms(F * n * n * 9, 0.0)
        route = "shared memory" if shared_bytes(n) else "device memory"
        print(f"goal field {label} ({route}): kernel equals the plain version and the host's Dijkstra bit for bit "
              f"(f64; {reached:.1%} of cells reachable{captured}); device time by graph replay {ms:.4f} ms a launch of {F} "
              f"fields, bound {b_ms:.6f} ms ({b_by}, {F * n * n * 9 / 1e6:.3f} MB), plain version {plain_ms:.3f} ms "
              f"(events), host Dijkstra {1e3 * host_s / F:.3f} ms a field, {1e3 * host_s:.1f} ms for the {F}")
        out[label] = {"ms": ms, "bound_ms": b_ms, "bound_by": b_by, "plain_ms": plain_ms,
                      "host_ms": 1e3 * host_s, "fields": F, "n": n, "route": route}
    print(json.dumps({"goal_field": out}))
    return out


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
    """Sets every kernel's launch counters to 0: those of `_counted()`,
    which `_read_launches()` reads, and the goal-field kernel's, which
    `_field_launches()` reads (a path's set-up launches it once a chunk)."""
    from vlnce_torch.ops.goal_field import goal_distance_fields

    for wrapper in _counted().values():
        wrapper.launches = 0
    _counted()["gru_sequence_backward"].cluster_launches = 0
    goal_distance_fields.launches = goal_distance_fields.fields = 0


def _field_launches():
    from vlnce_torch.ops.goal_field import goal_distance_fields

    return {"goal_distance_fields": goal_distance_fields.launches}


def _cluster_launches():
    """How many of B1's backward launches since the last reset took the cluster route."""
    return _counted()["gru_sequence_backward"].cluster_launches


def _read_launches():
    return {name: wrapper.launches for name, wrapper in _counted().items()}


def _recorded(**launches):
    """A graph capture's launch record: `launches`, and 0 for every other
    kernel wrapper that vlnce_torch.ops.graphs.launch_counts reads."""
    from vlnce_torch.ops.graphs import launch_counts

    return {k: launches.get(k, 0) for k in launch_counts()}


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
        host_eval_rate = trainer.last_loop_timing["env_steps"] / trainer.last_loop_timing["total_time"]
    return eval_launches, inf_launches, host_eval_rate


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
HOST_TRAIN_EPISODES = 8  # phase_training's rounds (the forked pool's collection is the script's slowest loop)


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
            "IL.load_from_ckpt", False, "IL.DAGGER.iterations", TRAIN_ITERATIONS, "IL.DAGGER.update_size", HOST_TRAIN_EPISODES,
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
        assert [r["beta"] for r in rounds] == [1.0, 0.5] and all(r["episodes"] >= HOST_TRAIN_EPISODES for r in rounds), rounds
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
    return launches, eval_launches, rounds


# ---------------------------------------------------------------------------
# the closed loops on the card: scan eval and inference of RxR CMA, and the
# on-device DAgger collection of R2R CMA (one CUDA graph replay per env step)
# ---------------------------------------------------------------------------

SCAN_B = 32  # EVAL.SCAN_BATCH: the act step's B
SCAN_SEGMENT = 64  # EVAL.SCAN_SEGMENT; the step cap below cuts a segment to 40 steps
SCAN_EPISODES = 64
SCAN_STEPS = 40  # TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS, cut from 500


def trace_segment(run_segment):
    """One segment under torch.profiler: its wall ms between two CUDA events
    (the read-back included), the device's busy ms (every kernel, copy and
    fill of the trace) and the kernels' launch counts by name."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        run_segment()
        end.record()
        torch.cuda.synchronize()
    counts, busy = collections.Counter(), 0.0
    for ev in prof.key_averages():
        if ev.self_device_time_total > 0:
            busy += ev.self_device_time_total / 1e3
            counts[ev.key] += ev.count
    assert busy > 0, "the profiler saw no device time in a replayed segment"
    return start.elapsed_time(end), busy, counts


def _kernel_count(counts, name):
    return sum(n for key, n in counts.items() if name in key)


def _check_scan_run(trainer, launches, per_step, what):
    """A scan run built one graph: its capture recorded `per_step` launches
    of (B1, B2) per env step, the wrappers counted the warm-up's and the
    capture's, and every segment was read back once."""
    t = trainer.last_loop_timing
    b1, b2 = per_step
    assert t["graph"] and t["capture_launches"] == _recorded(gru_sequence=b1, fused_resize_normalize=b2), (what, t)
    assert launches == {"gru_sequence": 2 * b1, "gru_sequence_backward": 0, "gru_weight_gradient": 0,
                        "fused_resize_normalize": 2 * b2}, (what, launches)
    assert t["readbacks"] == t["segments"] and t["replays"] == t["segments"] * t["seg_len"], (what, t)
    assert {p.device.type for p in trainer.policy.parameters()} == {"cuda"}, "the policy is not on the card"
    return t


def phase_scan_eval(dev, host_eval_rate):
    """`run_exp(rxr_cma_en.yaml, "eval")` with EVAL.ON_DEVICE_SCAN at full
    width in bf16: 64 synthetic episodes of at most 40 steps in chunks of
    SCAN_B = 32, segments of 64 steps (cut to the 40-step cap), the YAML's
    sampled actions; then `run_exp(..., "inference")` with
    INFERENCE.ON_DEVICE_SCAN over 8 episodes in the rxr format."""
    from vlnce_torch.run import run_exp
    from vlnce_torch.trainers import scan_eval
    from vlnce_torch.utils.checkpoints import save_checkpoint

    with tempfile.TemporaryDirectory(prefix="vlnce_torch_smoke_") as tmp:
        cfg, policy, _ = build_act_step(dev, "bfloat16")
        mark = torch.arange(6, dtype=torch.float32) * 0.01
        with torch.no_grad():
            policy.action_distribution.linear.bias.copy_(mark)
        ckpt = os.path.join(tmp, "ckpt.0.pth")
        save_checkpoint(ckpt, policy.state_dict(), config=cfg)
        del policy
        common = [
            "TASK_CONFIG.DATASET.TYPE", "Synthetic-VLN-v0", "TASK_CONFIG.DATASET.NUM_SCENES", N_ENVS,
            "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", SCAN_STEPS, "EVAL.SCAN_BATCH", SCAN_B,
            "EVAL.SCAN_SEGMENT", SCAN_SEGMENT, "TENSORBOARD_DIR", "", "VERBOSE", False,
            "LOG_FILE", os.path.join(tmp, "run.log"),
        ]
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t0 = time.perf_counter()
        trainer = run_exp(EXP, "eval", common + [
            "EVAL.ON_DEVICE_SCAN", True, "TASK_CONFIG.DATASET.NUM_EPISODES", SCAN_EPISODES,
            "EVAL.EPISODE_COUNT", SCAN_EPISODES, "EVAL.USE_CKPT_CONFIG", False, "EVAL_CKPT_PATH_DIR", ckpt,
            "RESULTS_DIR", os.path.join(tmp, "evals"),
        ])
        wall = time.perf_counter() - t0
        eval_launches = _read_launches()
        builds = _field_launches()
        print(f"scan eval launches (warm-up and capture of one graph; the goal fields, a launch a chunk): "
              f"{json.dumps({**eval_launches, **builds})}")
        t = _check_scan_run(trainer, eval_launches, (2, 2), "scan eval")
        assert builds["goal_distance_fields"] == -(-SCAN_EPISODES // SCAN_B), f"{builds} for the scan eval's chunks"
        eval_launches.update(builds)
        assert torch.equal(trainer.policy.action_distribution.linear.bias.cpu(), mark), "the checkpoint's weights were not loaded"
        with open(os.path.join(tmp, "evals", f"stats_ckpt_0_{cfg.EVAL.SPLIT}.json")) as f:
            stats = json.load(f)
        assert sorted(stats) == sorted(RXR_MEASURES) and all(math.isfinite(v) for v in stats.values()), stats
        episodes = trainer._last_eval_episode_stats
        assert len(episodes) == len(set(episodes)) == SCAN_EPISODES, sorted(episodes)
        loop_s = t["seconds"] - t["capture_seconds"]
        rows = t["replays"] * t["batch"]
        print(f"scan eval: {len(episodes)} episodes (MAX_EPISODE_STEPS cut to {SCAN_STEPS} from 500), stats "
              f"{json.dumps({k: round(v, 4) for k, v in stats.items()})}; run_exp {wall:.2f} s")
        print(f"scan eval graph: captured in {t['capture_seconds']:.3f} s (warm-up included), {t['capture_launches']} "
              f"launches per step; {t['segments']} segments of {t['seg_len']} steps at B={t['batch']}, "
              f"{t['readbacks']} read-backs, {t['replays']} replays")
        device_s = loop_s - t["setup_seconds"]
        print(f"scan eval env-steps/s: {t['env_steps'] / loop_s:.1f} of the episodes' steps ({t['env_steps']} steps in "
              f"{loop_s:.3f} s after the capture, of which the chunks' host setup (scene arrays, instruction features, "
              f"upload) {t['setup_seconds']:.3f} s and the segments {device_s:.3f} s: {t['env_steps'] / device_s:.1f} env-steps/s "
              f"of the device part, {rows / device_s:.1f} of all {rows} stepped rows, the padded and stopped included); "
              f"host replay of the measures {t['replay_seconds']:.3f} s ({t['env_steps'] / t['replay_seconds']:.1f} env-steps/s); "
              f"{t['env_steps'] / (t['seconds'] + t['replay_seconds']):.1f} env-steps/s with the capture and the replay; "
              f"{1e3 * device_s / t['segments']:.2f} ms per segment of {t['seg_len']} steps; host eval loop (phase_serving, "
              f"this run) {host_eval_rate:.1f} env-steps/s; peak card memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

        # one segment replayed again under the profiler: B1 and B2 ran 2 x seg_len times. A graph without
        # a kernel misses it in each replay of every trace; the profiler has returned fewer activity
        # records than the replays ran (78 of 80 once), so a short count is traced again, at most twice
        segment = next(v for k, v in scan_eval.policy_cache(trainer.policy).items() if k[0] == "eval")
        for trace in range(3):
            segment.load(segment.scenes, segment.instruction, segment.pos.clone(), segment.heading.clone())
            seg_ms, busy, counts = trace_segment(lambda: segment.run(trainer.generator))
            n1, n2 = _kernel_count(counts, "gru_sequence_kernel"), _kernel_count(counts, "resize_normalize_kernel")
            if n1 == n2 == 2 * segment.seg_len:
                break
            print(f"scan eval segment under the profiler, trace {trace + 1}: B1 kernels {n1}, B2 kernels {n2} of "
                  f"2 x {segment.seg_len} each; traced again")
        print(f"scan eval segment under the profiler: {seg_ms:.2f} ms for {segment.seg_len} steps at B={segment.B} "
              f"({segment.B * segment.seg_len / seg_ms * 1e3:.1f} env-steps/s of rows), device busy {busy:.2f} ms, idle share "
              f"{max(0.0, 1 - busy / seg_ms):.1%}; B1 kernels {n1}, B2 kernels {n2} (2 x {segment.seg_len} each)")
        top = sorted(((v, k) for k, v in counts.items()), reverse=True)[:3]
        print("scan eval segment's most launched kernels: " + "; ".join(f"{v} x {k[:70]}" for v, k in top))
        assert n1 == n2 == 2 * segment.seg_len, (n1, n2, segment.seg_len)

        predictions = os.path.join(tmp, "predictions.jsonl")
        _reset_launches()
        inf_trainer = run_exp(EXP, "inference", common + [
            "INFERENCE.ON_DEVICE_SCAN", True, "TASK_CONFIG.DATASET.NUM_EPISODES", N_ENVS, "INFERENCE.FORMAT", "rxr",
            "INFERENCE.USE_CKPT_CONFIG", False, "INFERENCE.CKPT_PATH", ckpt, "INFERENCE.PREDICTIONS_FILE", predictions,
        ])
        inf_launches = _read_launches()
        t = _check_scan_run(inf_trainer, inf_launches, (2, 2), "scan inference")
        builds = _field_launches()
        assert builds["goal_distance_fields"] == -(-N_ENVS // SCAN_B), f"{builds} for the scan inference's chunks"
        inf_launches.update(builds)
        with open(predictions) as f:
            lines = [json.loads(line) for line in f]
        assert len(lines) == N_ENVS and len({str(e["instruction_id"]) for e in lines}) == N_ENVS, lines
        for entry in lines:
            path = entry["path"]
            assert len(path) >= 1 and all(len(p) == 3 and all(math.isfinite(x) for x in p) for p in path), entry
        print(f"scan inference: {len(lines)} rxr entries (one padded chunk of {t['batch']}), {t['env_steps']} env steps, "
              f"{t['segments']} segments in {t['seconds']:.2f} s with the capture; launches {json.dumps(inf_launches)}")
    return eval_launches, inf_launches


def _scan_against_plain(dev, cfg, policy, task_cfg, episodes, steps: int, what: str):
    """`steps` one-step scan segments of `episodes` (one chunk, greedy): the
    graph through the kernels against the eager step with the plain versions
    swapped in, rendering the same frames. The RNN states and the logits are
    held at phase_main_path's tolerance, the actions equal wherever the top-2
    logit gap exceeds it."""
    from vlnce_torch.envs import device_sim
    from vlnce_torch.ops.obs_transforms import get_active_obs_transforms
    from vlnce_torch.envs.device_sim import chunk_tensors
    from vlnce_torch.trainers.scan_eval import ScanSegment

    n = len(episodes)
    scenes, arrays = chunk_tensors(episodes, "rxr_instruction", task_cfg, dev)
    specs = device_sim.camera_specs_from_config(task_cfg.SIMULATOR)
    transforms = get_active_obs_transforms(cfg)
    segs = {}
    for name, eager in (("kernels", False), ("plain", True)):
        with plain_versions() if eager else contextlib.nullcontext():
            segs[name] = ScanSegment(policy, transforms, specs, task_cfg.SIMULATOR, True, 1, scenes, arrays["instruction"],
                                     instr_uuid="rxr_instruction", use_tilt=True, eager=eager)
        segs[name].load(scenes, arrays["instruction"], arrays["pos"], arrays["heading"])
    assert segs["kernels"].step.graph is not None and segs["plain"].step.graph is None
    err_l = err_s = 0.0
    compared = flipped = 0
    for step in range(steps):
        a_k, _ = segs["kernels"].run()
        with plain_versions():
            a_p, _ = segs["plain"].run()
        lk, lp = segs["kernels"].logits, segs["plain"].logits
        scale = float(lp.abs().max())
        err_l = max(err_l, float((lk - lp).abs().max()) / scale)
        err_s = max(err_s, float((segs["kernels"].rnn - segs["plain"].rnn).abs().max()))
        top2 = lp.topk(2, dim=1).values
        gap = (top2[:, 0] - top2[:, 1]) / scale
        differ = a_k[0] != a_p[0]
        assert not bool((torch.from_numpy(differ).to(dev) & (gap > 1e-4)).any()), f"{what}, step {step}: actions differ above the tolerance"
        compared += 1
        if differ.any():  # an action flipped on a gap within the tolerance: the loops part here
            flipped += 1
            break
        assert torch.equal(segs["kernels"].pos, segs["plain"].pos)
    print(f"{what} against plain (f32, TF32 off, B={n}, grid {tuple(scenes.occupancy.shape[1:])}, {compared} one-step "
          f"segments, graph vs eager plain): max |logits diff| {err_l:.3e} of max |logit| (<= 1e-4), max |state diff| "
          f"{err_s:.3e} (atol 1e-3), actions equal at every step {'' if not flipped else 'until one flipped within the tolerance'}")
    assert err_l <= 1e-4 and err_s <= 1e-3, f"{what}: the scan step with the kernels disagrees with the plain versions"


def phase_scan_against_plain(dev, steps: int = 12, n: int = 8):
    """One seeded f32 RxR CMA loop (TF32 off, greedy) of `steps` one-step
    segments at B=n: the graph through the kernels against the eager step
    with the plain versions swapped in (`_scan_against_plain`). Then the
    card's renderer at 480x640 against the host GridWorldSim at seeded
    poses."""
    from vlnce_torch.envs import device_sim
    from vlnce_torch.envs.gridworld import GridWorldSim, get_scene
    from vlnce_torch.tasks.datasets import make_dataset
    from vlnce_torch.tasks.geometry import quat_from_heading

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, policy, _ = build_act_step(dev, "float32")
    task_cfg = cfg.TASK_CONFIG.clone()
    task_cfg.defrost()
    task_cfg.DATASET.TYPE = "Synthetic-VLN-v0"
    task_cfg.freeze()
    episodes = list(make_dataset(task_cfg.DATASET.TYPE, task_cfg.DATASET).episodes)[:n]
    _scan_against_plain(dev, cfg, policy, task_cfg, episodes, steps, "scan")
    specs = device_sim.camera_specs_from_config(task_cfg.SIMULATOR)

    # the renderer against the host simulator, at seeded poses over 4 scenes
    rng = np.random.RandomState(17)
    sim = GridWorldSim(task_cfg.SIMULATOR)
    scene_ids = [f"synth_scene_{k % 4}" for k in range(8)]
    poses = []
    for sid in scene_ids:
        occ = get_scene(sid).occupancy
        while True:
            x, z = rng.uniform(0.3, 15.7, 2)
            if not occ[int(x / 0.25), int(z / 0.25)]:
                poses.append([x, 0.0, z, rng.uniform(0, 2 * math.pi)])
                break
    poses = np.asarray(poses, np.float32)
    grids = {k: torch.from_numpy(np.stack([getattr(get_scene(s), k) for s in scene_ids])).to(dev)
             for k in ("occupancy", "wall_colors", "floor_color", "ceil_color")}
    frames = device_sim.render_arrays(grids["occupancy"], grids["wall_colors"], grids["floor_color"], grids["ceil_color"],
                                      torch.from_numpy(poses[:, :3]).to(dev), torch.from_numpy(poses[:, 3]).to(dev), specs)
    frames = {k: v.cpu().numpy() for k, v in frames.items()}
    worst_depth = worst_rgb = 0.0
    for b, sid in enumerate(scene_ids):
        sim.reconfigure(sid)
        host = sim.get_observations_at(poses[b, :3].astype(np.float64), quat_from_heading(float(poses[b, 3])))
        worst_depth = max(worst_depth, float(np.abs(frames["depth"][b] - host["depth"]).max()))
        worst_rgb = max(worst_rgb, float((np.abs(frames["rgb"][b].astype(int) - host["rgb"].astype(int)) > 1).mean()))
    print(f"renderer on the card vs the host GridWorldSim at 8 poses, 480x640: max |depth diff| {worst_depth:.2e} "
          f"(atol 1e-3), RGB pixels off by more than 1: {worst_rgb:.3%} (under 2%)")
    assert worst_depth <= 1e-3 and worst_rgb < 0.02, "the card's renderer disagrees with the host simulator"


def phase_device_dagger(dev, host_rounds):
    """`run_exp(cma_pm_da_aug_tune.yaml, "train")` with CUDA.ON_DEVICE_DAGGER
    at phase_training's sizes (NUM_ENVIRONMENTS 8, 2 rounds of 16 episodes at
    beta 1.0 then 0.5, 2 epochs at batch size 5): the collection runs on the
    card, one graph replay per env step. Then the scan eval of the last
    checkpoint."""
    from vlnce_torch.config import get_config
    from vlnce_torch.data.trajectory_store import TrajectoryStoreReader, store_length
    from vlnce_torch.envs.spaces import action_space_from_config, observation_space_from_config
    from vlnce_torch.models.cma_policy import CMAPolicy
    from vlnce_torch.parallel.optim import trainable_mask
    from vlnce_torch.run import run_exp

    with tempfile.TemporaryDirectory(prefix="vlnce_torch_smoke_") as tmp:
        ckpts, store = os.path.join(tmp, "checkpoints"), os.path.join(tmp, "trajectories")
        common = [
            "TASK_CONFIG.DATASET.TYPE", "Synthetic-VLN-v0", "TASK_CONFIG.DATASET.NUM_SCENES", N_ENVS,
            "TASK_CONFIG.DATASET.NUM_EPISODES", 64, "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", 40,
            "NUM_ENVIRONMENTS", N_ENVS, "TENSORBOARD_DIR", "", "VERBOSE", False,
            "LOG_FILE", os.path.join(tmp, "run.log"), "CHECKPOINT_FOLDER", ckpts,
        ]
        train_opts = common + [
            "CUDA.ON_DEVICE_DAGGER", True, "IL.load_from_ckpt", False, "IL.DAGGER.iterations", TRAIN_ITERATIONS,
            "IL.DAGGER.update_size", TRAIN_EPISODES, "IL.epochs", TRAIN_EPOCHS, "IL.batch_size", TRAIN_B,
            "IL.DAGGER.lmdb_features_dir", store,
        ]
        cfg = get_config(R2R_EXP, train_opts)
        start = CMAPolicy.from_config(cfg, observation_space_from_config(cfg.TASK_CONFIG), action_space_from_config(cfg.TASK_CONFIG))
        mask = trainable_mask(start, cfg.MODEL)
        start = {k: v.cpu() for k, v in start.state_dict().items()}
        _reset_launches()
        t0 = time.perf_counter()
        trainer = run_exp(R2R_EXP, "train", train_opts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_launches()
        rounds, history = trainer.collection_stats, trainer.loss_history
        train_steps = len(history)
        print(f"device DAgger launches over {train_steps} train steps and one collection graph (probe, warm-up, capture): "
              f"{json.dumps(launches)}; run_exp {wall:.1f} s")
        assert train_steps > 0 and all(r["graph"] for r in rounds)
        assert all(r["capture_launches"] == _recorded(gru_sequence=2) for r in rounds), rounds
        assert launches == {"gru_sequence": 3 * 2 + 2 * train_steps, "gru_sequence_backward": 2 * train_steps,
                            "gru_weight_gradient": 2 * train_steps, "fused_resize_normalize": 0}, launches
        assert [r["beta"] for r in rounds] == [1.0, 0.5] and all(r["episodes"] == TRAIN_EPISODES for r in rounds), rounds
        for r, host in zip(rounds, host_rounds):
            assert r["readbacks"] == r["segments"], r
            print(f"device collection round {r['data_it']} (beta {r['beta']}): {r['episodes']} episodes, {r['env_steps']} env steps, "
                  f"{r['segments']} segments of {r['seg_len']} steps at B={r['batch']} ({r['readbacks']} read-backs of the done "
                  f"flags, {r['chunk_readbacks']} bulk copies of the rows); {r['env_steps'] / r['seconds']:.1f} env-steps/s "
                  f"({r['seconds']:.3f} s: host setup of the chunks {r['setup_seconds']:.3f} s"
                  + (f", the capture {r['capture_seconds']:.3f} s" if r["data_it"] == 0 else "")
                  + f"), {r['env_steps'] / r['total_time']:.1f} with the store's writes; host collection (phase_training, this run) "
                  f"{host['env_steps'] / host['total_time']:.1f} env-steps/s")

        assert store_length(store) == TRAIN_ITERATIONS * TRAIN_EPISODES
        reader = TrajectoryStoreReader(store)
        for k in range(TRAIN_EPISODES):  # round 0 at beta 1.0: the actions taken are the expert's
            obs, prev, oracle = reader.get(k)
            assert prev[0] == 0 and np.array_equal(prev[1:], oracle[:-1]), k
            assert obs["rgb_features"].shape[0] == len(oracle) and np.isfinite(obs["rgb_features"]).all()
        reader.close()

        losses = np.array([h[2:] for h in history])
        assert np.isfinite(losses).all(), "non-finite training loss"
        first = [h for h in history if h[0] == 0]
        last_epoch = np.mean([h[2:] for h in first if h[1] == TRAIN_EPOCHS - 1], axis=0)
        print("device DAgger losses (loss, action, aux) of iteration 0: first batch " + " ".join(f"{x:.4f}" for x in first[0][2:])
              + "; mean of its last epoch " + " ".join(f"{x:.4f}" for x in last_epoch))
        assert last_epoch[1] < first[0][3], "the action loss of iteration 0 did not fall"

        after = trainer.policy.state_dict()
        frozen = {k for k, trains in mask.items() if not trains}
        assert all(torch.equal(after[k].cpu(), start[k]) for k in frozen), "a frozen weight moved"
        print(f"device DAgger weights: {len(frozen)} frozen tensors bit-equal to the seeded start; store of "
              f"{TRAIN_ITERATIONS * TRAIN_EPISODES} episodes, round 0's prev actions the expert's")

        last = os.path.join(ckpts, f"ckpt.{TRAIN_ITERATIONS * TRAIN_EPOCHS - 1}.ckpt")
        _reset_launches()
        evaluator = run_exp(R2R_EXP, "eval", common + [
            "EVAL.ON_DEVICE_SCAN", True, "EVAL.SCAN_BATCH", N_ENVS, "EVAL.EPISODE_COUNT", N_ENVS,
            "EVAL.USE_CKPT_CONFIG", False, "EVAL_CKPT_PATH_DIR", last, "RESULTS_DIR", os.path.join(tmp, "evals"),
        ])
        eval_launches = _read_launches()
        t = _check_scan_run(evaluator, eval_launches, (2, 0), "device DAgger's scan eval")
        head = "action_distribution.linear.weight"
        assert torch.equal(evaluator.policy.state_dict()[head], after[head]), "eval did not load the trained weights"
        with open(os.path.join(tmp, "evals", f"stats_ckpt_0_{cfg.EVAL.SPLIT}.json")) as f:
            stats = json.load(f)
        assert sorted(stats) == sorted(RXR_MEASURES) and all(math.isfinite(v) for v in stats.values()), stats
        print(f"scan eval of {os.path.basename(last)}: {len(evaluator._last_eval_episode_stats)} episodes, {t['env_steps']} env steps "
              f"in {t['segments']} segments, stats {json.dumps({k: round(v, 4) for k, v in stats.items()})}")
    return launches, eval_launches, {"rounds": rounds, "history": history}


# ---------------------------------------------------------------------------
# the trajectory bank on the card (CUDA.DAGGER_RESIDENT, RESIDENT_EPOCH_SCAN,
# DAGGER_ARCHIVE_STORE) and the feature-bank route of the loops on the card
# ---------------------------------------------------------------------------

# the losses of the resident runs against the store-wired run: the same
# batches (the bank's rows are the store's, f16 features read back as f32 in
# both) through the same train step, so they differ only where a reduction
# order changes between two runs of the card's kernels (on an H100: bit-equal
# in the first round, under 2e-7 relative after it); the bound is far below
# what a wrong row, weight or mask moves (the action loss changes by about
# 1e-2 between the batches of one epoch)
RESIDENT_LOSS_RTOL = 1e-4


def _resident_opts(tmp):
    return [
        "TASK_CONFIG.DATASET.TYPE", "Synthetic-VLN-v0", "TASK_CONFIG.DATASET.NUM_SCENES", N_ENVS,
        "TASK_CONFIG.DATASET.NUM_EPISODES", 64, "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", 40,
        "NUM_ENVIRONMENTS", N_ENVS, "TENSORBOARD_DIR", "", "VERBOSE", False, "LOG_FILE", os.path.join(tmp, "run.log"),
        "CUDA.ON_DEVICE_DAGGER", True, "CUDA.DAGGER_RESIDENT", True, "IL.load_from_ckpt", False,
        "IL.DAGGER.iterations", TRAIN_ITERATIONS, "IL.DAGGER.update_size", TRAIN_EPISODES, "IL.epochs", TRAIN_EPOCHS,
        "IL.batch_size", TRAIN_B,
    ]


def phase_device_dagger_resident(dev, wired):
    """`run_exp(cma_pm_da_aug_tune.yaml, "train")` at phase_device_dagger's
    sizes and seed with CUDA.DAGGER_RESIDENT: the collected rows stay on the
    card in the trajectory bank, the train batches are gathered there (no
    upload, no store). Three runs: (a) per batch; (b) with
    RESIDENT_EPOCH_SCAN, each run of an epoch's batches enqueued under
    set_sync_debug_mode("error") and read back once; (c) with
    DAGGER_ARCHIVE_STORE, whose store must hold the bank's rows. (a)'s losses
    against phase_device_dagger's (the same episodes, draws and batches) and
    (b)'s against (a)'s within RESIDENT_LOSS_RTOL."""
    from vlnce_torch.data.device_bank import DeviceTrajectoryBank
    from vlnce_torch.data.trajectory_store import TrajectoryStoreReader
    from vlnce_torch.run import run_exp
    from vlnce_torch.trainers.dagger_trainer import DaggerTrainer

    out, results = {}, {}
    with tempfile.TemporaryDirectory(prefix="vlnce_torch_smoke_") as tmp:
        for name, extra in (("device_dagger_resident", []),
                            ("device_dagger_resident_scan", ["CUDA.RESIDENT_EPOCH_SCAN", True]),
                            ("device_dagger_resident_archive", ["CUDA.DAGGER_ARCHIVE_STORE", True])):
            scan = name.endswith("_scan")
            store = os.path.join(tmp, name, "trajectories")
            opts = _resident_opts(tmp) + extra + ["CHECKPOINT_FOLDER", os.path.join(tmp, name, "checkpoints"),
                                                  "IL.DAGGER.lmdb_features_dir", store]
            epochs, runs, per_batch = [], [], []
            real_epoch, real_enqueue, real_update = (DaggerTrainer._run_fused_epoch, DeviceTrajectoryBank.enqueue_steps,
                                                     DaggerTrainer._update_agent)

            def counted_enqueue(self, step, idx, *args):
                runs.append(idx.shape[0])  # one run of K steps, one read-back
                return real_enqueue(self, step, idx, *args)

            def timed_epoch(self, riter):
                t0 = time.perf_counter()
                triples = real_epoch(self, riter)  # ends in the last run's read-back
                epochs.append((time.perf_counter() - t0, len(triples)))
                return triples

            def timed_update(self, *args, **kwargs):
                t0 = time.perf_counter()
                triple = real_update(self, *args, **kwargs)  # ends in the step's read-back
                per_batch.append(time.perf_counter() - t0)
                return triple

            DaggerTrainer._run_fused_epoch, DaggerTrainer._update_agent = timed_epoch, timed_update
            DeviceTrajectoryBank.enqueue_steps = counted_enqueue
            DaggerTrainer.time_train_steps = not scan
            torch.cuda.reset_peak_memory_stats()
            _reset_launches()
            t0 = time.perf_counter()
            try:
                with sync_checked(*([(DeviceTrajectoryBank, "enqueue_steps")] if scan else [])):
                    trainer = run_exp(R2R_EXP, "train", opts)
            finally:
                DaggerTrainer._run_fused_epoch, DaggerTrainer._update_agent = real_epoch, real_update
                DeviceTrajectoryBank.enqueue_steps = real_enqueue
                DaggerTrainer.time_train_steps = False
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _read_launches()
            rounds, history, bank = trainer.collection_stats, trainer.loss_history, trainer._bank
            steps = len(history)
            assert steps > 0 and all(r["graph"] and r["chunk_readbacks"] == 0 for r in rounds), rounds
            assert launches == {"gru_sequence": 3 * 2 + 2 * steps, "gru_sequence_backward": 2 * steps,
                                "gru_weight_gradient": 2 * steps, "fused_resize_normalize": 0}, (name, launches)
            assert _cluster_launches() == 2 * steps, "B1's backward did not take the cluster route"
            assert len(bank) == TRAIN_ITERATIONS * TRAIN_EPISODES and bank.device.type == "cuda"
            losses = np.array([h[2:] for h in history])
            assert np.isfinite(losses).all(), "non-finite training loss"
            print(f"{name}: run_exp {wall:.1f} s; launches {json.dumps(launches)} (the collection graph's probe, "
                  f"warm-up and capture, then 2 + 2 + 2 per train step over {steps} train steps, the backward on the "
                  f"cluster route); bank of {len(bank)} episodes, {bank.num_steps} steps, {bank.nbytes() / 2**20:.1f} MiB "
                  f"on the card ({bank.nbytes() / bank.num_steps / 1e6:.4f} MB a step: "
                  + ", ".join(f"{k} {tuple(v)} {bank.data[k].dtype}" for k, v in bank.feat_shapes.items())
                  + f"); peak card memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            for r, w in zip(rounds, wired["rounds"]):
                print(f"{name} collection round {r['data_it']} (beta {r['beta']}): {r['episodes']} episodes, "
                      f"{r['env_steps']} env steps, {r['segments']} segments, {r['readbacks']} read-backs of the done "
                      f"flags, {r['chunk_readbacks']} of rows; {r['env_steps'] / r['seconds']:.1f} env-steps/s "
                      f"({r['seconds']:.3f} s), {r['env_steps'] / r['total_time']:.1f} with the bank's assembly "
                      f"({r['total_time']:.3f} s); store-wired (phase_device_dagger, this run) "
                      f"{w['env_steps'] / w['seconds']:.1f} and {w['env_steps'] / w['total_time']:.1f} with the store's writes")
            results[name] = (trainer, losses)
            if scan:
                per_epoch = [1e3 * s / n for s, n in epochs]
                n_epochs = TRAIN_ITERATIONS * TRAIN_EPOCHS
                assert len(epochs) == n_epochs and sum(n for _, n in epochs) == steps
                print(f"{name}: the enqueued epochs {', '.join(f'{ms:.2f}' for ms in per_epoch)} ms per batch "
                      f"(batches {[n for _, n in epochs]}); {len(runs)} read-backs in {n_epochs} epochs (runs of K = {runs}), "
                      f"under set_sync_debug_mode('error')")
            else:
                clock = trainer.step_clock.totals()
                first = dict(trainer.step_clock.first)
                warm = {k: (clock[k] - first[k]) / (steps - 1) for k in clock}
                order = ("upload", "forward", "backward", "optimizer")
                print(f"{name}: train step by CUDA events, mean of the {steps - 1} steps after the first: "
                      f"{sum(warm.values()):.2f} ms = " + ", ".join(f"{k} {warm[k]:.2f}" for k in order)
                      + f" ms; per batch on the host clock (the gather, the step, its read-back) "
                      f"{1e3 * np.mean(per_batch[1:]):.2f} ms after the first, {steps} read-backs in "
                      f"{TRAIN_ITERATIONS * TRAIN_EPOCHS} epochs; T values {json.dumps(trainer.train_lengths, sort_keys=True)}")
            if name.endswith("_archive"):
                reader = TrajectoryStoreReader(store)
                assert len(reader) == len(bank)
                data = {k: v.float().cpu().numpy() for k, v in bank.data.items()}
                prev, oracle = bank.prev.cpu().numpy(), bank.oracle.cpu().numpy()
                for e in range(len(bank)):
                    obs, p, o = reader.get(e)
                    lo, T = int(bank.offsets[e]), int(bank.lengths[e])
                    assert np.array_equal(p, prev[lo : lo + T]) and np.array_equal(o, oracle[lo : lo + T]), e
                    for k, shape in bank.feat_shapes.items():
                        assert np.array_equal(obs[k].astype(np.float32), data[k][lo : lo + T].reshape((T,) + shape)), (e, k)
                reader.close()
                print(f"{name}: the store holds the bank's {len(bank)} episodes row for row")
            out[name] = launches

        # the same bank and weights, one epoch at a time, in turns: per batch (each step read back, as
        # _il_update does) and enqueued (one read-back per run)
        from vlnce_torch.data.device_bank import ResidentBatchIterator, run_fused_epoch
        from vlnce_torch.parallel.il_step import build_il_train_step

        trainer = results["device_dagger_resident"][0]
        step = build_il_train_step(trainer.policy, trainer.optimizer)
        turns = {"per_batch": [], "enqueued": []}
        for turn in ("per_batch", "enqueued", "enqueued", "per_batch") * 2:
            riter = ResidentBatchIterator(trainer._bank, batch_size=TRAIN_B, seed=7, time_major=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if turn == "per_batch":
                n = len([torch.stack(step(*batch)).tolist() for batch in riter])
            else:
                n = len(run_fused_epoch(riter, step))
            turns[turn].append(1e3 * (time.perf_counter() - t0) / n)
        print(f"device_dagger_resident: one epoch of {n} batches (T {sorted({trainer._bank.batch_T(b) for b in ResidentBatchIterator(trainer._bank, TRAIN_B, seed=7)._epoch_batches()})}) "
              f"in turns on the same bank: per batch with a read-back each "
              + ", ".join(f"{ms:.2f}" for ms in turns["per_batch"]) + " ms per batch; enqueued "
              + ", ".join(f"{ms:.2f}" for ms in turns["enqueued"]) + f" ms per batch; medians {np.median(turns['per_batch']):.2f} "
              f"and {np.median(turns['enqueued']):.2f}")

        wired_losses = np.array([h[2:] for h in wired["history"]])
        for name, ref_name, ref in (("device_dagger_resident", "phase_device_dagger", wired_losses),
                                    ("device_dagger_resident_scan", "device_dagger_resident", results["device_dagger_resident"][1]),
                                    ("device_dagger_resident_archive", "device_dagger_resident", results["device_dagger_resident"][1])):
            losses = results[name][1]
            assert losses.shape == ref.shape, (name, losses.shape, ref.shape)
            rel = np.abs(losses - ref) / np.maximum(np.abs(ref), 1e-6)
            round0 = np.array([h[0] == 0 for h in results[name][0].loss_history])
            print(f"{name} losses against {ref_name}'s: {losses.shape[0]} batches, largest relative difference "
                  f"{rel.max():.3e} (round 0: {rel[round0].max():.3e}); bound {RESIDENT_LOSS_RTOL}")
            assert rel.max() <= RESIDENT_LOSS_RTOL, (name, rel.max())
    return out


BANK_SCENES = 2  # scenes of the feature-bank phase's episodes, one bank each
BANK_SPACING, BANK_HEADINGS = 2.0, 24  # lattice meters (poses at most 1.41 m from a node); one bin per 15-degree turn


def phase_feature_bank(dev):
    """The feature-bank route at full width: the port's encode_scene_bank
    writes the banks of the synthetic scenes (the frozen ResNet50s of the
    seeded R2R CMA policy at every lattice node and heading bin), then
    `run_exp(cma_pm_da_aug_tune.yaml, "eval")` with EVAL.ON_DEVICE_SCAN and
    CUDA.FEATURE_BANK_DIR (one graph replay per step, the lookup in place of
    the renderer, B1 twice per step), held against the same rollouts run
    eagerly, beside the rendered scan eval of the same episodes."""
    from vlnce_torch.config import get_config
    from vlnce_torch.data.feature_bank import encode_scene_bank, lattice_nodes, save_scene_bank
    from vlnce_torch.envs.device_sim import camera_specs_from_config
    from vlnce_torch.envs.gridworld import get_scene
    from vlnce_torch.envs.spaces import action_space_from_config, observation_space_from_config
    from vlnce_torch.models.cma_policy import CMAPolicy
    from vlnce_torch.run import run_exp
    from vlnce_torch.tasks.datasets import make_dataset
    from vlnce_torch.trainers import scan_eval

    out = {}
    with tempfile.TemporaryDirectory(prefix="vlnce_torch_smoke_") as tmp:
        bank_dir = os.path.join(tmp, "banks")
        os.makedirs(bank_dir)
        common = [
            "TASK_CONFIG.DATASET.TYPE", "Synthetic-VLN-v0", "TASK_CONFIG.DATASET.NUM_SCENES", BANK_SCENES,
            "TASK_CONFIG.DATASET.NUM_EPISODES", 64, "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", 40,
            "TENSORBOARD_DIR", "", "VERBOSE", False, "LOG_FILE", os.path.join(tmp, "run.log"),
            "EVAL.ON_DEVICE_SCAN", True, "EVAL.SCAN_BATCH", N_ENVS, "EVAL.EPISODE_COUNT", N_ENVS,
            "EVAL.SAMPLE", False, "EVAL.USE_CKPT_CONFIG", False, "EVAL_CKPT_PATH_DIR", os.path.join(tmp, "none.pth"),
        ]
        cfg = get_config(R2R_EXP, common)
        eval_cfg = cfg.clone()
        eval_cfg.defrost()
        eval_cfg.TASK_CONFIG.DATASET.SPLIT = cfg.EVAL.SPLIT
        eval_cfg.freeze()
        episodes = list(make_dataset(eval_cfg.TASK_CONFIG.DATASET.TYPE, eval_cfg.TASK_CONFIG.DATASET).episodes)[:N_ENVS]
        # the seeded weights the eval starts from (no checkpoint): the same config gives the same draw
        policy = CMAPolicy.from_config(cfg, observation_space_from_config(cfg.TASK_CONFIG), action_space_from_config(cfg.TASK_CONFIG))
        specs = camera_specs_from_config(cfg.TASK_CONFIG.SIMULATOR)
        headings = (2.0 * np.pi / BANK_HEADINGS) * np.arange(BANK_HEADINGS, dtype=np.float32)
        _reset_launches()
        poses = chunks = 0
        encode_s = save_s = 0.0
        for scene_id in sorted({ep.scene_id for ep in episodes}):
            scene = get_scene(scene_id)
            nodes = lattice_nodes(scene, BANK_SPACING)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rgb, depth, rgb_shape, depth_shape = encode_scene_bank(policy, [], specs, scene, nodes, headings, chunk=256)
            t1 = time.perf_counter()  # the features are on the host: the card is done
            assert np.isfinite(rgb).all() and np.isfinite(depth).all()
            save_scene_bank(os.path.join(bank_dir, f"{os.path.splitext(os.path.basename(scene_id))[0]}.npz"), nodes, rgb,
                            depth, rgb_shape, depth_shape)
            encode_s, save_s = encode_s + t1 - t0, save_s + time.perf_counter() - t1
            poses += rgb.shape[0] * rgb.shape[1]
            chunks += -(-rgb.shape[0] * rgb.shape[1] // 256)
        out["feature_bank_encode"] = _read_launches()
        assert out["feature_bank_encode"] == {"gru_sequence": 2 * chunks, "gru_sequence_backward": 0, "gru_weight_gradient": 0,
                                              "fused_resize_normalize": 0}, out["feature_bank_encode"]
        print(f"feature bank: {len(os.listdir(bank_dir))} scene banks, {poses} poses ({BANK_SPACING} m lattice, "
              f"{BANK_HEADINGS} headings) encoded in {encode_s:.2f} s ({poses / encode_s:.1f} poses/s: the renderer and "
              f"the frozen ResNet50s at 224x224 and 256x256 in bf16, {chunks} chunks of at most 256, the features' "
              f"read-back), saved in {save_s:.2f} s; features {rgb_shape} and {depth_shape}, "
              f"{sum(os.path.getsize(os.path.join(bank_dir, f)) for f in os.listdir(bank_dir)) / 2**20:.1f} MiB of npz")
        del policy

        rates, recorded = {}, []
        real_rollouts = scan_eval.run_scan_rollouts

        def recording(policy, transforms, config, episodes, *args, **kwargs):
            actions = real_rollouts(policy, transforms, config, episodes, *args, **kwargs)
            recorded.append(((policy, transforms, config, episodes), actions))
            return actions

        for name, extra in (("rendered", []), ("feature_bank_scan_eval", ["CUDA.FEATURE_BANK_DIR", bank_dir,
                                                                         "CUDA.FEATURE_BANK_MAX_DIST", 1.5])):
            _reset_launches()
            scan_eval.run_scan_rollouts = recording
            try:
                evaluator = run_exp(R2R_EXP, "eval", common + extra + ["RESULTS_DIR", os.path.join(tmp, name)])
            finally:
                scan_eval.run_scan_rollouts = real_rollouts
            launches = _read_launches()
            t = _check_scan_run(evaluator, launches, (2, 0), name)
            with open(os.path.join(tmp, name, f"stats_ckpt_0_{cfg.EVAL.SPLIT}.json")) as f:
                stats = json.load(f)
            assert sorted(stats) == sorted(RXR_MEASURES) and all(math.isfinite(v) for v in stats.values()), stats
            rates[name] = t["env_steps"] / t["seconds"]
            print(f"{name} scan eval: {len(evaluator._last_eval_episode_stats)} episodes, {t['env_steps']} env steps in "
                  f"{t['segments']} segments of {t['seg_len']} at B={t['batch']}: {rates[name]:.1f} env-steps/s "
                  f"({t['seconds']:.3f} s: the chunks' host setup {t['setup_seconds']:.3f} s, the capture "
                  f"{t['capture_seconds']:.3f} s); stats {json.dumps({k: round(v, 4) for k, v in stats.items()})}")
            if extra:
                out[name] = launches
                args, graphed = recorded[-1]
                eager = real_rollouts(*args, eager=True)
                same = sum(np.array_equal(a, b) for a, b in zip(graphed, eager))
                print(f"{name}: the graphed rollouts against the same rollouts run eagerly: {same} of {len(eager)} "
                      f"episodes' actions equal; env-steps/s {rates[name]:.1f} with the bank, {rates['rendered']:.1f} rendered")
                assert same == len(eager), "the graphed bank route disagrees with its eager run"
    return out


# ---------------------------------------------------------------------------
# imported scene geometry: lattice scenes exported in a native frame away
# from the origin, run through every scene-consuming entry point
# ---------------------------------------------------------------------------

# scene id -> (x0, z0, width, depth): a 2 m lattice in the scene's own world
# frame; the rasterized grids are 168 and 104 cells a side (procedural: 64)
IMPORTED_SCENES = {
    "mp3d/imported_wide/imported_wide.glb": (-37.0, 11.0, 40.0, 30.0),
    "mp3d/imported_square/imported_square.glb": (14.0, -52.0, 24.0, 24.0),
}
IMPORTED_GOALS = 8  # goal nodes per scene: each one Dijkstra field in the chunks' host setup
IMPORTED_BANK_HEADINGS = 8  # bins of the banks (a bank is nodes x headings poses of ResNet features)
IMPORTED_BANK_B = 4  # the bank scan eval's SCAN_BATCH: 8 episodes, one chunk per scene


def _register_imported_dataset():
    """The dataset type `ImportedLattice-v0`: NUM_EPISODES episodes over the
    IMPORTED_SCENES, scene after scene, each starting at a random graph node
    and heading for one of IMPORTED_GOALS goal nodes at least 6 m away (as
    tests/test_scene_import.py:_lattice_episodes builds them), with the
    synthetic dataset's random instructions."""
    from vlnce_torch.registry import registry
    from vlnce_torch.tasks.datasets import SyntheticVLNDataset
    from vlnce_torch.tasks.episodes import InstructionData, NavigationGoal, VLNEpisode
    from vlnce_torch.tasks.geometry import quat_from_heading
    from vlnce_torch.tasks.vocab import VocabDict
    from vlnce_torch.utils.nav_graph import LatticeGraph

    class ImportedLatticeDataset(SyntheticVLNDataset):
        def _load(self, config) -> None:
            self.instruction_vocab = VocabDict(self.VOCAB_WORDS)
            n = int(config.NUM_EPISODES)
            per = -(-n // len(IMPORTED_SCENES))
            for k, (scene_id, box) in enumerate(IMPORTED_SCENES.items()):
                rng = np.random.RandomState(100 + k)
                nodes = np.array([d["position"] for d in LatticeGraph(*box).nodes.values()])
                goals = nodes[rng.choice(len(nodes), IMPORTED_GOALS, replace=False)]
                for i in range(per):
                    goal = goals[i % IMPORTED_GOALS]
                    far = nodes[np.hypot(*(nodes - goal)[:, [0, 2]].T) >= 6.0]
                    start = far[rng.randint(len(far))]
                    tokens = [int(rng.randint(2, len(self.VOCAB_WORDS))) for _ in range(int(rng.randint(8, 30)))]
                    self.episodes.append(VLNEpisode(
                        episode_id=str(len(self.episodes)), trajectory_id=str(len(self.episodes)), scene_id=scene_id,
                        start_position=[float(x) for x in start],
                        start_rotation=[float(x) for x in quat_from_heading(rng.uniform(0, 2 * np.pi))],
                        instruction=InstructionData(instruction_text=" ".join(self.instruction_vocab.idx2word(t) for t in tokens),
                                                    instruction_tokens=tokens),
                        goals=[NavigationGoal(position=[float(x) for x in goal], radius=3.0)],
                        reference_path=[[float(x) for x in start], [float(x) for x in goal]],
                        info={"geodesic_distance": float(np.hypot(*(start - goal)[[0, 2]]))},
                    ))
            self.episodes = self.episodes[:n]

    registry.register_dataset(ImportedLatticeDataset, name="ImportedLattice-v0")


def _assert_imported():
    """Every scene the phase ran is an export in a frame away from the
    origin: a missing export would fall back to the procedural scene."""
    from vlnce_torch.envs.gridworld import get_scene
    from vlnce_torch.envs.scene_import import ImportedScene

    for scene_id in IMPORTED_SCENES:
        scene = get_scene(scene_id)
        assert isinstance(scene, ImportedScene) and scene.origin != (0.0, 0.0), (scene_id, type(scene).__name__)


def phase_imported_scenes(dev):
    """Imported scene geometry at full width. Two lattice scenes are
    exported in their own world frames away from the origin (the port's
    scene_from_graph and save_scene_geometry); then, through
    TASK_CONFIG.SIMULATOR.GEOMETRY_DIR only:
    1. RxR CMA scan eval (rxr_cma_en.yaml: 480x640 frames, bf16, H=512) over
       64 episodes of at most 40 steps, SCAN_BATCH 32: one chunk per scene,
       so one graph per grid size, B1 and B2 twice per step inside it;
    2. the banks of both scenes at the graphs' nodes by
       `python -m vlnce_torch.scripts.generate_feature_bank`'s main (the
       seeded R2R CMA policy's frozen ResNet50s), then the R2R CMA scan eval
       that looks the features up in place of rendering, held against the
       same rollouts run eagerly;
    3. the graphed RxR step against the eager step with the plain versions
       on one chunk of both imported scenes (padded to the larger grid);
    4. one nonlearning eval (HandcraftedAgent, host only: no kernel runs)."""
    import pickle as _pickle

    from vlnce_torch.config import get_config
    from vlnce_torch.envs.scene_import import _scene_stem, save_scene_geometry, scene_from_graph
    from vlnce_torch.envs.spaces import action_space_from_config, observation_space_from_config
    from vlnce_torch.models.cma_policy import CMAPolicy
    from vlnce_torch.run import run_exp
    from vlnce_torch.scripts.generate_feature_bank import main as generate_feature_bank
    from vlnce_torch.tasks.datasets import make_dataset
    from vlnce_torch.trainers import scan_eval
    from vlnce_torch.utils.checkpoints import save_checkpoint
    from vlnce_torch.utils.nav_graph import LatticeGraph

    _register_imported_dataset()
    out = {}
    with tempfile.TemporaryDirectory(prefix="vlnce_torch_smoke_") as tmp:
        geometry = os.path.join(tmp, "geometry")
        t0 = time.perf_counter()
        graphs, grids = {}, []
        for scene_id, box in IMPORTED_SCENES.items():
            stem = _scene_stem(scene_id)
            graphs[stem] = LatticeGraph(*box)
            scene = scene_from_graph(stem, graphs[stem])
            save_scene_geometry(os.path.join(geometry, f"{stem}.npz"), scene)
            grids.append(f"{stem}: {len(graphs[stem].nodes)} nodes, {scene.n}x{scene.n} cells "
                         f"({100 * float((~scene.occupancy).mean()):.1f}% free) at origin {scene.origin}")
        print(f"imported scenes exported in {time.perf_counter() - t0:.3f} s: " + "; ".join(grids))
        common = [
            "TASK_CONFIG.DATASET.TYPE", "ImportedLattice-v0", "TASK_CONFIG.SIMULATOR.GEOMETRY_DIR", geometry,
            "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", SCAN_STEPS, "TENSORBOARD_DIR", "", "VERBOSE", False,
            "LOG_FILE", os.path.join(tmp, "run.log"), "EVAL.USE_CKPT_CONFIG", False,
        ]

        # 1. RxR CMA scan eval over both scenes
        cfg, policy, _ = build_act_step(dev, "bfloat16")
        rxr_ckpt = os.path.join(tmp, "rxr.pth")
        save_checkpoint(rxr_ckpt, policy.state_dict(), config=cfg)
        del policy
        _reset_launches()
        t0 = time.perf_counter()
        trainer = run_exp(EXP, "eval", common + [
            "TASK_CONFIG.DATASET.NUM_EPISODES", SCAN_EPISODES, "EVAL.EPISODE_COUNT", SCAN_EPISODES,
            "EVAL.ON_DEVICE_SCAN", True, "EVAL.SCAN_BATCH", SCAN_B, "EVAL.SCAN_SEGMENT", SCAN_SEGMENT,
            "EVAL_CKPT_PATH_DIR", rxr_ckpt, "RESULTS_DIR", os.path.join(tmp, "evals"),
        ])
        wall = time.perf_counter() - t0
        out["imported_scan_eval"] = launches = _read_launches()
        _assert_imported()
        t = trainer.last_loop_timing
        captures = t["captures"]
        assert captures == len(IMPORTED_SCENES) and t["graph"], t  # one graph per grid size
        assert t["capture_launches"] == _recorded(gru_sequence=2, fused_resize_normalize=2), t
        assert launches == {"gru_sequence": 4 * captures, "gru_sequence_backward": 0, "gru_weight_gradient": 0,
                            "fused_resize_normalize": 4 * captures}, launches
        assert t["readbacks"] == t["segments"] and t["replays"] == t["segments"] * t["seg_len"], t
        with open(os.path.join(tmp, "evals", f"stats_ckpt_0_{cfg.EVAL.SPLIT}.json")) as f:
            stats = json.load(f)
        assert sorted(stats) == sorted(RXR_MEASURES) and all(math.isfinite(v) for v in stats.values()), stats
        assert len(trainer._last_eval_episode_stats) == SCAN_EPISODES
        loop_s = t["seconds"] - t["capture_seconds"]
        print(f"imported scan eval (RxR CMA, bf16, B={t['batch']}): {SCAN_EPISODES} episodes, {t['env_steps']} env steps; "
              f"{captures} graphs captured (one per grid size) in {t['capture_seconds']:.3f} s (warm-ups included), "
              f"{t['capture_launches']} launches per step; B1 and B2 launches counted {launches['gru_sequence']} and "
              f"{launches['fused_resize_normalize']} (a warm-up and a capture per graph); {t['segments']} segments of "
              f"{t['seg_len']} steps, {t['readbacks']} read-backs, {t['replays']} replays")
        print(f"imported scan eval env-steps/s: {t['env_steps'] / loop_s:.1f} ({loop_s:.3f} s after the captures, of which "
              f"the chunks' host setup {t['setup_seconds']:.3f} s and the segments {loop_s - t['setup_seconds']:.3f} s); "
              f"{t['env_steps'] / t['seconds']:.1f} with the captures; host replay of the measures "
              f"{t['replay_seconds']:.3f} s; run_exp {wall:.2f} s; stats {json.dumps({k: round(v, 4) for k, v in stats.items()})}")
        # the larger grid's segment replayed again under the profiler: B1 and B2 ran 2 x seg_len times
        segment = max((v for k, v in scan_eval.policy_cache(trainer.policy).items() if k[0] == "eval"),
                      key=lambda v: v.scenes.occupancy.shape[1])
        segment.load(segment.scenes, segment.instruction, segment.pos.clone(), segment.heading.clone())
        seg_ms, busy, counts = trace_segment(lambda: segment.run(trainer.generator))
        n1, n2 = _kernel_count(counts, "gru_sequence_kernel"), _kernel_count(counts, "resize_normalize_kernel")
        print(f"imported scan eval segment under the profiler (grid {tuple(segment.scenes.occupancy.shape[1:])}): "
              f"{seg_ms:.2f} ms for {segment.seg_len} steps at B={segment.B}, device busy {busy:.2f} ms, idle share "
              f"{max(0.0, 1 - busy / seg_ms):.1%}; B1 kernels {n1}, B2 kernels {n2} (2 x {segment.seg_len} each)")
        # a graph without a kernel would miss it in each of the seg_len replays;
        # the profiler may lose an activity record (one B1 record of 80 here once)
        assert all(2 * segment.seg_len - 2 <= n <= 2 * segment.seg_len for n in (n1, n2)), (n1, n2, segment.seg_len)
        del trainer, segment

        # 2. the feature banks at the graphs' nodes, then the bank route's scan eval
        r2r_cfg = get_config(R2R_EXP, ["CUDA.DEVICE", str(dev)])
        policy = CMAPolicy.from_config(r2r_cfg, observation_space_from_config(r2r_cfg.TASK_CONFIG),
                                       action_space_from_config(r2r_cfg.TASK_CONFIG))
        r2r_ckpt = os.path.join(tmp, "r2r.pth")
        save_checkpoint(r2r_ckpt, policy.state_dict(), config=r2r_cfg)
        del policy
        graphs_file, bank_dir = os.path.join(tmp, "graphs.pkl"), os.path.join(tmp, "banks")
        with open(graphs_file, "wb") as f:
            _pickle.dump(graphs, f)
        bank_opts = common + ["TASK_CONFIG.DATASET.NUM_EPISODES", 2 * IMPORTED_BANK_B]
        _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generate_feature_bank([str(a) for a in [
            "--exp-config", R2R_EXP, "--bank-dir", bank_dir, "--headings", IMPORTED_BANK_HEADINGS, "--chunk", 256,
            "--connectivity", graphs_file, *bank_opts, "IL.load_from_ckpt", True, "IL.ckpt_to_load", r2r_ckpt]])
        bank_s = time.perf_counter() - t0
        out["imported_bank_encode"] = encode = _read_launches()
        poses = sum(len(g.nodes) for g in graphs.values()) * IMPORTED_BANK_HEADINGS
        chunks = sum(-(-len(g.nodes) * IMPORTED_BANK_HEADINGS // 256) for g in graphs.values())
        assert encode == {"gru_sequence": 2 * chunks, "gru_sequence_backward": 0, "gru_weight_gradient": 0,
                          "fused_resize_normalize": 0}, encode
        bank_mib = sum(os.path.getsize(os.path.join(bank_dir, f)) for f in os.listdir(bank_dir)) / 2**20
        print(f"imported feature banks: {sorted(os.listdir(bank_dir))}, {poses} poses at the graphs' nodes "
              f"({IMPORTED_BANK_HEADINGS} headings) in {bank_s:.2f} s by generate_feature_bank (the trainer's set-up, the "
              f"render and the frozen ResNet50s in bf16, {chunks} chunks, the npz writes), {bank_mib:.1f} MiB of npz")

        recorded = []
        real_rollouts = scan_eval.run_scan_rollouts

        def recording(*args, **kwargs):
            actions = real_rollouts(*args, **kwargs)
            recorded.append((args, actions))
            return actions

        _reset_launches()
        scan_eval.run_scan_rollouts = recording
        try:
            evaluator = run_exp(R2R_EXP, "eval", bank_opts + [
                "EVAL.ON_DEVICE_SCAN", True, "EVAL.SCAN_BATCH", IMPORTED_BANK_B, "EVAL.EPISODE_COUNT", 2 * IMPORTED_BANK_B,
                "EVAL.SAMPLE", False, "CUDA.FEATURE_BANK_DIR", bank_dir, "CUDA.FEATURE_BANK_MAX_DIST", 1.5,
                "EVAL_CKPT_PATH_DIR", r2r_ckpt, "RESULTS_DIR", os.path.join(tmp, "bank_evals"),
            ])
        finally:
            scan_eval.run_scan_rollouts = real_rollouts
        out["imported_bank_scan_eval"] = launches = _read_launches()
        t = evaluator.last_loop_timing
        assert t["graph"] and t["captures"] == len(IMPORTED_SCENES) and t["capture_launches"] == _recorded(
            gru_sequence=2), t
        assert launches == {"gru_sequence": 4 * t["captures"], "gru_sequence_backward": 0, "gru_weight_gradient": 0,
                            "fused_resize_normalize": 0}, launches
        args, graphed = recorded[-1]
        eager = real_rollouts(*args, eager=True)
        same = sum(np.array_equal(a, b) for a, b in zip(graphed, eager))
        print(f"imported bank scan eval (R2R CMA, bf16, B={t['batch']}): {len(evaluator._last_eval_episode_stats)} "
              f"episodes, {t['env_steps']} env steps in {t['seconds']:.3f} s ({t['env_steps'] / t['seconds']:.1f} env-steps/s; "
              f"the chunks' host setup with the bank loads {t['setup_seconds']:.3f} s, {t['captures']} captures "
              f"{t['capture_seconds']:.3f} s); the graphed rollouts against the same run eagerly: {same} of {len(eager)} "
              f"episodes' actions equal")
        assert same == len(eager), "the graphed bank route disagrees with its eager run"
        del evaluator

        # 3. the graphed step against the eager plain step on a chunk of both scenes
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        cfg, policy, _ = build_act_step(dev, "float32")
        task_cfg = get_config(EXP, common + ["TASK_CONFIG.DATASET.NUM_EPISODES", 8]).TASK_CONFIG
        episodes = list(make_dataset(task_cfg.DATASET.TYPE, task_cfg.DATASET).episodes)
        assert len({ep.scene_id for ep in episodes}) == len(IMPORTED_SCENES)
        _scan_against_plain(dev, cfg, policy, task_cfg, episodes, 12, "imported scan")
        del policy

        # 4. a nonlearning eval on the imported scenes: host only
        _reset_launches()
        t0 = time.perf_counter()
        run_exp("vlnce_torch/config/experiments/r2r_baselines/nonlearning.yaml", "eval", common + [
            "TASK_CONFIG.DATASET.NUM_EPISODES", 4, "EVAL.EPISODE_COUNT", 4, "EVAL.NONLEARNING.AGENT", "HandcraftedAgent",
            "RESULTS_DIR", os.path.join(tmp, "nonlearning")])
        assert set(_read_launches().values()) == {0}, "a kernel ran in the nonlearning eval"
        with open(os.path.join(tmp, "nonlearning", "stats_HandcraftedAgent_val_unseen.json")) as f:
            stats = json.load(f)
        assert all(math.isfinite(v) for v in stats.values()) and stats["path_length"] > 0, stats
        print(f"nonlearning eval (HandcraftedAgent, 4 episodes on the imported scenes, host only) in "
              f"{time.perf_counter() - t0:.2f} s: {json.dumps({k: round(v, 4) for k, v in stats.items()})}")
        _assert_imported()
    return out


# ---------------------------------------------------------------------------
# the asset-day parity check (vlnce_torch/scripts/eval_parity.py) on the
# imported lattice scenes: host loop, then the scan eval on the card
# ---------------------------------------------------------------------------

PARITY_R2R_EXP = "vlnce_torch/config/experiments/r2r_baselines/cma_pm_da.yaml"  # eval_parity's usage
PARITY_EPISODES = 8  # per stage: 4 on each imported scene, one chunk per scene
PARITY_STEPS = 30  # TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS, cut from 500
PARITY_N = 2  # the host stage's workers: one per scene
PARITY_SCAN_B = 4  # the scan stage's EVAL.SCAN_BATCH: one chunk per scene, padded to its own grid


def _decisive_checkpoint(path, cfg, policy):
    """Save `policy` with its action head at unit gain and STOP's logit
    biased by -3. The seeded head (orthogonal, gain 0.01) gives logits of
    about 5e-3 whose greedy choice is STOP at the first step, and whose gaps
    are of the size of bf16 rounding; at unit gain (as the port's tests
    perturb it, tests/torch_port_cases.py) the greedy actions vary along a
    path and are decided by margins a trained head shows, and the bias (as in
    phase_video) lets the episodes run past their first step."""
    from vlnce_torch.utils.checkpoints import save_checkpoint

    head = policy.action_distribution.linear
    with torch.no_grad():
        head.weight.mul_(100.0)
        head.bias.zero_()
        head.bias[0] = -3.0  # STOP is action 0 of R2R's 4 and RxR's 6
    save_checkpoint(path, policy.state_dict(), config=cfg)


@contextlib.contextmanager
def _parity_stages(eager: bool = False):
    """Per call of eval_parity's stages (BaseVLNCETrainer._eval_checkpoint):
    the launch counts (set to 0 just before, read just after), the loop's
    clocks and the wall time; per sibling script eval_parity runs, its
    seconds; and per episode the actions of the host loop (read where it
    steps its envs, with the episodes of its own last current_episodes call)
    and of the scan eval's rollouts, which run without a graph if `eager`."""
    from vlnce_torch.envs.vector_env import VectorEnv
    from vlnce_torch.scripts import eval_parity
    from vlnce_torch.trainers import base_trainer, scan_eval

    rec = {"stages": [], "scripts": {}, "host": {}, "scan": {}}
    real = (base_trainer.BaseVLNCETrainer._eval_checkpoint, eval_parity._run_script, VectorEnv.current_episodes,
            base_trainer._ActLoop.step_envs, scan_eval.run_scan_rollouts)

    def eval_checkpoint(self, *args, **kwargs):
        _reset_launches()
        t0 = time.perf_counter()
        stats = real[0](self, *args, **kwargs)
        wall = time.perf_counter() - t0
        rec["stages"].append({"scan": bool(self.config.EVAL.ON_DEVICE_SCAN), "launches": _read_launches(),
                              "timing": dict(self.last_loop_timing), "wall": wall, "stats": stats,
                              "on_card": {p.device.type for p in self.policy.parameters()} == {"cuda"}})
        return stats

    def run_script(main_fn, module, argv, logger):
        _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real[1](main_fn, module, argv, logger)
        torch.cuda.synchronize()
        rec["scripts"][module.rsplit(".", 1)[-1]] = {"seconds": time.perf_counter() - t0, "launches": _read_launches()}

    def current_episodes(self):
        self.last_episodes = real[2](self)
        return self.last_episodes

    def step_envs(self, envs, active_ids, actions_np):
        for i in active_ids:
            rec["host"].setdefault(envs.last_episodes[i].episode_id, []).append(int(actions_np[i]))
        return real[3](self, envs, active_ids, actions_np)

    def run_scan_rollouts(policy, transforms, config, episodes, *args, **kwargs):
        seqs = real[4](policy, transforms, config, episodes, *args, eager=eager, **kwargs)
        rec["scan"].update({ep.episode_id: [int(a) for a in seq] for ep, seq in zip(episodes, seqs)})
        return seqs

    base_trainer.BaseVLNCETrainer._eval_checkpoint = eval_checkpoint
    eval_parity._run_script = run_script
    VectorEnv.current_episodes = current_episodes
    base_trainer._ActLoop.step_envs = step_envs
    scan_eval.run_scan_rollouts = run_scan_rollouts
    try:
        yield rec
    finally:
        (base_trainer.BaseVLNCETrainer._eval_checkpoint, eval_parity._run_script, VectorEnv.current_episodes,
         base_trainer._ActLoop.step_envs, scan_eval.run_scan_rollouts) = real


def _run_parity(argv, what, per_act_step, plain: bool = False):
    """`eval_parity.main(argv)`: returns its exit code, its log lines and
    the records of `_parity_stages`. Each stage's launches are checked: the
    host stage `per_act_step` (B1, B2) per act step, the scan stage the
    warm-up's and the capture's of each graph (one per grid size). With
    `plain` the plain versions of B1 and B2 are swapped in and the scan
    stage runs eagerly: no stage launches a kernel."""
    from vlnce_torch.scripts.eval_parity import main as eval_parity
    from vlnce_torch.utils.logging import logger

    import logging

    lines = []

    class Lines(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    handler = Lines()
    logger.addHandler(handler)
    try:
        with plain_versions() if plain else contextlib.nullcontext(), _parity_stages(eager=plain) as rec:
            t0 = time.perf_counter()
            rc = eval_parity([str(a) for a in argv])
            rec["seconds"] = time.perf_counter() - t0
    finally:
        logger.removeHandler(handler)
    b1, b2 = per_act_step
    for stage in rec["stages"]:
        t, launches = stage["timing"], stage["launches"]
        assert stage["on_card"], f"{what}: the policy is not on the card"
        if stage["scan"]:
            if plain:
                assert not t["graph"] and t["captures"] == 0 and not any(launches.values()), (what, t, launches)
            else:
                assert t["graph"] and t["capture_launches"] == _recorded(gru_sequence=b1, fused_resize_normalize=b2), \
                    (what, t)
                assert launches == {"gru_sequence": 2 * b1 * t["captures"], "gru_sequence_backward": 0,
                                    "gru_weight_gradient": 0, "fused_resize_normalize": 2 * b2 * t["captures"]}, (what, launches)
            assert t["readbacks"] == t["segments"] and t["replays"] == t["segments"] * t["seg_len"], (what, t)
            rate = t["env_steps"] / t["seconds"]
            print(f"{what} resident stage (scan eval on the card, B={t['batch']}): {t['env_steps']} env steps in "
                  f"{t['seconds']:.3f} s, {rate:.1f} env-steps/s ({t['captures']} graphs captured in "
                  f"{t['capture_seconds']:.3f} s, the chunks' host setup {t['setup_seconds']:.3f} s); host replay of the "
                  f"measures {t['replay_seconds']:.3f} s; the stage {stage['wall']:.2f} s; launches {json.dumps(launches)}")
        else:
            assert t["act_steps"] > 0 and launches == {"gru_sequence": b1 * t["act_steps"], "gru_sequence_backward": 0,
                                                       "gru_weight_gradient": 0,
                                                       "fused_resize_normalize": b2 * t["act_steps"]}, (what, launches, t)
            rate = t["env_steps"] / t["total_time"]
            print(f"{what} host stage (N={PARITY_N} forked workers): {t['act_steps']} act steps, {t['env_steps']} env "
                  f"steps in {t['total_time']:.3f} s, {rate:.1f} env-steps/s (act {t['pth_time']:.3f} s, envs "
                  f"{t['env_time']:.3f} s); the stage {stage['wall']:.2f} s; launches {json.dumps(launches)}")
        stage["rate"] = rate
    for name, s in rec["scripts"].items():
        print(f"{what} {name}: {s['seconds']:.3f} s, launches {json.dumps(s['launches'])}")
    return rc, lines, rec


def _parity_agreement(first, second, what):
    """Per episode, the actions of one loop (`first`: episode id -> actions)
    against another's: the episodes equal, and for the others the first
    step where they part."""
    assert sorted(first) == sorted(second) and len(second) == PARITY_EPISODES, (sorted(first), sorted(second))
    differ = {ep: next(t for t, (a, b) in enumerate(zip(first[ep] + [None], second[ep] + [None])) if a != b)
              for ep in second if first[ep] != second[ep]}
    steps = [len(seq) for seq in second.values()]
    print(f"{what}: actions equal in {len(second) - len(differ)} of {len(second)} episodes (steps per episode "
          f"{min(steps)} to {max(steps)}, actions used {sorted({a for s in second.values() for a in s})})"
          + (f"; episodes and the first step where they part: {json.dumps(differ)}" if differ else ""))
    return differ


def phase_eval_parity(dev):
    """The asset-day parity check, `python -m vlnce_torch.scripts.eval_parity`'s
    main, at the full widths of two YAMLs on phase_imported_scenes' two
    lattice scenes away from the origin, which eval_parity exports itself
    (--geometry-dir empty, --connectivity a pickle of the two graphs):
    (a) r2r_baselines/cma_pm_da.yaml (224x224 RGB and 256x256 depth
        ResNet50s, H=512, bf16), eval_parity's own usage, with --resident and
        --bank-dir: the geometry export, the banks at the graphs' nodes (8
        headings, encoded by the checkpoint's frozen encoders, which the
        opts name), the host loop over PARITY_N forked workers, then the
        bank route's scan eval. Its episodes legitimately part from the host
        loop's (features are looked up at the graph's nodes and headings),
        so it passes --resident-tolerance 2.0, as the JAX package's own dry
        run does (tests/test_scene_import.py:465);
    (b) rxr_baselines/rxr_cma_en.yaml (480x640 frames, bf16) with
        --resident on the same geometry (reused) and no bank, the
        instructions' features from seeded files: the rendered scan eval,
        with B2 in its graph, held against the host loop at eval_parity's
        default 0.02 (tests/test_torch_eval_parity.py shows the two loops'
        actions equal episode by episode on imported scenes on the CPU; on
        the card in bf16 they can part on a near-tie, ROADMAP §C). Then the
        driver again with the plain versions of B1 and B2 and the scan stage
        eager (phase_scan_against_plain's route): each stage's actions,
        episode by episode, and its stats must equal the kernels' run's;
    (c) (a)'s host stage with --expected-spl a full point (1.0) from the
        host SPL (a) measured: it must return 1 and log PARITY FAILED.
    Both stages are greedy over PARITY_EPISODES episodes of at most
    PARITY_STEPS steps, from checkpoints of the seeded policies made
    decisive by `_decisive_checkpoint`. B1 (and B2 in b) must launch in both
    stages, per act step on the host and in each graph's capture on the
    card; per episode the two loops' actions are printed against each
    other."""
    import pickle as _pickle

    from vlnce_torch.config import get_config
    from vlnce_torch.envs.scene_import import _scene_stem
    from vlnce_torch.envs.spaces import action_space_from_config, observation_space_from_config
    from vlnce_torch.models.cma_policy import CMAPolicy
    from vlnce_torch.utils.nav_graph import LatticeGraph

    _register_imported_dataset()
    out = {}
    with tempfile.TemporaryDirectory(prefix="vlnce_torch_smoke_") as tmp:
        graphs_file, geometry = os.path.join(tmp, "graphs.pkl"), os.path.join(tmp, "geometry")
        with open(graphs_file, "wb") as f:
            _pickle.dump({_scene_stem(s): LatticeGraph(*box) for s, box in IMPORTED_SCENES.items()}, f)
        common = [
            "TASK_CONFIG.DATASET.TYPE", "ImportedLattice-v0", "TASK_CONFIG.DATASET.NUM_EPISODES", PARITY_EPISODES,
            "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", PARITY_STEPS, "NUM_ENVIRONMENTS", PARITY_N,
            "EVAL.SAMPLE", False, "EVAL.SCAN_BATCH", PARITY_SCAN_B, "EVAL.SCAN_SEGMENT", PARITY_STEPS,
            "TENSORBOARD_DIR", "", "VERBOSE", False, "LOG_FILE", os.path.join(tmp, "run.log"),
        ]

        # (a) R2R CMA: export, banks, host loop, bank route
        cfg = get_config(PARITY_R2R_EXP, ["CUDA.DEVICE", str(dev)])
        torch.manual_seed(int(cfg.TASK_CONFIG.SEED))
        policy = CMAPolicy.from_config(cfg, observation_space_from_config(cfg.TASK_CONFIG),
                                       action_space_from_config(cfg.TASK_CONFIG))
        r2r_ckpt = os.path.join(tmp, "r2r.pth")
        _decisive_checkpoint(r2r_ckpt, cfg, policy)
        del policy
        rc, lines, rec = _run_parity([
            "--exp-config", PARITY_R2R_EXP, "--checkpoint", r2r_ckpt, "--resident", "--geometry-dir", geometry,
            "--connectivity", graphs_file, "--bank-dir", os.path.join(tmp, "banks"), "--bank-headings", IMPORTED_BANK_HEADINGS,
            "--resident-tolerance", 2.0, *common, "RESULTS_DIR", os.path.join(tmp, "r2r_evals"),
            "IL.load_from_ckpt", True, "IL.ckpt_to_load", r2r_ckpt,
        ], "eval parity (a) R2R CMA", (2, 0))
        _assert_imported()
        assert rc == 0 and lines[-1] == "PARITY OK", (rc, lines[-12:])
        assert [s["scan"] for s in rec["stages"]] == [False, True], rec["stages"]
        assert set(rec["scripts"]) == {"export_scene_geometry", "generate_feature_bank"}, rec["scripts"]
        assert rec["scripts"]["export_scene_geometry"]["launches"]["gru_sequence"] == 0
        assert sorted(os.listdir(os.path.join(tmp, "banks"))) == sorted(f"{_scene_stem(s)}.npz" for s in IMPORTED_SCENES)
        host_a, resident_a = rec["stages"][0], rec["stages"][1]
        for stats in (host_a["stats"], resident_a["stats"]):
            assert sorted(stats) == sorted(RXR_MEASURES) and all(math.isfinite(v) for v in stats.values()), stats
        print(f"eval parity (a): {sum(1 for ln in lines if ln.startswith('[resident-vs-host]'))} resident-vs-host checks "
              f"passed at 2.0; host {json.dumps({k: round(v, 4) for k, v in host_a['stats'].items()})}, resident "
              f"{json.dumps({k: round(v, 4) for k, v in resident_a['stats'].items()})}; eval_parity's run {rec['seconds']:.2f} s")
        _parity_agreement(rec["host"], rec["scan"], "eval parity (a), host loop against the bank route")
        out["eval_parity_r2r_host"], out["eval_parity_r2r_resident"] = host_a["launches"], resident_a["launches"]
        out["eval_parity_r2r_bank"] = rec["scripts"]["generate_feature_bank"]["launches"]
        assert out["eval_parity_r2r_bank"]["gru_sequence"] > 0

        # (b) RxR CMA: the same geometry, the rendered scan eval, B2 in both stages. The policy and the
        # instructions' features come from seeds: without a features file the RxR sensor draws them from
        # Python's str hash of the episode id, which is salted anew in every process
        torch.manual_seed(int(cfg.TASK_CONFIG.SEED))
        cfg, policy, _ = build_act_step(dev, "bfloat16")
        rxr_ckpt = os.path.join(tmp, "rxr.pth")
        _decisive_checkpoint(rxr_ckpt, cfg, policy)
        del policy
        features, dim = os.path.join(tmp, "rxr_features"), int(cfg.TASK_CONFIG.TASK.RXR_INSTRUCTION_SENSOR.feature_dim)
        os.makedirs(features)
        for i in range(PARITY_EPISODES):
            rng = np.random.RandomState(1000 + i)
            np.savez(os.path.join(features, f"{i}.npz"), features=rng.randn(rng.randint(8, 257), dim).astype(np.float32))
        rxr = common + ["TASK_CONFIG.TASK.RXR_INSTRUCTION_SENSOR.features_path", os.path.join(features, "{id}.npz")]
        rc, lines, rec = _run_parity([
            "--exp-config", EXP, "--checkpoint", rxr_ckpt, "--resident", "--geometry-dir", geometry, *rxr,
            "RESULTS_DIR", os.path.join(tmp, "rxr_evals"),
        ], "eval parity (b) RxR CMA", (2, 2))
        _assert_imported()
        assert rec["scripts"] == {} and "geometry: reusing " + geometry in lines, (rec["scripts"], lines[:4])
        differ = _parity_agreement(rec["host"], rec["scan"], "eval parity (b), host loop against the rendered route")
        assert rc == 0 and lines[-1] == "PARITY OK", (rc, differ, lines[-12:])
        assert [s["scan"] for s in rec["stages"]] == [False, True], rec["stages"]
        host_b, resident_b = rec["stages"][0], rec["stages"][1]
        print(f"eval parity (b): resident-vs-host at 0.02: "
              + "; ".join(ln for ln in lines if ln.startswith("[resident-vs-host]"))
              + f"; eval_parity's run {rec['seconds']:.2f} s")
        out["eval_parity_rxr_host"], out["eval_parity_rxr_resident"] = host_b["launches"], resident_b["launches"]

        # (b) again with the plain versions of B1 and B2 and the scan stage eager (the route of
        # phase_scan_against_plain): each stage's actions, episode by episode, and its stats equal the kernels'
        rc, lines, plain = _run_parity([
            "--exp-config", EXP, "--checkpoint", rxr_ckpt, "--resident", "--geometry-dir", geometry, *rxr,
            "RESULTS_DIR", os.path.join(tmp, "rxr_plain_evals"),
        ], "eval parity (b) plain versions", (0, 0), plain=True)
        assert rc == 0 and lines[-1] == "PARITY OK", (rc, lines[-12:])
        assert [s["scan"] for s in plain["stages"]] == [False, True], plain["stages"]
        for i, loop in enumerate(("host", "scan")):
            differ = _parity_agreement(rec[loop], plain[loop], f"eval parity (b), {loop} loop: kernels against plain versions")
            assert not differ and plain["stages"][i]["stats"] == rec["stages"][i]["stats"], (loop, differ)

        # (c) a full point off the host SPL of (a): exit 1, PARITY FAILED
        expected = host_a["stats"]["spl"] + 1.0
        rc, lines, rec = _run_parity([
            "--exp-config", PARITY_R2R_EXP, "--checkpoint", r2r_ckpt, "--expected-spl", expected,
            "--geometry-dir", geometry, *common, "RESULTS_DIR", os.path.join(tmp, "negative_evals"),
        ], "eval parity (c) negative", (2, 0))
        assert rc == 1 and lines[-1] == "PARITY FAILED for: ['host:spl']", (rc, lines[-6:])
        print(f"eval parity (c): --expected-spl {expected:.4f} returned {rc}: {lines[-2]}; {lines[-1]} (host stats "
              f"{'equal to' if rec['stages'][0]['stats'] == host_a['stats'] else 'other than'} (a)'s)")
        out["eval_parity_negative_host"] = rec["stages"][0]["launches"]
    return out


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


def _run_recollect(exp, train_opts, per_step, render_b2: bool = False):
    """`run_exp(exp, "train")` with the launch counters set to 0 just before
    and read just after; each kernel must have risen by `per_step` (B1, its
    backward, its weight gradient, B2) per train step (and, with
    `render_b2`, B2 by 2 x 3 per render graph: its probe step, warm-up and
    capture), and every backward must have taken the cluster route. Returns
    (trainer, launches, wall)."""
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
    expected = [n * steps for n in per_step]
    if render_b2:
        expected[3] += 2 * 3 * len(trainer.resimulation["capture_launches"])
    assert steps > 0 and list(launches.values()) == expected, (launches, steps)
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
    sim = trainer.resimulation
    return launches, eval_launches, sim["env_steps"] / sim["seconds"]


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
    host = {"rollout": r["env_steps"] / (r["rollout_time"] - r["first_act_time"]), "act_ms": warm_act_ms,
            "minibatch_ms": sum(warm.values()), "update_s": r["update_time"] / WP_UPDATES,
            "train": r["env_steps"] / (r["rollout_time"] + r["update_time"])}
    return launches, eval_launches, host


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


# ---------------------------------------------------------------------------
# the device-resident training paths: DD-PPO with the rollout on the card,
# and recollection rendered on the card
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def sync_checked(*methods):
    """Run each (class, name) method under torch.cuda.set_sync_debug_mode(
    "error"): anything inside it that waits for the card raises."""
    saved = [(cls, name, getattr(cls, name)) for cls, name in methods]

    def checked(method):
        def run(*args, **kwargs):
            previous = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                return method(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(previous)
        return run

    for cls, name, method in saved:
        setattr(cls, name, checked(method))
    try:
        yield
    finally:
        for cls, name, method in saved:
            setattr(cls, name, method)


def phase_device_waypoint(dev, host):
    """`run_exp(1-wpn-cc.yaml, "train")` with CUDA.ON_DEVICE_ROLLOUT at
    phase_waypoint's settings (N=4, T=16, 2 updates, ppo_epoch 2,
    num_mini_batch 4, bf16): no worker forked, each env step one replay of
    the captured step (B1 twice in it), the bootstrap value a second graph
    (B1 twice), one read-back per rollout, the PPO minibatches gathered on
    the card (per minibatch B1 2 forward, 2 backward on the cluster route, 2
    weight gradients), B2 never, every step eager under the trainer's step
    clock; then again without the clock, where update_device_scan's
    first update runs eagerly and its second captures the minibatch step
    (B1 2 + 2 + 2 recorded) and replays it: the launch counts add each
    replay's recorded launches (the capture itself runs none), and one more
    update under the profiler prints its kernel and graph launches per
    replayed step. Every minibatch step of both runs reads the rollout's
    stored backbone features: no frame recomputed (`WDDPPO`'s counters).
    The rollout's replays (both runs) and the second run's minibatch loop
    run under set_sync_debug_mode("error"). Each train() builds its episode
    bank's goal fields in one launch of goal_field.cu, counted in the
    goal-field kernel's launch line; one more update under the profiler
    holds each of the rollout's and the update's `ppo.*` spans. Then the
    last checkpoint's eval over forked workers as in phase_waypoint, and the
    rollout's and the update's times beside the host path's of this run."""
    from vlnce_torch.config import get_config
    from vlnce_torch.models.waypoint_policy import WaypointPolicy
    from vlnce_torch.parallel.optim import trainable_mask
    from vlnce_torch.rl.device_rollout import DeviceRolloutCollector
    from vlnce_torch.rl.ppo import WDDPPO
    from vlnce_torch.run import run_exp
    from vlnce_torch.trainers.ddppo_waypoint_trainer import DDPPOWaypointTrainer
    from vlnce_torch.utils.checkpoints import load_checkpoint

    with tempfile.TemporaryDirectory(prefix="vlnce_torch_smoke_") as tmp:
        common = [
            "TASK_CONFIG.DATASET.TYPE", "Synthetic-VLN-v0", "TASK_CONFIG.DATASET.NUM_SCENES", WP_N,
            "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", 40, "NUM_ENVIRONMENTS", WP_N,
            "TENSORBOARD_DIR", "", "VERBOSE", False, "LOG_FILE", os.path.join(tmp, "run.log"),
        ]
        train_opts = common + ["RL.NUM_UPDATES", WP_UPDATES, "RL.CHECKPOINT_INTERVAL", 1, "RL.LOG_INTERVAL", 1,
                               "CUDA.ON_DEVICE_ROLLOUT", True]
        cfg = get_config(WP_EXP, train_opts)
        start = {k: v.cpu() for k, v in WaypointPolicy.from_config(cfg, waypoint_space(cfg)).state_dict().items()}
        out = {}
        for name, clocked in (("device_waypoint_clocked", True), ("device_waypoint_graph", False)):
            ckpts = os.path.join(tmp, name)
            checked = [(DeviceRolloutCollector, "run_rollout")] + ([] if clocked else [(WDDPPO, "minibatch_loop")])
            torch.cuda.reset_peak_memory_stats()
            DDPPOWaypointTrainer.time_train_steps = clocked
            _reset_launches()
            t0 = time.perf_counter()
            try:
                with sync_checked(*checked):
                    trainer = run_exp(WP_EXP, "train", train_opts + ["CHECKPOINT_FOLDER", ckpts])
            finally:
                DDPPOWaypointTrainer.time_train_steps = False
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _read_launches()
            builds = _field_launches()
            assert builds["goal_distance_fields"] == 1, f"{builds}: the episode bank's goal fields, one launch"
            ppo, c, r, agent = trainer.config.RL.PPO, trainer.collector, trainer.rollout_stats, trainer.agent
            minibatches = WP_UPDATES * ppo.ppo_epoch * ppo.num_mini_batch
            # the wrappers count a captured step's launches once, at its capture, which runs nothing: what
            # the card ran is those of the eager steps and of every replay
            replayed = {k: v * (agent.replayed_steps - agent.captures) for k, v in agent.capture_launches.items()}
            launches = {k: v + replayed.get(k, 0) for k, v in launches.items()}
            print(f"{name}: run_exp took {wall:.1f} s, no env pool ({trainer.envs}); launches {json.dumps(launches)}: the "
                  f"probe step, the warm-ups and captures of the step and the bootstrap graphs {json.dumps(c.build_launches)}, "
                  f"then {minibatches} PPO minibatches; both graphs captured in {c.capture_seconds:.3f} s (warm-ups "
                  f"included); {c.replays} step replays, {c.rollouts} rollouts, {c.readbacks} read-backs; captured per step {c.capture_launches['step']}, per bootstrap {c.capture_launches['bootstrap']}; "
                  f"run_rollout{'' if clocked else ' and minibatch_loop'} under set_sync_debug_mode('error')")
            assert trainer.envs is None and c.rollouts == c.readbacks == WP_UPDATES and c.replays == WP_UPDATES * ppo.num_steps
            no_b2 = _recorded(gru_sequence=2)
            assert c.capture_launches == {"step": no_b2, "bootstrap": no_b2}, c.capture_launches
            assert c.build_launches == _recorded(gru_sequence=10), c.build_launches
            assert launches == {"gru_sequence": 10 + 2 * minibatches, "gru_sequence_backward": 2 * minibatches,
                                "gru_weight_gradient": 2 * minibatches, "fused_resize_normalize": 0}, launches
            assert _cluster_launches() + replayed.get("gru_sequence_backward", 0) == 2 * minibatches, \
                "B1's backward left the cluster route"
            launches.update(builds)
            history = trainer.update_history
            assert len(history) == WP_UPDATES and all(math.isfinite(v) for h in history for v in h.values()), history
            mask = trainable_mask(trainer.policy, trainer.config.MODEL)
            after = {k: v.detach().cpu() for k, v in trainer.policy.state_dict().items()}
            frozen = {k for k, trains in mask.items() if not trains}
            moved = {k for k in mask if not torch.equal(after[k], start[k])}
            assert not moved & frozen and all(torch.equal(after[k], start[k]) for k in after if k not in mask), "a frozen tensor moved"
            assert moved == set(mask) - frozen, sorted(set(mask) - frozen - moved)
            last = os.path.join(ckpts, f"ckpt.{WP_UPDATES - 1}.ckpt")
            saved = load_checkpoint(last)
            assert saved["extra_state"] == {"update": WP_UPDATES - 1, "count_steps": WP_UPDATES * ppo.num_steps * WP_N}
            print(f"{name}: PPO stats per update " + "; ".join(json.dumps({k: round(v, 4) for k, v in h.items()}) for h in history)
                  + f"; {len(frozen)} frozen tensors bit-equal, {len(moved)} trainable tensors moved")
            # every minibatch step reads the rollout's stored backbone features: no frame recomputed
            rows = minibatches * ppo.num_steps * (WP_N // ppo.num_mini_batch)
            print(f"{name}: {agent.feature_rows_served} minibatch rows served from the rollout's stored backbone "
                  f"features, {agent.backbone_frames_recomputed} backbone frames recomputed")
            assert (agent.feature_rows_served, agent.backbone_frames_recomputed) == (rows, 0)
            steady = r["rollout_time"] - r["first_rollout_time"]
            steady_update = r["update_time"] - r["first_update_time"]
            steps = r["env_steps"] * (WP_UPDATES - 1) / WP_UPDATES
            print(f"{name}: rollouts {r['rollout_time']:.3f} s (the first, with the probe, the kernels' build and both "
                  f"captures, {r['first_rollout_time']:.3f} s; the second {steady:.3f} s: {steps / steady:.1f} env-steps/s end "
                  f"to end, the read-back included; host rollout of phase_waypoint, this run, {host['rollout']:.1f}); PPO "
                  f"update {r['update_time'] / WP_UPDATES:.3f} s per update (the second {steady_update:.3f} s; host "
                  f"{host['update_s']:.3f}); training {r['env_steps'] / (r['rollout_time'] + r['update_time']):.1f} "
                  f"env-steps/s of rollout and update, {steps / (steady + steady_update):.1f} in the second update (host "
                  f"{host['train']:.1f} over both); peak card memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            if clocked:
                clock, first = trainer.step_clock.totals(), dict(trainer.step_clock.first)
                order = ("gather", "forward", "backward", "optimizer")
                assert sorted(clock) == sorted(order) and trainer.step_clock.steps == minibatches
                warm = {k: (clock[k] - first[k]) / (minibatches - 1) for k in order}
                print(f"{name}: PPO minibatch step (T={ppo.num_steps}, n={WP_N // ppo.num_mini_batch}) by CUDA events, mean "
                      f"of the {minibatches - 1} after the first: {sum(warm.values()):.2f} ms = "
                      + ", ".join(f"{k} {warm[k]:.2f}" for k in order) + f" ms (host path's, with its upload, "
                      f"{host['minibatch_ms']:.2f} ms)")
                # the replays alone, then one rollout under the profiler
                c.load_rollout()
                torch.cuda.synchronize()
                start_ev, end_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start_ev.record()
                c._step.run(c.T)
                end_ev.record()
                torch.cuda.synchronize()
                replay_ms = start_ev.elapsed_time(end_ev)
                c.load_rollout()
                roll_ms, busy, counts = trace_segment(lambda: c.run_rollout(trainer.generator))
                n1 = _kernel_count(counts, "gru_sequence_kernel")
                print(f"{name}: {c.T} step replays {replay_ms:.2f} ms ({replay_ms / c.T:.3f} ms per step, "
                      f"{c.T * c.B / replay_ms * 1e3:.1f} env-steps/s of the replays alone; host act step of phase_waypoint "
                      f"{host['act_ms']:.1f} ms); a rollout (uniforms, {c.T} replays, the bootstrap graph) under the profiler "
                      f"{roll_ms:.2f} ms, device busy {busy:.2f} ms, idle share {max(0.0, 1 - busy / roll_ms):.1%}; "
                      f"B1 kernels {n1} (2 x {c.T + 1})")
                # a step graph without B1 would miss it in each of the T replays;
                # the profiler may lose an activity record (two B1 records of 34
                # here once, with both graphs' own launches held exactly above)
                assert 2 * (c.T + 1) - 2 <= n1 <= 2 * (c.T + 1), (n1, c.T)
                top = sorted(((v, k) for k, v in counts.items()), reverse=True)[:3]
                print(f"{name}: the rollout's most launched kernels: " + "; ".join(f"{v} x {k[:70]}" for v, k in top))
            else:
                # the first update eager (Adam held no state), the second captured at its first step
                per_update = minibatches // WP_UPDATES
                assert agent.captures == 1 and agent.replayed_steps == per_update, (agent.captures, agent.replayed_steps)
                assert agent.capture_launches == _recorded(gru_sequence=2, gru_sequence_backward=2,
                                                           gru_weight_gradient=2), agent.capture_launches
                print(f"{name}: update_device_scan {r['update_time'] / WP_UPDATES:.3f} s per update, {per_update} "
                      f"minibatch steps after one index upload, one read-back; {agent.captures} capture of the step "
                      f"({agent.capture_seconds:.3f} s, recorded {json.dumps(agent.capture_launches)}), "
                      f"{agent.replayed_steps} replayed steps")
                from torch.profiler import ProfilerActivity, profile

                steps, replays, served = agent.minibatch_steps, agent.replayed_steps, agent.feature_rows_served
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    trainer.train_update_on_device(WP_UPDATES, np.random.RandomState(0))
                host = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]  # not the spans' mirrors
                spans = {}
                for e in host:
                    if e.name.startswith("ppo."):
                        spans[e.name] = spans.get(e.name, 0) + 1
                update = next(e for e in host if e.name == "ppo.update").time_range
                launch = re.compile(r"^(cuda|cu)(LaunchKernel|LaunchKernelExC?|LaunchCooperativeKernel|GraphLaunch)(_v\d+)?$")
                update_launches = sum(1 for e in host if launch.match(e.name)
                                      and update.start <= e.time_range.start and e.time_range.end <= update.end)
                want = ("ppo.rollout", "ppo.load", "ppo.replays", "ppo.readback", "ppo.update", "ppo.plan",
                        "ppo.minibatches", "ppo.update_readback")
                print(f"{name}: one more update under the profiler: spans {json.dumps(spans)}, "
                      f"{agent.minibatch_steps - steps} minibatch steps counted, {agent.replayed_steps - replays} of them "
                      f"replayed, {agent.feature_rows_served - served} rows served from stored features, "
                      f"{agent.backbone_frames_recomputed} backbone frames recomputed; {update_launches} kernel and "
                      f"graph launches inside ppo.update, {update_launches / per_update:.2f} a minibatch step (1,652 eager)")
                assert all(spans.get(k) == 1 for k in want) and "ppo.capture" not in spans, spans
                assert agent.minibatch_steps - steps == agent.replayed_steps - replays == per_update
                assert agent.feature_rows_served - served == rows // WP_UPDATES and agent.backbone_frames_recomputed == 0
                assert 0 < update_launches <= 5 * per_update, update_launches
            out[name] = launches

        evaluator, eval_launches, eval_wall = _run_loop("eval", common + [
            "TASK_CONFIG.DATASET.NUM_EPISODES", 16, "EVAL.EPISODE_COUNT", 8, "EVAL.SAMPLE", True, "EVAL_CKPT_PATH_DIR", last,
            "RESULTS_DIR", os.path.join(tmp, "evals"),
        ], exp=WP_EXP, per_act_step=(2, 0, 0, 0))
        head = "critic.fc.weight"
        assert torch.equal(evaluator.policy.state_dict()[head].cpu(), after[head]), "eval did not load the trained weights"
        with open(os.path.join(tmp, "evals", f"stats_ckpt_0_{trainer.config.EVAL.SPLIT}.json")) as f:
            stats = json.load(f)
        assert "waypoint_reward_measure" in stats and all(math.isfinite(v) for v in stats.values()), stats
        print(f"device waypoint eval of {os.path.basename(last)}: {len(evaluator._last_eval_episode_stats)} episodes in "
              f"{eval_wall:.1f} s, stats {json.dumps({k: round(v, 4) for k, v in stats.items()})}")
    return out["device_waypoint_clocked"], out["device_waypoint_graph"], eval_launches


def phase_device_waypoint_against_plain(dev, n: int = WP_N, T: int = 8, rollouts: int = 2):
    """The graphed rollout through B1's kernel against the eager rollout with
    its plain version (f32, TF32 off, 1-wpn-cc at full width, N=4, T=8,
    the same uniforms from two generators of one seed), over two rollouts.
    Values and log-probs within 1e-4 of their scale (phase_main_path's
    tolerance); every pano and stop equal unless the plain draw's uniform
    lies within 1e-4 of a bound of its pano CDF; positions (globalgps) and
    rewards within 1e-5 on each slot up to its first differing pano."""
    from vlnce_torch.config import get_config
    from vlnce_torch.config.default import add_pano_sensors_to_config
    from vlnce_torch.models.waypoint_policy import WaypointPolicy
    from vlnce_torch.ops.obs_transforms import get_active_obs_transforms
    from vlnce_torch.rl.device_rollout import DeviceRolloutCollector

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = add_pano_sensors_to_config(get_config(WP_EXP, [
        "CUDA.DEVICE", str(dev), "CUDA.PRECISION.compute_dtype", "float32", "TASK_CONFIG.DATASET.TYPE", "Synthetic-VLN-v0",
        "TASK_CONFIG.DATASET.NUM_SCENES", n, "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", 40, "NUM_ENVIRONMENTS", n,
        "RL.PPO.num_steps", T]))
    policy = WaypointPolicy.from_config(cfg, waypoint_space(cfg))
    transforms = get_active_obs_transforms(cfg)
    graphed = DeviceRolloutCollector(policy, transforms, cfg, n)
    eager = DeviceRolloutCollector(policy, transforms, cfg, n, eager=True)
    gens = [torch.Generator(device=dev).manual_seed(13) for _ in range(2)]
    logits = []
    act = policy.act

    def recording_act(*args, **kwargs):
        out = act(*args, **kwargs)
        logits.append(out["pano_stop_logits"].float())
        return out

    worst = {"value": 0.0, "log_prob": 0.0, "pos": 0.0, "reward": 0.0}
    compared = flipped = 0
    for c in (graphed, eager):
        c.initial_carry_and_obs()
    for r in range(rollouts):
        k_batch = {k: (v.clone() if not isinstance(v, dict) else {a: b.clone() for a, b in v.items()})
                   for k, v in graphed.collect_device(np.zeros((n, 1), np.float32), {}, gens[0])[0].items()}
        logits.clear()
        policy.act = recording_act
        try:
            with plain_versions(resize=False):
                p_batch = eager.collect_device(np.zeros((n, 1), np.float32), {}, gens[1])[0]
        finally:
            del policy.act
        assert torch.equal(graphed._uniforms, eager._uniforms), "the two rollouts drew different uniforms"
        for key, name in (("value_preds", "value"), ("old_log_probs", "log_prob")):
            scale = float(p_batch[key].abs().max())
            worst[name] = max(worst[name], float((k_batch[key] - p_batch[key]).abs().max()) / scale)
        pano_k, pano_p = k_batch["actions"]["pano"][..., 0], p_batch["actions"]["pano"][..., 0]
        cdf = torch.softmax(torch.stack(logits[-T:]), dim=-1).cumsum(-1)  # [T, n, 13], the plain run's steps
        u = graphed._uniforms[:, 0]  # [T, n]
        near = ((cdf - u[..., None]).abs() < 1e-4).any(-1)
        differ = pano_k != pano_p
        assert not bool((differ & ~near).any()), f"rollout {r}: a pano differs away from a CDF bound"
        flipped += int(differ.any())
        same = (differ.int().cumsum(0) == 0)  # each slot up to its first differing pano
        gps_k, gps_p = k_batch["obs"]["globalgps"], p_batch["obs"]["globalgps"]
        worst["pos"] = max(worst["pos"], float(((gps_k - gps_p).abs().amax(-1) * same).max()))
        worst["reward"] = max(worst["reward"], float(((k_batch["rewards"] - p_batch["rewards"]).abs()[..., 0] * same).max()))
        compared += int(same.sum())
        if differ.any():
            break  # the slots' carries part here
    print(f"device rollout against plain (f32, TF32 off, 1-wpn-cc at full width, N={n}, T={T}, graph through B1's kernel vs "
          f"eager with its plain version, the same uniforms): max |value diff| {worst['value']:.3e} and |log-prob diff| "
          f"{worst['log_prob']:.3e} of their scale (<= 1e-4); {compared} slot-steps with equal actions: max |position diff| "
          f"{worst['pos']:.3e}, |reward diff| {worst['reward']:.3e} (<= 1e-5); "
          + ("a pano flipped at a CDF bound" if flipped else "every pano and stop equal"))
    assert worst["value"] <= 1e-4 and worst["log_prob"] <= 1e-4, "the graphed rollout disagrees with the plain one"
    assert worst["pos"] <= 1e-5 and worst["reward"] <= 1e-5, "positions or rewards disagree where the actions agree"
    assert graphed._step.graph is not None and eager._step.graph is None
    torch.backends.cudnn.allow_tf32 = True


def phase_device_recollect(dev, host_rate):
    """`run_exp(rxr_cma_en.yaml, "train")` as phase_recollect runs it, with
    CUDA.ON_DEVICE_RECOLLECT (the GT trajectories rendered on the card, read
    back per chunk: per train step B2 twice in the train step's transforms,
    B1 as phase_recollect), then with CUDA.RECOLLECT_RESIDENT as well (B2
    captured twice per render step, none in the train step). Then one chunk
    rendered on the card against the host simulator along the same GT
    actions, and the render's env-steps/s beside phase_recollect's
    re-simulation."""
    from vlnce_torch.config import get_config
    from vlnce_torch.envs.gridworld import GridWorldSim
    from vlnce_torch.ops.obs_transforms import get_active_obs_transforms
    from vlnce_torch.tasks.datasets import make_dataset
    from vlnce_torch.data.device_recollect import render_gt_batch_resident, render_gt_episodes_on_device

    out = {}
    with tempfile.TemporaryDirectory(prefix="vlnce_torch_smoke_") as tmp:
        _, train_opts = _recollect_opts(tmp, 1, 2 * RECOLLECT_N)  # phase_recollect's run cut to its first epoch
        for name, extra, per_step in (("device_recollect", [], (2, 2, 2, 2)),
                                      ("device_recollect_resident", ["CUDA.RECOLLECT_RESIDENT", True], (2, 2, 2, 0))):
            opts = train_opts + ["CUDA.ON_DEVICE_RECOLLECT", True, *extra,
                                 "CHECKPOINT_FOLDER", os.path.join(tmp, name)]
            trainer, launches, wall = _run_recollect(EXP, opts, per_step, render_b2=bool(extra))
            sim = trainer.resimulation
            graphs = sim["capture_launches"]
            want = _recorded(fused_resize_normalize=2 if extra else 0)
            assert graphs and all(g == want for g in graphs), graphs
            assert os.path.exists(os.path.join(tmp, name, "ckpt.0.ckpt"))
            print(f"{name}: {len(graphs)} render graphs (one per T_pad), each captured with {json.dumps(want)} per step; "
                  f"{sim['replays']} replays; the render {sim['env_steps']} env steps of {sim['episodes']} episodes in "
                  f"{sim['seconds']:.2f} s on the prefetch thread ({sim['env_steps'] / sim['seconds']:.1f} env-steps/s, the "
                  f"chunks' host setup included; host re-simulation of phase_recollect, this run, {host_rate:.1f})")
            out[name] = launches

        # one chunk: the card's frames against the host simulator stepped along the same GT actions
        cfg = get_config(EXP, train_opts + ["CUDA.DEVICE", str(dev)])
        with gzip.open(cfg.IL.RECOLLECT_TRAINER.trajectories_file, "rt") as f:
            trajectories = json.load(f)
        episodes = [ep for ep in make_dataset(cfg.TASK_CONFIG.DATASET.TYPE, cfg.TASK_CONFIG.DATASET).episodes
                    if ep.episode_id in trajectories][:RECOLLECT_N]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rendered = render_gt_episodes_on_device(cfg, episodes, trajectories, 1.0, instr_uuid="rxr_instruction")
        wire_s = time.perf_counter() - t0
        steps = sum(len(trajectories[ep.episode_id]) for ep in episodes)
        transforms = get_active_obs_transforms(cfg)
        render_gt_batch_resident(cfg, episodes, trajectories, 1.0, instr_uuid="rxr_instruction", transforms=transforms)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_gt_batch_resident(cfg, episodes, trajectories, 1.0, instr_uuid="rxr_instruction", transforms=transforms)
        torch.cuda.synchronize()
        resident_s = time.perf_counter() - t0
        sim = GridWorldSim(cfg.TASK_CONFIG.SIMULATOR)
        depth_off = rgb_off = pixels = 0
        worst_depth = worst_rgb = 0.0
        for ep, (obs, *_rest) in zip(episodes, rendered):
            sim.reconfigure(ep.scene_id)
            sim.reset()
            sim.set_agent_state(ep.start_position, ep.start_rotation)
            frames = [sim.get_observations_at()] + [sim.step(s[1]) for s in trajectories[ep.episode_id][:-1]]
            for t, host in enumerate(frames):
                d_depth = np.abs(obs["depth"][t] - host["depth"])
                d_rgb = np.abs(obs["rgb"][t].astype(int) - host["rgb"].astype(int)).max(-1)
                worst_depth, worst_rgb = max(worst_depth, float(d_depth.max())), max(worst_rgb, float(d_rgb.max()))
                depth_off += int((d_depth > 1e-3).sum())
                rgb_off += int((d_rgb > 1).sum())
                pixels += d_rgb.size
        print(f"device recollection vs host re-simulation, {len(episodes)} episodes, {steps} steps at 480x640: depth off by "
              f"more than the f16 tolerance 1e-3 on {depth_off / pixels:.4%} of the pixels, RGB off by more than 1 on "
              f"{rgb_off / pixels:.4%} (under 1% each: the card steps the pose in f32, the host in f64, so a wall edge or a "
              f"ray's hit cell can fall on the other side; the largest diffs {worst_depth:.2e}, {worst_rgb:.0f}); one chunk's "
              f"render on the card {steps / wire_s:.1f} env-steps/s through the wire (host setup and the read-back included), "
              f"{steps / resident_s:.1f} resident with B2 in the step (a warm graph)")
        assert depth_off < 0.01 * pixels and rgb_off < 0.01 * pixels, "the card's recollection disagrees with the host simulator"
    return out["device_recollect"], out["device_recollect_resident"]


# ---------------------------------------------------------------------------
# the video path: VIDEO_OPTION [disk] on the host eval, the scan eval and
# the waypoint eval, each beside the same eval without video
# ---------------------------------------------------------------------------

VIDEO_EPISODES = 8
VIDEO_SCAN_EPISODES = 16


@contextlib.contextmanager
def _video_probes(modules):
    """Patches, for one run, the frame composers and `generate_video` that
    `modules` (trainer modules) call: times every composed frame, keeps each
    written video's frames (to hold the file against them), and records
    the actions each loop takes."""
    from vlnce_torch.models.waypoint_policy import WaypointPolicy
    from vlnce_torch.trainers import base_trainer, scan_eval

    probe = {"frame_s": 0.0, "frames": 0, "videos": {}, "actions": []}
    saved = []

    def patch(owner, name, new):
        saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, new)

    def timed(fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            probe["frame_s"] += time.perf_counter() - t0
            probe["frames"] += fn.__name__ != "append_text_to_image"
            return out
        run.__name__ = fn.__name__
        return run

    def keep(fn):
        def run(video_option, video_dir, images, episode_id, checkpoint_idx, metrics, tb_writer=None, fps=10):
            name = f"episode={episode_id}-ckpt={checkpoint_idx}-" + "-".join(f"{k}={v:.2f}" for k, v in metrics.items())
            probe["videos"][os.path.join(video_dir, name + ".avi")] = np.stack(images)
            return fn(video_option, video_dir, images, episode_id, checkpoint_idx, metrics, tb_writer, fps)
        return run

    for module in modules:
        for name in ("observations_to_image", "append_text_to_image", "waypoint_observations_to_image"):
            if hasattr(module, name):
                patch(module, name, timed(getattr(module, name)))
        if hasattr(module, "generate_video"):
            patch(module, "generate_video", keep(module.generate_video))
    act = base_trainer._ActLoop.act
    patch(base_trainer._ActLoop, "act", lambda self: (lambda a: probe["actions"].append(a.copy()) or a)(act(self)))
    metrics_from_actions = scan_eval.metrics_from_actions

    def record_seqs(config, episodes, action_seqs, *args, **kwargs):
        probe["actions"].extend(np.asarray(a).copy() for a in action_seqs)
        return metrics_from_actions(config, episodes, action_seqs, *args, **kwargs)

    patch(scan_eval, "metrics_from_actions", record_seqs)
    to_env = WaypointPolicy.actions_to_env
    patch(WaypointPolicy, "actions_to_env", staticmethod(lambda out: (lambda a: probe["actions"].append(a) or a)(to_env(out))))
    try:
        yield probe
    finally:
        for owner, name, old in reversed(saved):
            setattr(owner, name, old)


def _same_actions(a, b):
    if len(a) != len(b):
        return False
    return all(np.array_equal(x, y) if isinstance(x, np.ndarray) else x == y for x, y in zip(a, b))


def _check_videos(probe, episodes, what):
    """One file per episode, as many frames as the episode's steps, read
    back by `read_video` bit for bit; returns (MB per file, frames)."""
    from vlnce_torch.utils.video import read_video

    videos = probe["videos"]
    assert len(videos) == len(episodes), (what, len(videos), len(episodes))
    sizes = []
    for path, frames in videos.items():
        ep_id = os.path.basename(path).split("-ckpt=")[0][len("episode="):]
        assert ep_id in episodes, (what, path)
        if "steps_taken" in episodes[ep_id]:
            assert frames.shape[0] == episodes[ep_id]["steps_taken"], (what, path, frames.shape)
        back = read_video(path)
        assert back.shape == frames.shape and np.array_equal(back, frames), f"{what}: {path} does not read back bit for bit"
        sizes.append(os.path.getsize(path) / 1e6)
    return sum(sizes) / len(sizes), sum(v.shape[0] for v in videos.values())


def phase_video(dev):
    """VIDEO_OPTION [disk] at full width on procedural scenes (origin (0, 0)),
    MAP_RESOLUTION 1024, fog of war on: (a) the RxR CMA host eval over
    N_ENVS forked workers, VIDEO_EPISODES episodes of at most 40 steps;
    (b) the RxR CMA scan eval at B=32, VIDEO_SCAN_EPISODES episodes (frames
    composed in the host replay); (c) the WPN eval of 1-wpn-cc.yaml over
    WP_N workers, WP_N episodes (its measures with TOP_DOWN_MAP_VLNCE). Each
    beside the same eval without video in this call: the same actions and
    per-episode scalar metrics, B1 and B2 launched per act step as without
    video, one file per episode with a frame per step that `read_video`
    gives back bit for bit. Prints env-steps/s with and without video, ms
    per composed frame, MB per file, and the bytes per env step that the
    measure's index map adds to the worker pipes."""
    from vlnce_torch.config import get_config
    from vlnce_torch.envs import Env
    from vlnce_torch.run import run_exp
    from vlnce_torch.trainers import base_trainer, ddppo_waypoint_trainer, scan_eval
    from vlnce_torch.utils.checkpoints import save_checkpoint

    out = {}
    with tempfile.TemporaryDirectory(prefix="vlnce_torch_smoke_") as tmp:
        cfg, policy, _ = build_act_step(dev, "bfloat16")
        # the seeded head samples STOP once in six steps: a bias of -3 on it
        # (about 1%) lets most episodes run to the 40-step cap
        with torch.no_grad():
            policy.action_distribution.linear.bias.copy_(torch.tensor([-3.0, 0, 0, 0, 0, 0]))
        ckpt = os.path.join(tmp, "ckpt.0.pth")
        save_checkpoint(ckpt, policy.state_dict(), config=cfg)
        del policy
        assert cfg.TASK_CONFIG.TASK.TOP_DOWN_MAP_VLNCE.MAP_RESOLUTION == 1024
        assert cfg.TASK_CONFIG.TASK.TOP_DOWN_MAP_VLNCE.FOG_OF_WAR.DRAW
        common = ["TASK_CONFIG.DATASET.TYPE", "Synthetic-VLN-v0", "TASK_CONFIG.DATASET.NUM_SCENES", N_ENVS,
                  "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", 40, "TENSORBOARD_DIR", "", "VERBOSE", False,
                  "LOG_FILE", os.path.join(tmp, "run.log"), "EVAL.USE_CKPT_CONFIG", False, "EVAL_CKPT_PATH_DIR", ckpt]
        video = ["VIDEO_OPTION", ["disk"]]

        # the bytes a step's info carries through a worker's pipe for the measure
        task_cfg = get_config(EXP, common + ["TASK_CONFIG.DATASET.NUM_EPISODES", 1]).TASK_CONFIG.clone()
        task_cfg.defrost()
        task_cfg.TASK.MEASUREMENTS.append("TOP_DOWN_MAP_VLNCE")
        env = Env(task_cfg)
        env.reset()
        env.step(1)
        map_bytes = len(pickle.dumps(env.get_metrics()["top_down_map_vlnce"], protocol=pickle.HIGHEST_PROTOCOL))
        env.close()

        # (a) the host eval
        runs = {}
        for name, extra in (("plain", []), ("video", video + ["VIDEO_DIR", os.path.join(tmp, "videos_a")])):
            with _video_probes([base_trainer]) as probe:
                trainer, launches, wall = _run_loop("eval", common + extra + [
                    "NUM_ENVIRONMENTS", N_ENVS, "TASK_CONFIG.DATASET.NUM_EPISODES", 2 * VIDEO_EPISODES,
                    "EVAL.EPISODE_COUNT", VIDEO_EPISODES, "RESULTS_DIR", os.path.join(tmp, f"evals_a_{name}")])
            t = trainer.last_loop_timing
            runs[name] = (dict(trainer._last_eval_episode_stats), probe, t, launches)
        (eps, p_plain, t_plain, l_plain), (eps_v, p_video, t_video, l_video) = runs["plain"], runs["video"]
        assert eps == eps_v and len(eps) >= VIDEO_EPISODES, "(a) the video run's episodes or metrics differ"
        assert _same_actions(p_plain["actions"], p_video["actions"]), "(a) the video run took other actions"
        mb, frames = _check_videos(p_video, eps_v, "(a) host eval")
        rate = (t_plain["env_steps"] / t_plain["total_time"], t_video["env_steps"] / t_video["total_time"])
        print(f"video (a) RxR CMA host eval, N={N_ENVS}, {len(eps)} episodes: env-steps/s {rate[1]:.1f} with video, "
              f"{rate[0]:.1f} without ({rate[1] / rate[0]:.2f}x); {frames} frames, {1e3 * p_video['frame_s'] / frames:.2f} ms per "
              f"composed frame (observations_to_image and append_text_to_image, on the host), {mb:.3f} MB per file; "
              f"B1 and B2 per act step {l_video['gru_sequence'] / t_video['act_steps']:.0f} and "
              f"{l_video['fused_resize_normalize'] / t_video['act_steps']:.0f}; the measure's 1024² map adds {map_bytes} bytes "
              f"per env per step to the pipes ({N_ENVS * map_bytes / 2**20:.2f} MiB per pool step at N={N_ENVS})")
        out["video_eval"], out["video_eval_plain"] = l_video, l_plain

        # (b) the scan eval: the step graph is the same; the replay composes the frames
        runs = {}
        for name, extra in (("plain", []), ("video", video + ["VIDEO_DIR", os.path.join(tmp, "videos_b")])):
            with _video_probes([scan_eval]) as probe:
                _reset_launches()
                trainer = run_exp(EXP, "eval", common + extra + [
                    "EVAL.ON_DEVICE_SCAN", True, "EVAL.SCAN_BATCH", SCAN_B, "EVAL.SCAN_SEGMENT", SCAN_SEGMENT,
                    "TASK_CONFIG.DATASET.NUM_EPISODES", VIDEO_SCAN_EPISODES, "EVAL.EPISODE_COUNT", VIDEO_SCAN_EPISODES,
                    "RESULTS_DIR", os.path.join(tmp, f"evals_b_{name}")])
                launches = _read_launches()
            t = _check_scan_run(trainer, launches, (2, 2), f"scan eval ({name})")
            runs[name] = (dict(trainer._last_eval_episode_stats), probe, t, launches)
        (eps, p_plain, t_plain, l_plain), (eps_v, p_video, t_video, l_video) = runs["plain"], runs["video"]
        assert eps == eps_v and len(eps) == VIDEO_SCAN_EPISODES, "(b) the video run's episodes or metrics differ"
        assert _same_actions(p_plain["actions"], p_video["actions"]), "(b) the video run took other actions"
        mb, frames = _check_videos(p_video, eps_v, "(b) scan eval")

        def scan_rate(t):
            return t["env_steps"] / (t["seconds"] - t["capture_seconds"] + t["replay_seconds"])

        print(f"video (b) RxR CMA scan eval, B={SCAN_B}, {len(eps)} episodes: env-steps/s {scan_rate(t_video):.1f} with video, "
              f"{scan_rate(t_plain):.1f} without ({scan_rate(t_video) / scan_rate(t_plain):.2f}x; after the capture, the host "
              f"replay included: {t_video['replay_seconds']:.2f} s against {t_plain['replay_seconds']:.2f} s); {frames} frames, "
              f"{1e3 * p_video['frame_s'] / frames:.2f} ms per composed frame, {mb:.3f} MB per file; launches "
              f"{json.dumps(l_video)} (warm-up and capture of one graph, as without video)")
        out["video_scan_eval"], out["video_scan_eval_plain"] = l_video, l_plain

        # (c) the waypoint eval of seeded WPN weights, sampled as phase_waypoint's eval
        wp_common = ["TASK_CONFIG.DATASET.TYPE", "Synthetic-VLN-v0", "TASK_CONFIG.DATASET.NUM_SCENES", WP_N,
                     "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", 40, "NUM_ENVIRONMENTS", WP_N, "TENSORBOARD_DIR", "",
                     "VERBOSE", False, "LOG_FILE", os.path.join(tmp, "run.log"), "TASK_CONFIG.DATASET.NUM_EPISODES", 2 * WP_N,
                     "EVAL.EPISODE_COUNT", WP_N, "EVAL.SAMPLE", True, "EVAL_CKPT_PATH_DIR", os.path.join(tmp, "none.pth")]
        measures = list(get_config(WP_EXP).TASK_CONFIG.TASK.MEASUREMENTS) + ["TOP_DOWN_MAP_VLNCE"]
        runs = {}
        for name, extra in (("plain", []), ("video", video + ["VIDEO_DIR", os.path.join(tmp, "videos_c"),
                                                              "TASK_CONFIG.TASK.MEASUREMENTS", measures])):
            with _video_probes([ddppo_waypoint_trainer]) as probe:
                trainer, launches, wall = _run_loop("eval", wp_common + extra + ["RESULTS_DIR", os.path.join(tmp, f"evals_c_{name}")],
                                                    exp=WP_EXP, per_act_step=(2, 0, 0, 0))
            runs[name] = (dict(trainer._last_eval_episode_stats), probe, trainer.last_loop_timing, launches)
        (eps, p_plain, t_plain, l_plain), (eps_v, p_video, t_video, l_video) = runs["plain"], runs["video"]
        assert eps == eps_v and len(eps) >= WP_N, "(c) the video run's episodes or metrics differ"
        assert _same_actions(p_plain["actions"], p_video["actions"]), "(c) the video run took other actions"
        mb, frames = _check_videos(p_video, eps_v, "(c) waypoint eval")
        rate = (t_plain["env_steps"] / t_plain["total_time"], t_video["env_steps"] / t_video["total_time"])
        print(f"video (c) WPN eval, N={WP_N}, {len(eps)} episodes: env-steps/s {rate[1]:.1f} with video (the map measure "
              f"added), {rate[0]:.1f} without ({rate[1] / rate[0]:.2f}x); {frames} frames, {1e3 * p_video['frame_s'] / frames:.2f} "
              f"ms per composed frame (waypoint_observations_to_image), {mb:.3f} MB per file; B1 per act step "
              f"{l_video['gru_sequence'] / t_video['act_steps']:.0f}")
        out["video_waypoint_eval"], out["video_waypoint_eval_plain"] = l_video, l_plain
    return out


# ---------------------------------------------------------------------------
# the shared-memory observation ring against the pipes, on the host loops
# ---------------------------------------------------------------------------

RING_EPISODES = 8


def _storage_digest(rollouts):
    """sha1 of every array of a rollout storage, by name."""
    import hashlib

    out = {}
    for name, value in vars(rollouts).items():
        for key, arr in (value.items() if isinstance(value, dict) else [("", value)]):
            if isinstance(arr, np.ndarray):
                out[f"{name}/{key}"] = hashlib.sha1(np.ascontiguousarray(arr).tobytes()).hexdigest()
    return out


def phase_shm_ring(dev):
    """The shared-memory observation ring (VLNCE_TORCH_SHM_OBS=1, the
    default) against the pipes (=0), in turns in this call, at full width:
    (a) the RxR CMA host eval over N_ENVS forked workers (phase_serving's
    run, bf16, RING_EPISODES episodes run to the 40-step cap by a STOP
    bias, in the order ring, pipes, pipes, ring): equal actions and
    per-episode measures, 2 + 2 launches of B1 and B2 per act step in all,
    their env-steps/s, `phase_env_step_parts` with the ring, and the bytes per
    pool step that the pipes still carry; (b) the WPN DD-PPO host rollout
    over WP_N workers (one update of 16 steps), in the same turns: equal
    rollout storage (every array's digest), the launches per act step and
    minibatch, each run's env-steps/s. Prints /dev/shm's size first."""
    import vlnce_torch.tasks  # noqa: F401  (registers the sensors and measures)
    from vlnce_torch.config import get_config
    from vlnce_torch.envs import ensure_registered, rl_envs, shm_transport  # noqa: F401  (rl_envs registers the envs)
    from vlnce_torch.envs.env_utils import get_env_class
    from vlnce_torch.run import run_exp
    from vlnce_torch.trainers.ddppo_waypoint_trainer import DDPPOWaypointTrainer
    from vlnce_torch.utils.checkpoints import save_checkpoint

    ensure_registered()
    shm = subprocess.run(["df", "-B1", "/dev/shm"], capture_output=True, text=True).stdout.strip().splitlines()[-1].split()
    print(f"shm ring: /dev/shm has {int(shm[1])} bytes, {int(shm[3])} free (df -B1)")
    out = {}
    saved_env = os.environ.get("VLNCE_TORCH_SHM_OBS")
    try:
        with tempfile.TemporaryDirectory(prefix="vlnce_torch_smoke_") as tmp:
            cfg, policy, _ = build_act_step(dev, "bfloat16")
            # STOP's logit biased by -3, as in phase_video: episodes run to the 40-step cap
            with torch.no_grad():
                policy.action_distribution.linear.bias.copy_(torch.tensor([-3.0, 0, 0, 0, 0, 0]))
            ckpt = os.path.join(tmp, "ckpt.0.pth")
            save_checkpoint(ckpt, policy.state_dict(), config=cfg)
            del policy
            common = ["TASK_CONFIG.DATASET.TYPE", "Synthetic-VLN-v0", "TASK_CONFIG.DATASET.NUM_SCENES", N_ENVS,
                      "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", 40, "NUM_ENVIRONMENTS", N_ENVS, "TENSORBOARD_DIR", "",
                      "VERBOSE", False, "LOG_FILE", os.path.join(tmp, "run.log"), "EVAL.USE_CKPT_CONFIG", False,
                      "EVAL_CKPT_PATH_DIR", ckpt, "TASK_CONFIG.DATASET.NUM_EPISODES", 2 * RING_EPISODES,
                      "EVAL.EPISODE_COUNT", RING_EPISODES]

            # what one pool step sends through the pipes, with the ring and without
            config = get_config(EXP, common)
            env = get_env_class(config.ENV_NAME)(config)
            env.reset()
            obs, reward, done, info = env.step(1)
            ring_keys = shm_transport.ObsSchema(obs).fields
            pipe_bytes = len(pickle.dumps((obs, reward, done, info), protocol=pickle.HIGHEST_PROTOCOL))
            rest = {k: v for k, v in obs.items() if k not in ring_keys}
            ring_pipe_bytes = len(pickle.dumps((("__shm__", 1, rest), reward, done, info), protocol=pickle.HIGHEST_PROTOCOL))
            env.close()

            # (a) the host eval in turns: ring, pipes, pipes, ring
            runs = collections.defaultdict(list)
            for i, name in enumerate(("ring", "pipes", "pipes", "ring")):
                os.environ["VLNCE_TORCH_SHM_OBS"] = "1" if name == "ring" else "0"
                with _video_probes([]) as probe:
                    trainer, launches, wall = _run_loop("eval", common + ["RESULTS_DIR", os.path.join(tmp, f"evals_{i}")])
                runs[name].append((dict(trainer._last_eval_episode_stats), probe["actions"], trainer.last_loop_timing))
                out[f"shm_{name}_eval"] = launches
            first = runs["ring"][0]
            assert len(first[0]) >= RING_EPISODES
            for eps, actions, _ in runs["ring"] + runs["pipes"]:
                assert eps == first[0], "(a) an eval's episodes or measures differ between the ring and the pipes"
                assert _same_actions(actions, first[1]), "(a) an eval took other actions than the first"

            def warm_rate(t):  # the first act step (the libraries' warm-up) left out
                return t["env_steps"] / (t["total_time"] - t["first_act_time"])

            rate = {name: [warm_rate(r[2]) for r in rs] for name, rs in runs.items()}
            env_ms = {name: [1e3 * r[2]["env_time"] / r[2]["act_steps"] for r in rs] for name, rs in runs.items()}
            t_r = first[2]
            print(f"shm ring (a) RxR CMA host eval, N={N_ENVS}, {len(first[0])} episodes, {t_r['act_steps']} act steps, in "
                  f"turns ring, pipes, pipes, ring: env-steps/s {rate['ring']} with the ring, {rate['pipes']} over the pipes "
                  f"({np.mean(rate['ring']) / np.mean(rate['pipes']):.3f}x of the means; the first act step left out); "
                  f"env_time {env_ms['ring']} against {env_ms['pipes']} ms per act step; the ring carries {sorted(ring_keys)}; "
                  f"the pipes carry {N_ENVS * ring_pipe_bytes} bytes per pool step with the ring against {N_ENVS * pipe_bytes} "
                  f"without ({ring_pipe_bytes} and {pipe_bytes} per env)")
            os.environ["VLNCE_TORCH_SHM_OBS"] = "1"
            phase_env_step_parts(trainer, dev)

            # (b) the WPN DD-PPO host rollout in turns: ring, pipes, pipes, ring
            digests = []
            update_from_storage = DDPPOWaypointTrainer._update_from_storage

            def digest_then_update(self, rollouts, rng_np, update):
                digests.append(_storage_digest(rollouts))
                return update_from_storage(self, rollouts, rng_np, update)

            wp_rate = collections.defaultdict(list)
            DDPPOWaypointTrainer._update_from_storage = digest_then_update
            try:
                for i, name in enumerate(("ring", "pipes", "pipes", "ring")):
                    os.environ["VLNCE_TORCH_SHM_OBS"] = "1" if name == "ring" else "0"
                    opts = ["TASK_CONFIG.DATASET.TYPE", "Synthetic-VLN-v0", "TASK_CONFIG.DATASET.NUM_SCENES", WP_N,
                            "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", 40, "NUM_ENVIRONMENTS", WP_N, "TENSORBOARD_DIR", "",
                            "VERBOSE", False, "LOG_FILE", os.path.join(tmp, "run.log"),
                            "CHECKPOINT_FOLDER", os.path.join(tmp, f"wp_{i}"), "RL.NUM_UPDATES", 1,
                            "RL.CHECKPOINT_INTERVAL", 1, "RL.LOG_INTERVAL", 1]
                    _reset_launches()
                    trainer = run_exp(WP_EXP, "train", opts)
                    launches = _read_launches()
                    ppo = trainer.config.RL.PPO
                    minibatches, act_steps = ppo.ppo_epoch * ppo.num_mini_batch, ppo.num_steps
                    assert launches == {"gru_sequence": 2 * act_steps + 2 + 2 * minibatches,
                                        "gru_sequence_backward": 2 * minibatches, "gru_weight_gradient": 2 * minibatches,
                                        "fused_resize_normalize": 0}, (name, launches)
                    r = trainer.rollout_stats
                    wp_rate[name].append(r["env_steps"] / (r["rollout_time"] - r["first_act_time"]))
                    out[f"shm_{name}_waypoint"] = launches
            finally:
                DDPPOWaypointTrainer._update_from_storage = update_from_storage
            assert len(digests) == 4 and len(digests[0]) > 10
            assert all(d == digests[0] for d in digests), "(b) the rollout storage differs between the ring and the pipes"
            print(f"shm ring (b) WPN DD-PPO host rollout, N={WP_N}, {act_steps} steps, in turns ring, pipes, pipes, ring: "
                  f"env-steps/s {wp_rate['ring']} with the ring, {wp_rate['pipes']} over the pipes "
                  f"({np.mean(wp_rate['ring']) / np.mean(wp_rate['pipes']):.3f}x of the means, the first act step left out); "
                  f"the rollout storage's {len(digests[0])} arrays equal in all four")
    finally:
        if saved_env is None:
            os.environ.pop("VLNCE_TORCH_SHM_OBS", None)
        else:
            os.environ["VLNCE_TORCH_SHM_OBS"] = saved_env
    return out


# ---------------------------------------------------------------------------
# data-parallel training: two ranks on the card against one process
# ---------------------------------------------------------------------------

TWO_RANK_T = 32  # the IL batch's T; the 6 envs of mp_smoke.N_GLOBAL split 3 + 3


def _grads_within(ranks, one, what):
    """Each rank's gradients bit-equal to the other's, and within
    phase_train_step_against_plain's tolerance of the one-process run's:
    1e-5 of the tensor's max |one| plus 1e-8 of the largest gradient."""
    (g0, g1), ref = ranks, one
    assert sorted(g0) == sorted(g1) == sorted(ref) and ref, what
    assert all(np.array_equal(g0[k], g1[k]) for k in g0), f"{what}: the ranks' gradients differ"
    largest = max(float(np.abs(v).max()) for v in ref.values())
    worst = max((float(np.abs(g0[k] - v).max()) / (1e-5 * float(np.abs(v).max()) + 1e-8 * largest), k) for k, v in ref.items())
    print(f"{what}: {len(ref)} gradients, the ranks' sum against one process at {worst[0]:.3f} of the tolerance at most "
          f"({worst[1]})")
    assert worst[0] <= 1.0, f"{what}: the two ranks' gradients disagree with one process's"


def phase_two_ranks(dev):
    """Two rank processes on this card (gloo: NCCL refuses two ranks on one
    device), TF32 off, f32, through `vlnce_torch.parallel.mp_smoke`: (a) one
    R2R CMA IL update at full width (H=512), each rank on 3 of the 6 envs of
    one [T=32] batch, against the one-process update of the whole batch here:
    losses within 1e-5 relative and bit-equal between the ranks, every
    gradient within phase_train_step_against_plain's tolerance, B1 forward,
    backward and weight gradient twice each per rank; (b) the same for one
    WPN PPO minibatch at n = 2 + 2 against n = 4 (T=16); (c) a resident
    DAgger train() of 2 ranks (ON_DEVICE_DAGGER, DAGGER_RESIDENT) at the
    widths of cma_pm_da_aug_tune.yaml: disjoint episode slices that cover
    the plan, equal losses; (e) the DD-PPO waypoint trainer's train() of 2
    ranks at the widths of 1-wpn-cc.yaml (4 envs per rank, T=16, one update,
    the rollout on the card): equal stats and final weights; then (d)
    `python -m vlnce_torch.run ... --run-type train` of (c)'s run at world
    size 1 through NCCL, with torchrun's variables set by hand."""
    from vlnce_torch.parallel import mp_smoke

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    launches = {}
    try:
        with tempfile.TemporaryDirectory(prefix="vlnce_torch_smoke_") as tmp:
            env = {"MP_SMOKE_DEVICE": "cuda", "MP_SMOKE_SIZE": "full", "MP_SMOKE_T": str(TWO_RANK_T),
                   "MP_SMOKE_PPO_T": str(WP_T), "MP_SMOKE_PPO_N": str(WP_N), "MP_SMOKE_OUT": tmp,
                   "MP_SMOKE_BACKEND": "gloo"}
            t0 = time.perf_counter()
            results = mp_smoke.launch("il,ppo,resident_dagger,ddppo", timeout=600, extra_env=env)
            print(f"two ranks: the rank pair ran in {time.perf_counter() - t0:.1f} s; per mode "
                  + ", ".join(f"{m} {r[0]['seconds']:.1f} s" for m, r in results.items()))

            def load(path):
                with np.load(path) as f:
                    return {k: f[k] for k in f.files}

            # (a) the IL update
            _reset_launches()
            one = mp_smoke.run_update(0, mp_smoke.N_GLOBAL, "full", "cuda", T=TWO_RANK_T,
                                      grads_out=os.path.join(tmp, "il_grads_one.npz"))
            one_launches = _read_launches()
            r0, r1 = results["il"]
            assert r0["ranks"] == r1["ranks"] == 2 and one["ranks"] == 1
            assert r0["loss"] == r1["loss"], "the ranks' IL losses differ"
            err = max(abs(a - b) / abs(b) for a, b in zip(r0["loss"], one["loss"]) if b != 0)
            print(f"two ranks (a) IL update, R2R CMA H=512, T={TWO_RANK_T}, 3 + 3 envs: losses {r0['loss']} against one "
                  f"process's {one['loss']} (max relative diff {err:.3e}, held at 1e-5); launches per rank "
                  f"{json.dumps(r0['launches'])} and {json.dumps(r1['launches'])}, one process {json.dumps(one_launches)}")
            assert err <= 1e-5, "the two ranks' IL losses disagree with one process's"
            want = {"gru_sequence": 2, "gru_sequence_backward": 2, "gru_weight_gradient": 2, "fused_resize_normalize": 0}
            assert r0["launches"] == r1["launches"] == one_launches == want, (r0["launches"], r1["launches"], one_launches)
            _grads_within([load(os.path.join(tmp, f"il_grads_rank{k}.npz")) for k in range(2)],
                          load(os.path.join(tmp, "il_grads_one.npz")), "two ranks (a) IL update")

            # (b) one PPO minibatch
            _reset_launches()
            one = mp_smoke.run_ppo_update(0, WP_N, "full", "cuda", grads_out=os.path.join(tmp, "ppo_grads_one.npz"),
                                          T=WP_T, N=WP_N)
            one_launches = _read_launches()
            r0, r1 = results["ppo"]
            assert r0["grads_stats"] == r1["grads_stats"] and r0["update_stats"] == r1["update_stats"]
            err = max(abs(r0["grads_stats"][k] - v) / max(abs(v), 1e-6) for k, v in one["grads_stats"].items())
            print(f"two ranks (b) WPN PPO minibatch, T={WP_T}, n = 2 + 2 against 4: stats {json.dumps(r0['grads_stats'])} "
                  f"(max relative diff {err:.3e}, held at 1e-5); launches per rank {json.dumps(r0['launches'])} and "
                  f"{json.dumps(r1['launches'])}, one process {json.dumps(one_launches)}")
            assert err <= 1e-5, "the two ranks' PPO stats disagree with one process's"
            want = {"gru_sequence": 4, "gru_sequence_backward": 4, "gru_weight_gradient": 4, "fused_resize_normalize": 0}
            assert r0["launches"] == r1["launches"] == one_launches == want, (r0["launches"], r1["launches"], one_launches)
            _grads_within([load(os.path.join(tmp, f"ppo_grads_rank{k}.npz")) for k in range(2)],
                          load(os.path.join(tmp, "ppo_grads_one.npz")), "two ranks (b) PPO minibatch")

            # (c) the resident DAgger train() of two ranks at full width
            r0, r1 = results["resident_dagger"]
            plan = [str(i) for i in range(mp_smoke.RESIDENT_EPISODES["full"])]
            assert not set(r0["ids"]) & set(r1["ids"]) and sorted(r0["ids"] + r1["ids"]) == plan, (r0["ids"], r1["ids"])
            assert r0["losses"] and r0["losses"] == r1["losses"] and np.isfinite(np.asarray(r0["losses"])).all()
            assert r0["checkpoints"] and not r1["checkpoints"], "a rank other than 0 wrote a checkpoint"
            assert all(r["launches"][k] > 0 for r in (r0, r1)
                       for k in ("gru_sequence", "gru_sequence_backward", "gru_weight_gradient"))
            print(f"two ranks (c) resident DAgger train(), R2R CMA at the YAML's widths: episodes {r0['ids']} and "
                  f"{r1['ids']}, losses {r0['losses']} on both; launches per rank {json.dumps(r0['launches'])} and "
                  f"{json.dumps(r1['launches'])} (graph warm-up, capture and probe step included)")

            # (e) the DD-PPO waypoint trainer's train() of two ranks at full width
            r0, r1 = results["ddppo"]
            assert r0["ranks"] == r1["ranks"] == 2 and len(r0["updates"]) == 1 and r0["updates"] == r1["updates"]
            assert r0["updates"][0]["count_steps"] == WP_T * r0["n_envs"] and r0["n_envs"] == WP_N
            assert all(np.isfinite(v) for v in r0["updates"][0].values())
            assert r0["params"] == r1["params"], "the ranks' weights differ after the update"
            assert r0["checkpoints"] == ["ckpt.0.ckpt"] and not r1["checkpoints"], "a rank other than 0 wrote a checkpoint"
            assert all(r["launches"][k] > 0 for r in (r0, r1)
                       for k in ("gru_sequence", "gru_sequence_backward", "gru_weight_gradient"))
            print(f"two ranks (e) DD-PPO waypoint train(), 1-wpn-cc at the YAML's widths, {WP_N} envs per rank, T={WP_T}, "
                  f"one update: stats {json.dumps(r0['updates'][0])} on both, final weights equal (sha256 "
                  f"{r0['params'][:16]}); launches per rank {json.dumps(r0['launches'])} and {json.dumps(r1['launches'])}")
            for mode in ("il", "ppo", "resident_dagger", "ddppo"):
                for r in results[mode]:
                    for k, v in r["launches"].items():
                        launches[k] = launches.get(k, 0) + v

            # (d) NCCL at world size 1 through the entry point
            log = os.path.join(tmp, "nccl.log")
            opts = [str(x) for x in mp_smoke.resident_opts(os.path.join(tmp, "nccl"), "cuda", "dagger", "full")]
            opts += ["RL.DDPPO.distrib_backend", "NCCL"]
            env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                       MASTER_PORT=str(mp_smoke._free_port()))
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", "vlnce_torch.run", "--exp-config", R2R_EXP, "--run-type", "train",
                                   *opts, "LOG_FILE", log], env=env, capture_output=True, text=True, timeout=300)
            assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
            with open(log + ".rank0") as f:
                text = f.read()
            line = next((x for x in text.splitlines() if "process group:" in x), "")
            assert "rank 0 of 1, backend nccl" in line, text[-2000:]
            assert os.path.isfile(os.path.join(tmp, "nccl", "ckpts", "ckpt.0.ckpt"))
            print(f"two ranks (d) NCCL at world size 1: `python -m vlnce_torch.run --run-type train` exited 0 in "
                  f"{time.perf_counter() - t0:.1f} s; its log: {line.split('] ')[-1]}")
    finally:
        torch.backends.cudnn.allow_tf32 = True
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    import vlnce_torch  # noqa: F401  (fails where the repository is absent)

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    phase_seconds = {}

    def timed(phase, *args):
        t0 = time.perf_counter()
        result = phase(*args)
        phase_seconds[phase.__name__] = round(time.perf_counter() - t0, 1)
        return result

    torch.backends.cuda.matmul.allow_tf32 = False
    name = phase_device()
    timed(phase_build)
    kernels = [timed(phase_gru, dev), *timed(phase_gru_backward, dev), timed(phase_resize, dev)]
    goal_field = timed(phase_goal_field, dev)
    paths = {"act_phase": timed(phase_main_path, dev)[0]}
    paths["eval"], paths["inference"], host_eval_rate = timed(phase_serving, dev)
    paths["scan_eval"], paths["scan_inference"] = timed(phase_scan_eval, dev, host_eval_rate)
    timed(phase_scan_against_plain, dev)
    paths["training"], paths["training_eval"], host_rounds = timed(phase_training, dev)
    paths["device_dagger"], paths["device_dagger_eval"], wired = timed(phase_device_dagger, dev, host_rounds)
    resident = timed(phase_device_dagger_resident, dev, wired)
    for path in ("device_dagger_resident", "device_dagger_resident_scan", "device_dagger_resident_archive"):
        paths[path] = resident[path]
    paths.update(timed(phase_feature_bank, dev))
    paths.update(timed(phase_imported_scenes, dev))
    paths.update(timed(phase_eval_parity, dev))
    paths["train_step"] = timed(phase_train_step, dev)
    timed(phase_train_step_against_plain, dev)
    shapes = timed(phase_recollect_shapes, dev)
    paths["recollect"], paths["recollect_eval"], resim_rate = timed(phase_recollect, dev)
    paths["device_recollect"], paths["device_recollect_resident"] = timed(phase_device_recollect, dev, resim_rate)
    timed(phase_recollect_against_plain, dev)
    paths["seq2seq"], paths["seq2seq_eval"] = timed(phase_seq2seq, dev)
    wp_shapes = timed(phase_waypoint_shapes, dev)
    paths["waypoint"], paths["waypoint_eval"], wp_host = timed(phase_waypoint, dev)
    (paths["device_waypoint_clocked"], paths["device_waypoint_graph"],
     paths["device_waypoint_eval"]) = timed(phase_device_waypoint, dev, wp_host)
    timed(phase_waypoint_against_plain, dev)
    timed(phase_device_waypoint_against_plain, dev)
    paths.update(timed(phase_video, dev))
    paths.update(timed(phase_shm_ring, dev))
    paths["two_ranks"] = timed(phase_two_ranks, dev)
    for k, extra, wp in zip(kernels, (shapes["forward"], shapes["backward"], shapes["weight"], shapes["resize"]),
                            (wp_shapes["forward"], wp_shapes["backward"], wp_shapes["weight"], {})):
        k.update(extra)
        k.update(wp)
    for k in kernels:
        for path, launches in paths.items():
            k[f"launches_{path}"] = launches[k["name"]]
        k["launches"] = sum(launches[k["name"]] for launches in paths.values())
    # the goal-field kernel, on the paths whose launches of it the phases count
    field_paths = {path: launches for path, launches in paths.items() if goal_field["name"] in launches}
    for path, launches in field_paths.items():
        goal_field[f"launches_{path}"] = launches[goal_field["name"]]
    goal_field["launches"] = sum(launches[goal_field["name"]] for launches in field_paths.values())
    kernels.append(goal_field)
    assert all(k["launches"] > 0 for k in kernels), "a kernel was launched on no path"
    print(f"chip_smoke: seconds by phase {json.dumps(phase_seconds)}")
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s (the build included)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
