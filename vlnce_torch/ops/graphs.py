"""CUDA graph capture for the port's loops on the card: the one capture
routine (`capture`), the captured env step of the closed loops
(`StepGraph`), the FIFO that keeps built graphs (`cached_in`) and the
kernel wrappers' launch counters (`launch_counts`).

Every loop that replays a graph captures it here: the scan eval and
inference loop, the on-card DAgger collection and the recollection render
(trainers/, data/) through `StepGraph`, the DD-PPO rollout
(rl/device_rollout) through two `StepGraph`s, and the PPO minibatch step
(rl/ppo.MinibatchGraph) through `capture` itself. A replay runs the
captured kernels without calling their wrappers, so the wrappers' counters
count a capture's launches once, at the capture: `capture` returns that
record, and each replay runs it again.
"""

from __future__ import annotations

import gc
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from vlnce_torch.utils.profiling import annotate


def launch_counts() -> Dict[str, int]:
    """Each kernel wrapper's launches so far (a replay counts none)."""
    from vlnce_torch.ops import goal_field, preprocess, rnn

    return {"gru_sequence": rnn.gru_sequence.launches, "gru_sequence_backward": rnn.gru_sequence_backward.launches,
            "gru_weight_gradient": rnn.gru_weight_gradient.launches,
            "fused_resize_normalize": preprocess.fused_resize_normalize.launches,
            "goal_distance_fields": goal_field.goal_distance_fields.launches}


def capture(fn: Callable[[], Any], stream: Optional[torch.cuda.Stream] = None
            ) -> Tuple[torch.cuda.CUDAGraph, Any, Dict[str, int], float]:
    """`fn()` captured in a CUDA graph on `stream` (torch's own capture
    stream where None). Returns (the graph, fn's outputs, each kernel
    wrapper's launches recorded by the capture, the capture's seconds). A
    capture that fails raises."""
    t0 = time.perf_counter()
    before = launch_counts()
    graph = torch.cuda.CUDAGraph()
    # the collector stays off during the capture: on the card a collection
    # inside it invalidated the capture (cudaErrorStreamCaptureInvalidated,
    # first reported by cuDNN as CUDNN_STATUS_INTERNAL_ERROR), in some runs
    # of tests/test_torch_kernels.py::test_rollout_graph_matches_eager
    collecting = gc.isenabled()
    gc.disable()
    try:
        # thread_local: another thread may launch work meanwhile (recollection
        # captures its render step on the trainer's prefetch thread)
        with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
            out = fn()
    finally:
        if collecting:
            gc.enable()
    launches = {k: v - before[k] for k, v in launch_counts().items()}
    return graph, out, launches, time.perf_counter() - t0


class StepGraph:
    """One env step of a closed loop, run n times per segment.

    `compute()` reads the loop's state from fixed tensors and returns the
    step's results; `commit(results)` writes them back in place. On a CUDA
    device (unless `eager`) the step is warmed up once on a side stream (the
    kernels' builds, their tables' uploads and the libraries' plans happen
    there), then `commit(compute())` is captured in a CUDA graph (span
    `scan.capture`) and each step is one replay; a failed capture raises.
    Elsewhere, or with `eager` (for comparisons only), each step runs the
    ops eagerly. `capture_launches` holds each kernel wrapper's launches
    recorded by the capture: each replay runs them again. `capture_seconds`
    counts the warm-up and the capture."""

    def __init__(self, compute: Callable, commit: Callable, device: torch.device, eager: bool = False):
        self.compute, self.commit = compute, commit
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.replays = 0
        self.capture_launches: Dict[str, int] = {}
        self.capture_seconds = 0.0
        if device.type == "cuda" and not eager:
            with annotate("scan.capture"):
                self._capture(device)

    @torch.no_grad()
    def _capture(self, device) -> None:
        t0 = time.perf_counter()
        main = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self.compute()  # warm-up: its results are dropped, the state is unchanged
        main.wait_stream(side)
        warm_up = time.perf_counter() - t0
        self.graph, _, self.capture_launches, seconds = capture(lambda: self.commit(self.compute()))
        self.capture_seconds = warm_up + seconds

    @torch.no_grad()
    def run(self, n: int) -> None:
        for _ in range(n):
            if self.graph is not None:
                self.graph.replay()
            else:
                self.commit(self.compute())
        self.replays += n


def cached_in(cache: Dict, key: tuple, build: Callable, limit: int):
    """cache[key], built on a miss; a FIFO of at most `limit` entries."""
    if key not in cache:
        while len(cache) >= limit:
            cache.pop(next(iter(cache)))
        cache[key] = build()
    return cache[key]
