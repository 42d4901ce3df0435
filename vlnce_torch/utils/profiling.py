"""Profiling: torch.profiler traces and the program's spans in them, the
reference's wall-clock split, and the train step's split on the card (port
of vlnce_tpu/utils/profiling.py).

The reference logs pth_time (device compute) vs env_time (sim stepping) per
rollout (reference ddppo_waypoint_trainer.py:154-157,187-188,222-225);
trainers here keep that split and can additionally capture a device trace
into CUDA.PROFILE_DIR (a chrome trace, readable by tensorboard's profile
plugin or chrome://tracing): training and the on-card eval and inference.

Spans (`annotate`) record exactly while a `torch.profiler` records, on
the profiler's clock beside the device's kernels and copies; otherwise a
span does nothing. They sit where the work happens:
- the scan rollout (trainers/scan_eval.run_scan_rollouts): `scan.chunk`
  per chunk, holding `scan.setup` (`scan.instructions`, `scan.scenes` for
  the host's scene arrays, `scan.upload`, then `scan.scenes` again holding
  `scan.field_build`, the goal fields' build on the device, and
  `scan.bank`), `scan.load`, and per segment `scan.replays` and
  `scan.readback`; `scan.capture` around a step graph's capture. The
  set-up's spans open in shared code, so they fire wherever it runs:
  `scan.instructions`, `scan.scenes`, `scan.upload` and `scan.field_build`
  in the on-card DAgger collection too (trainers/device_dagger,
  `chunk_tensors`), `scan.field_build` in device_recollect
  (envs/device_sim.scene_batch), and `scan.goal_field` at every miss of a
  scene's distance-field cache (envs/gridworld): the host simulators'
  Dijkstra, which the loops on the card no longer run;
- the fused DAgger epoch (data/device_bank.run_fused_epoch): `train.plan`,
  then per run `train.run` holding `train.run_upload`, a `train.step` per
  step (`train.gather`, then the IL step's `il.forward`, `il.backward`,
  `il.optimizer`) and `train.readback`; the per-batch IL step
  (trainers/base_trainer._il_update) opens `train.upload` and `train.step`;
- DD-PPO (rl/device_rollout, rl/ppo): `ppo.bank` around the episode
  bank's build, holding `ppo.field_build` (its goal fields on the device);
  per rollout on the card `ppo.rollout` holding `ppo.load`, `ppo.replays`
  and `ppo.readback` (the host rollout: `ppo.rollout` alone); per update
  `ppo.update`, holding on the card `ppo.plan`, `ppo.minibatches` and
  `ppo.update_readback`;
- DAgger's host collection (`collect_step`).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict, deque
from typing import Deque, Dict, Iterator, Optional, Tuple

import torch


class SectionTimers:
    """Named wall-clock accumulators (pth_time / env_time / update_time)."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def time(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0

    def summary(self) -> str:
        return " ".join(f"{k}={v:.1f}s" for k, v in sorted(self.totals.items()))


class StepClock:
    """Splits a repeated step into named segments by the device's clock.
    `start()` opens a step and `mark(name)` ends the segment `name`; on a
    CUDA device each is one event record on the current stream (no
    synchronisation), on the CPU a host clock reading. Segments whose end
    the device has passed are folded into the sums as the steps go, so a
    long run holds few events. `totals()` synchronises once and returns
    {name: ms summed over all steps}; `first` holds the first step's share
    of them (it carries the libraries' warm-up), and `steps` counts the
    `start()` calls."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.steps = 0
        self._last = None
        self._segments: Deque[Tuple[str, int, object, object]] = deque()
        self._totals: Dict[str, float] = defaultdict(float)
        self.first: Dict[str, float] = defaultdict(float)

    def _now(self):
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def _fold(self, wait: bool) -> None:
        while self._segments and (wait or not self.cuda or self._segments[0][3].query()):
            name, step, begin, end = self._segments.popleft()
            ms = begin.elapsed_time(end) if self.cuda else 1e3 * (end - begin)
            self._totals[name] += ms
            if step == 1:
                self.first[name] += ms

    def start(self) -> None:
        self.steps += 1
        self._fold(wait=False)
        self._last = self._now()

    def mark(self, name: str) -> None:
        now = self._now()
        self._segments.append((name, self.steps, self._last, now))
        self._last = now

    def totals(self) -> Dict[str, float]:
        if self.cuda:
            torch.cuda.synchronize()
        self._fold(wait=True)
        return dict(self._totals)


@contextlib.contextmanager
def maybe_profile(profile_dir: Optional[str]) -> Iterator[None]:
    """Capture a torch.profiler trace (host and, where there is a card,
    device activity) into profile_dir/trace.json when profile_dir is set."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


class _NoSpan:
    """The span of `annotate` while no profiler records: nothing."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        return None


_NO_SPAN = _NoSpan()
_profiler_enabled = torch._C._autograd._profiler_enabled


def annotate(name: str):
    """A named span in the profiler's trace, for a `with` statement: a
    `torch.profiler.record_function(name)` while a profiler records on this
    thread, else a shared object that does nothing (one check, about half a
    microsecond). Spans nest: a span's parent is the span around it, so the
    `scan.chunk` or `train.run` around a span says which chunk or run it
    belongs to. Open none inside a CUDA graph's capture."""
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN
