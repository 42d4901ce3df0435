"""What one of the port's spans (`vlnce_torch.utils.profiling.annotate`)
costs the host: with no profiler recording (a check and a shared object),
and while a `torch.profiler` records (a `record_function`), over the same
loop with no span.

    python3 scripts/span_cost.py [--spans 200000] [--rounds 5]

Prints one JSON line: microseconds per span, the best of the rounds, off
and on, and the host's Python and torch versions and the card where there
is one (the profiler then records the device too, as the benchmark's
traced runs do).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from vlnce_torch.utils.profiling import annotate  # noqa: E402


def _best_us(body, n: int, rounds: int) -> float:
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        body(n)
        best = min(best, (time.perf_counter() - t0) / n)
    return best * 1e6


def _spans(n: int) -> None:
    for k in range(n):
        with annotate("train.step"):
            pass


def _bare(n: int) -> None:
    for k in range(n):
        pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spans", type=int, default=200_000)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)
    from torch.profiler import ProfilerActivity, profile

    bare = _best_us(_bare, args.spans, args.rounds)
    off = _best_us(_spans, args.spans, args.rounds)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    n_on = max(1, args.spans // 20)  # the profiler keeps every span in memory
    with profile(activities=activities):
        on = _best_us(_spans, n_on, args.rounds)
    out = {"off_us": off - bare, "on_us": on - bare, "spans_off": args.spans,
           "spans_on": n_on, "python": sys.version.split()[0], "torch": torch.__version__,
           "device": torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
