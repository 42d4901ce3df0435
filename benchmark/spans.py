"""The program's own spans in a traced window (`vlnce_torch.utils.profiling.
annotate`, recorded while the profiler records): the host events of a name,
clipped to the window, and their split by name (`split`, printed by
`scripts/span_split.py`). A program without the spans shows none."""

from __future__ import annotations

import bisect
from typing import Dict, List, Tuple


def intervals(trace, name: str) -> List[Tuple[int, int]]:
    """(start_ns, end_ns) of each host event named `name` that overlaps the
    window, clipped to it."""
    out = []
    for s, e, n in trace.cpu:
        if n == name:
            s, e = max(s, trace.begin), min(e, trace.end)
            if e > s:
                out.append((s, e))
    return out


def count(trace, name: str) -> int:
    return len(intervals(trace, name))


def seconds(trace, name: str) -> float:
    return sum(e - s for s, e in intervals(trace, name)) / 1e9


def share(trace, name: str, loop: str):
    """The seconds of the spans `name` over the window, %, where the loop's
    span `loop` is in the window; else None."""
    if trace is None or trace.window_s <= 0 or not count(trace, loop):
        return None
    return 100.0 * seconds(trace, name) / trace.window_s


PROGRAM = ("scan.", "train.", "il.")


def split(trace, prefixes=PROGRAM) -> List[Dict]:
    """By span name, the program's spans in the window (clipped to it): their
    count, seconds, self seconds (less the spans directly inside them) and
    the seconds the device was idle under them; most seconds first."""
    spans = sorted(((max(s, trace.begin), min(e, trace.end), n) for s, e, n in trace.cpu
                    if n.startswith(prefixes) and e > trace.begin and s < trace.end), key=lambda x: (x[0], -x[1]))
    inner = [0] * len(spans)
    stack: List[int] = []
    for i, (s, e, _) in enumerate(spans):
        while stack and spans[stack[-1]][1] <= s:
            stack.pop()
        if stack and e <= spans[stack[-1]][1]:
            inner[stack[-1]] += e - s
        stack.append(i)
    busy = trace._union
    starts = [a for a, _ in busy]
    by: Dict[str, Dict] = {}
    for (s, e, n), covered in zip(spans, inner):
        on = 0
        for a, b in busy[max(0, bisect.bisect_right(starts, s) - 1) : bisect.bisect_left(starts, e)]:
            on += max(0, min(b, e) - max(a, s))
        row = by.setdefault(n, {"name": n, "n": 0, "s": 0.0, "self_s": 0.0, "idle_s": 0.0})
        row["n"] += 1
        row["s"] += (e - s) / 1e9
        row["self_s"] += (e - s - covered) / 1e9
        row["idle_s"] += (e - s - on) / 1e9
    return sorted(by.values(), key=lambda r: -r["s"])
