"""The reading of a `torch.profiler` trace: the device's busy time as the
union of its operations' intervals (kernels on several streams overlap, so
a sum of kernel times would count some twice), kernel times and counts by
name, host launches, and the idle gaps named by what the host was doing.
The device's operations are its kernels, copies and fills; the mirrors of
`record_function` spans on the device's timeline are not."""

from __future__ import annotations

import bisect
import re
from typing import Dict, List, Optional, Tuple

_LAUNCH = re.compile(r"^(cuda|cu)(LaunchKernel|LaunchKernelEx|LaunchKernelExC|LaunchCooperativeKernel|GraphLaunch)(_v\d+)?$")
_SHORT_GAP_NS = 5_000


def short_name(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", name)[:64]


class Trace:
    """What a profiled window shows. `begin_ns` and `end_ns` bound the
    window on the profiler's clock (Unix nanoseconds)."""

    def __init__(self, events, begin_ns: int, end_ns: int):
        self.begin, self.end = int(begin_ns), int(end_ns)
        dev: List[Tuple[int, int, str]] = []
        self.cpu: List[Tuple[int, int, str]] = []
        self.launches = 0
        events = list(events)
        for e in events:
            kind = str(e.device_type())
            start, dur = int(e.start_ns()), int(e.duration_ns())
            if "CUDA" in kind:
                dev.append((start, start + dur, e.name()))
            else:
                name = e.name()
                if _LAUNCH.match(name):
                    self.launches += 1
                self.cpu.append((start, start + dur, name))
        # record_function's spans are mirrored on the device's timeline under
        # the host span's name: they are no operation of the device
        host_names = {name for _, _, name in self.cpu}
        self.device = sorted(d for d in dev if d[2] not in host_names)
        self.cpu.sort(key=lambda e: (e[0], -e[1]))  # at one start, the outer event first
        self._starts = [e[0] for e in self.cpu]
        self.kernels: Dict[str, List[float]] = {}
        for s, t, name in self.device:
            k = self.kernels.setdefault(name, [0, 0.0])
            k[0] += 1
            k[1] += (t - s) / 1e9
        self._union = self._merge()

    def _merge(self) -> List[Tuple[int, int]]:
        out: List[List[int]] = []
        for s, t, _ in self.device:
            s, t = max(s, self.begin), min(t, self.end)
            if t <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t)
            else:
                out.append([s, t])
        return [(a, b) for a, b in out]

    @property
    def window_s(self) -> float:
        return (self.end - self.begin) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._union) / 1e9

    def kernel(self, fragment: str) -> Tuple[int, float]:
        """(launches, device seconds) of the kernels whose name holds `fragment`."""
        n, s = 0, 0.0
        for name, (count, secs) in self.kernels.items():
            if fragment in name:
                n, s = n + count, s + secs
        return n, s

    def device_ops(self, k: int = 10) -> List[List]:
        top = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:k]
        return [[short_name(name), secs] for name, (_, secs) in top]

    def _host_at(self, t: int) -> Optional[str]:
        """The innermost host event running at t (the latest-starting one of
        those that cover it, looked for among the 4,000 that start last
        before t)."""
        i = bisect.bisect_right(self._starts, t)
        best = None
        for s, e, name in reversed(self.cpu[max(0, i - 4000) : i]):
            if e >= t:
                best = name
                break
        return best

    def idle_gaps(self, k: int = 10) -> List[List]:
        """Idle seconds by the host event under each gap's midpoint; gaps under
        5 us are summed under one name."""
        edges = [self.begin] + [x for ab in self._union for x in ab] + [self.end]
        by: Dict[str, float] = {}
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            name = "gaps_under_5us" if b - a < _SHORT_GAP_NS else (self._host_at((a + b) // 2) or "no_host_event")
            by[name] = by.get(name, 0.0) + (b - a) / 1e9
        return [[short_name(n), s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:k]]


def read(prof, begin_ns: int, end_ns: int) -> Trace:
    return Trace(prof.profiler.kineto_results.events(), begin_ns, end_ns)
