"""The traced host duration of one train step of the fused epoch (the
program's `train.step` spans: gather, forward, backward, optimizer), mean
over the traced steps, ms. It is read only in a traced run, so it holds the
profiler's cost of recording each of the step's operators, and any wait of
the host on the device inside the step; it is not the untraced step time
(PERF.md §5 gives both)."""

from benchmark import spans


def read(ctx):
    trace = ctx.get("trace")
    steps = [] if trace is None else spans.intervals(trace, "train.step")
    if not steps:
        return None
    return sum(e - s for s, e in steps) / len(steps) / 1e6
