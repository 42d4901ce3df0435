"""Host launches (kernels and CUDA graphs, as the profiler counts the
runtime's launch calls) inside the program's `ppo.update` spans, over the
minibatch steps the window took (WDDPPO's `minibatch_steps`)."""

from benchmark import spans
from benchmark.trace import _LAUNCH


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or not ctx.get("minibatch_steps"):
        return None
    updates = spans.intervals(trace, "ppo.update")
    if not updates:
        return None
    launches = sum(1 for s, e, n in trace.cpu if _LAUNCH.match(n) and any(a <= s and e <= b for a, b in updates))
    return launches / ctx["minibatch_steps"]
