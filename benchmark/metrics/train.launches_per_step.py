"""Host launches (kernels and CUDA graphs, as the profiler counts the
runtime's launch calls) per train step of the traced window."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or not ctx.get("steps"):
        return None
    return trace.launches / ctx["steps"]
