"""B1 (csrc/gru_sequence.cu, `gru_sequence_kernel`) in the rollout's step
graph: its least time from its shapes (one step of the chunk's episodes at
the GRUs' width; benchmark/roofline.py) over its device time in the trace,
%. Nothing where the trace has no such kernel."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None:
        return None
    n, seconds = trace.kernel("gru_sequence_kernel")
    if n == 0 or seconds <= 0:
        return None
    return 100.0 * n * ctx["b1_bound_s"] / seconds
