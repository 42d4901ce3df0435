"""B1's backward recurrence (csrc/gru_sequence.cu,
`gru_sequence_backward_cluster_kernel`, two launches per train step, one
per GRU) in the traced training window: the mean least time of a launch
at its step's padded length (benchmark/roofline.py) times the launches
recorded, over their device time, %."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None:
        return None
    n, seconds = trace.kernel("gru_sequence_backward_cluster_kernel")
    if n == 0 or seconds <= 0:
        return None
    return 100.0 * n * ctx["b1_bwd_bound_s"] / seconds
