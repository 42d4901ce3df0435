"""B2 (csrc/resize_normalize.cu, `resize_normalize_kernel`) in the rollout's
step graph, which resizes the RGB and the depth frames of a chunk's
episodes once each per step: their least time (the frames read once, the
resized frames written once) over the kernels' device time, %."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None:
        return None
    n, seconds = trace.kernel("resize_normalize_kernel")
    if n == 0 or seconds <= 0:
        return None
    return 100.0 * (n / 2.0) * ctx["b2_pair_bound_s"] / seconds
