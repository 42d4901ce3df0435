"""The train step's share of the chip's peak: the forward and backward
FLOPs of the trainable parts on the bank's real (unpadded) frames over the
window, against 67 TFLOP/s, the f32 peak outside the tensor cores (the
step's products run in f32 with TF32 off), %."""

from benchmark.roofline import PEAK


def read(ctx):
    if not ctx.get("flops") or ctx["window_s"] <= 0:
        return None
    return 100.0 * ctx["flops"] / ctx["window_s"] / PEAK["f32"]
