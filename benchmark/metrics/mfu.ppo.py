"""The whole DD-PPO update's share of the chip's peak: the least time of
the model's FLOPs of the window's updates (the rollout's forwards, the
update's backbone recompute at the bf16 peak, the trainable parts' forward
and backward at the f32 peak; benchmark/roofline_wpn.py) over the
window, %."""


def read(ctx):
    if not ctx.get("updates") or ctx["window_s"] <= 0:
        return None
    return 100.0 * ctx["least_s"] / ctx["window_s"]
