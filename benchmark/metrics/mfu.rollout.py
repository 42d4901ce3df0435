"""The whole rollout step's share of the chip's peak: the least time of
the model's FLOPs of every env step in the window (the two ResNet50s at
the bf16 peak, the instruction LSTM and everything after the backbones at
the f32 peak; benchmark/roofline.py) over the window, %."""


def read(ctx):
    if not ctx.get("env_steps") or ctx["window_s"] <= 0:
        return None
    return 100.0 * ctx["least_s"] / ctx["window_s"]
