"""Train steps per run of the fused epoch in the traced window (the
program's `train.step` spans over its `train.run` spans): each run of equal
padded lengths ends in one read-back, so this is the steps enqueued per
drain of the device."""

from benchmark import spans


def read(ctx):
    trace = ctx.get("trace")
    runs = 0 if trace is None else spans.count(trace, "train.run")
    if not runs:
        return None
    return spans.count(trace, "train.step") / runs
