"""The PPO updates (the program's `ppo.update` spans: the minibatch plan,
the enqueued minibatch steps and their read-back) as a share of the traced
window, %."""

from benchmark import spans


def read(ctx):
    return spans.share(ctx.get("trace"), "ppo.update", "ppo.update")
