"""The rollouts' steps on the card, ms a step: the seconds of the
program's `ppo.replays` spans (the uniforms' draw, the T step-graph
replays and the bootstrap graph, enqueued) and `ppo.readback` spans (the
one read-back, which waits for the card to finish them), over the env
steps replayed (the collector's `replays`, T a rollout)."""

from benchmark import spans


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or not ctx.get("replays") or not spans.count(trace, "ppo.replays"):
        return None
    return 1e3 * (spans.seconds(trace, "ppo.replays") + spans.seconds(trace, "ppo.readback")) / ctx["replays"]
