"""The window's time outside the chunks' host set-up over the step-graph
replays it made (one replay steps every episode of a chunk once), ms."""


def read(ctx):
    if not ctx.get("replays"):
        return None
    return 1e3 * (ctx["window_s"] - ctx["setup_seconds"]) / ctx["replays"]
