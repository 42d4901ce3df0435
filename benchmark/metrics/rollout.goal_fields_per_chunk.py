"""Dijkstra goal fields built per chunk of the traced window (the program's
`scan.goal_field` spans over its `scan.chunk` spans): the goals the
scenes' field caches missed."""

from benchmark import spans


def read(ctx):
    trace = ctx.get("trace")
    chunks = 0 if trace is None else spans.count(trace, "scan.chunk")
    if not chunks:
        return None
    return spans.count(trace, "scan.goal_field") / chunks
