"""The chunks' Dijkstra goal fields, built on the host in set-up (the
program's `scan.goal_field` spans), as a share of the traced window, %."""

from benchmark import spans


def read(ctx):
    return spans.share(ctx.get("trace"), "scan.goal_field", "scan.chunk")
