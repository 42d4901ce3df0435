"""The chunks' one upload in set-up (pinned buffer, packing, host-to-device
copy: the program's `scan.upload` spans), as a share of the traced
window, %."""

from benchmark import spans


def read(ctx):
    return spans.share(ctx.get("trace"), "scan.upload", "scan.chunk")
