"""The chunks' instruction inputs made on the host in set-up (the RxR
sensor reading the feature files, or the token ids: the program's
`scan.instructions` spans), as a share of the traced window, %."""

from benchmark import spans


def read(ctx):
    return spans.share(ctx.get("trace"), "scan.instructions", "scan.chunk")
