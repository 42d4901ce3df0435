"""The chunks' host set-up (scenes, goal fields, instruction files, the
upload: run_scan_rollouts' `setup_seconds`) as a share of the window, %."""


def read(ctx):
    if "setup_seconds" not in ctx or ctx["window_s"] <= 0:
        return None
    return 100.0 * ctx["setup_seconds"] / ctx["window_s"]
