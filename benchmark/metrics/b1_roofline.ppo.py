"""B1 (csrc/gru_sequence.cu, `gru_sequence_kernel`) at the waypoint GRUs'
H=256 in the traced DD-PPO window: the rollout's step and bootstrap graphs
launch it twice a step at T=1 over the envs, the update twice a minibatch
at T=num_steps over the minibatch's envs (with the gates kept). The mean
least time of a launch over that mix (benchmark/roofline.py) times the
launches recorded, over their device time, %."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None:
        return None
    n, seconds = trace.kernel("gru_sequence_kernel")
    if n == 0 or seconds <= 0:
        return None
    return 100.0 * n * ctx["b1_bound_s"] / seconds
