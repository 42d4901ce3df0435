"""The control, at a size the CPU holds: the reference a precision step
below the configuration's, put in the program's place, comes out not
correct against the cell's own limits (benchmark/control.py reads it at
the cells' own sizes on the card)."""

import time

import pytest

from benchmark import harness
from benchmark.reference import cma
from benchmark.reference import train as ref_train
from benchmark.tests import small


def test_rollout_control_fails_its_limits():
    """The reference with fp8 encoders and the rest in TF32, put in the
    program's place, reads final_logit_rel 1 (the number's unit) and comes
    out not correct; the program, at the same size, reads well under every
    limit."""
    c = small.cell("rxr_cma.scan_rollout")
    runner = harness.runner(c)
    s = runner.Setup(c, time.perf_counter())
    win = runner.window(s, 0.0, max_chunks=1)
    got = runner.check(s, win, {"bf16_tf32": cma.Precision(enc="bf16", rest="tf32")})
    s.free_program()
    assert harness.passed(harness.checks(got, c.limits))
    control = harness.checks(got["controls"]["fp8"], c.limits)
    assert control["final_logit_rel"]["value"] == pytest.approx(1.0) and not harness.passed(control)
    assert set(got["controls"]) == {"fp8", "bf16_tf32"}


def test_training_control_fails_its_limits():
    c = small.cell("r2r_cma.dagger_train")
    runner = harness.runner(c)
    s = runner.Setup(c, time.perf_counter())
    batches = s.check_rows()
    ref = ref_train.adam_steps(s.W, s.arch, batches, lr=float(s.config.IL.lr))
    tf32 = ref_train.adam_steps(s.W, s.arch, batches, lr=float(s.config.IL.lr), prec=cma.Precision(rest="tf32"))
    program, control = ref_train.compare(s.first, ref), ref_train.compare(tf32, ref)
    limits = {k: v["limit"] for k, v in c.limits["checks"].items()}
    assert all(program[k] <= limits[k] for k in program)
    assert any(control[k] > limits[k] for k in control)
