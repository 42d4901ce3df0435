"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's), and the reference imports nothing of the program."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_RUNS = """
import sys
from benchmark import harness, run, control, program
for w in ("rxr_cma.scan_rollout", "r2r_cma.dagger_train"):
    harness.runner(harness.load_cell(w, 1, 1.0, False))
for m in harness.benchmark_spec()["per_layer"]:
    harness.metric_reader(m["name"])
import vlnce_torch.trainers.scan_eval, vlnce_torch.data.device_bank, vlnce_torch.parallel.il_step
program._registries()
print(sorted({m.split(".")[0] for m in sys.modules}))
"""

_REFERENCE = """
import sys
import benchmark.reference.cma, benchmark.reference.grid, benchmark.reference.train
import benchmark.roofline, benchmark.weights, benchmark.generate, benchmark.trace
print(sorted({m.split(".")[0] for m in sys.modules}))
"""


def _top_level(code):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_no_jax_in_what_the_benchmark_runs():
    names = _top_level(_RUNS)
    assert "vlnce_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "vlnce_tpu"}


def test_reference_imports_nothing_of_the_program():
    names = _top_level(_REFERENCE)
    assert not names & {"vlnce_torch", "vlnce_tpu", "jax", "jaxlib", "flax"}
