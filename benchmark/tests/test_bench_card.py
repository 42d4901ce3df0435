"""Each cell for a few seconds on the card, through the command the
checks run. Skips where there is no card (decided inside the test)."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["r2r_cma.dagger_train", "rxr_cma.scan_rollout"])
def test_cell_runs_correct_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", workload, "--seed", "3000000123",
                          "--seconds", "3", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["attempted"] > 0 and line["failed"] == 0
