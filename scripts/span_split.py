"""Where a benchmark cell's traced window goes, by the program's spans: one
traced run of the cell (`benchmark.run --trace 1`'s window), then per span
name its count, seconds, self seconds and the seconds the card sat idle
under it (`benchmark/spans.split`).

    python3 scripts/span_split.py --workload <cell> --seed <n> [--seconds 45]

From the root of a checkout, on a machine with the cell's card. Prints a
table, then one JSON line: the cell, the seed, the window's seconds, the
card's busy seconds and the rows.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

T0 = time.perf_counter()

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness, spans  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=45.0)
    args = ap.parse_args(argv)
    harness.set_environment()
    cell = harness.load_cell(args.workload, args.seed, args.seconds, True)
    import torch

    torch.set_num_threads(1)
    trace = harness.runner(cell).run(cell, T0)["ctx"]["trace"]
    rows = spans.split(trace, spans.PROGRAM + ("ppo.",))
    print(f"{'span':<20} {'n':>6} {'s':>10} {'self s':>10} {'idle s':>10} {'ms each':>10}")
    for r in rows:
        print(f"{r['name']:<20} {r['n']:>6} {r['s']:>10.4f} {r['self_s']:>10.4f} {r['idle_s']:>10.4f} "
              f"{1e3 * r['s'] / r['n']:>10.3f}")
    print(json.dumps({"workload": cell.workload, "seed": cell.seed, "window_s": trace.window_s,
                      "busy_s": trace.busy_s, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
