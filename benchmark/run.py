"""Runs one cell of the port's benchmark once and prints its result.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout with one NVIDIA card per chip the cell asks
for. With --trace 0 the result's metrics are the cell's end-to-end metrics
(BENCHMARK.json), with --trace 1 its per-layer metrics, read from a
torch.profiler trace of a shorter window. The last line of standard output
is one JSON object (correct, attempted, failed, metrics, device, and with a
trace the breakdown, then the compared numbers beside their limits under
"checks"); the last lines of standard error repeat those numbers. Without
a card, with fewer cards than the cell asks for, or with JAX or the JAX
package loaded, it prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # the process's start, as near as Python lets us see it

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

if __package__ in (None, ""):  # run as a file: the checkout's root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _fail(message: str, code: int = 2) -> int:
    print(f"benchmark: {message}", file=sys.stderr)
    return code


def per_layer_names(spec, workload: str, reported_e2e) -> list:
    out = []
    for m in spec["per_layer"]:
        if "workloads" in m:
            if workload in m["workloads"]:
                out.append(m["name"])
        elif m["moves"] in reported_e2e:
            out.append(m["name"])
    return out


def e2e_names(spec, workload: str) -> list:
    return [m["name"] for m in spec["end_to_end"] if "workloads" not in m or workload in m["workloads"]]


def assemble(spec, cell, outcome) -> dict:
    """The result's line: correct, attempted, failed, the metrics (the
    cell's end-to-end ones, or with a trace its per-layer ones), the device,
    with a trace the breakdown, and last the compared numbers and limits."""
    unit = {m["name"]: m["unit"] for m in spec["end_to_end"] + spec["per_layer"]}
    e2e = e2e_names(spec, cell.workload)
    metrics = {}
    if not cell.trace:
        values = {**outcome["e2e"], "setup_s": outcome["setup_s"]}
        for name in e2e:
            metrics[name] = {"value": float(values[name]), "unit": unit[name]}
    else:
        for name in per_layer_names(spec, cell.workload, e2e):
            value = harness.metric_reader(name).read(outcome["ctx"])
            if value is not None:
                metrics[name] = {"value": float(value), "unit": unit[name]}
    compared = harness.checks(outcome["compared"], cell.limits)
    result = {"correct": harness.passed(compared) and outcome["failed"] == 0, "attempted": int(outcome["attempted"]),
              "failed": int(outcome["failed"]), "metrics": metrics, "device": dict(outcome["device"])}
    trace = outcome["ctx"].get("trace")
    if trace is not None:
        result["device"].update(busy_s=trace.busy_s, window_s=trace.window_s)
        result["breakdown"] = {"device_ops": trace.device_ops(), "idle_gaps": trace.idle_gaps()}
    result["checks"] = compared
    return result


def main(argv=None) -> int:
    args = _parse(argv)
    harness.set_environment()
    try:
        spec = harness.benchmark_spec()
        cell = harness.load_cell(args.workload, args.seed, args.seconds, bool(args.trace), spec)
    except (OSError, KeyError, ValueError) as e:
        return _fail(f"cannot read the benchmark's files: {e!r}")
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        return _fail("no CUDA device: this benchmark measures the card and never falls back to the CPU")
    if torch.cuda.device_count() < cell.chips:
        return _fail(f"the cell asks for {cell.chips} cards, {torch.cuda.device_count()} present")
    try:
        import vlnce_torch  # noqa: F401
    except ImportError as e:
        return _fail(f"the program (vlnce_torch) is not in this checkout: {e}")
    print(f"benchmark: {cell.workload} seed {cell.seed}; torch and the program imported at "
          f"{time.perf_counter() - T0:.3f} s", file=sys.stderr)

    outcome = harness.runner(cell).run(cell, T0)
    result = assemble(spec, cell, outcome)
    compared = result["checks"]

    found = harness.forbidden_modules()
    if found:
        return _fail(f"JAX or the JAX package was loaded in this process: {found}", 3)
    print(f"card: {harness.power_limit()}", file=sys.stderr)
    for name, c in compared.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
