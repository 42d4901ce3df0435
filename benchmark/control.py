"""The readings that the limits of `correct` are set from, at a cell's own
size, on the card: for each seed, the numbers a run compares, and the
same numbers for the controls (the reference a precision step below the
configuration's, put in the program's place) and for the planted faults,
each judged against the cell's limits as a run judges the program. One
build of the program serves every seed.

    python3 -m benchmark.control --workload <name> --first-seed <n> --seeds 12

Prints one JSON line per seed, then a summary line: the largest reading of
the program (the lower reading of each limit) and the smallest of each
control and fault (the upper readings), and whether each came out
correct on every seed. The benchmark's own runs never run this.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from benchmark import harness  # noqa: E402

FAULT_SEEDS = 3  # seeds on which each planted fault is read


def _judged(cell, numbers):
    compared = harness.checks(numbers, cell.limits)
    return {"numbers": {k: c["value"] for k, c in compared.items()}, "correct": harness.passed(compared)}


def rollout(cell, seeds):
    """Per seed: the program; the reference in its place with fp8 encoders
    and the rest in TF32 (the unit of the numbers: it reads
    `final_logit_rel` 1), with the configuration's bf16 encoders and the
    rest in TF32, and with f32 encoders and the rest in TF32 (what TF32
    alone moves). On the first seeds: the program with its TF32 switched
    on (the graph captured anew), and the program committing a wrong
    action in one row (the first row's mode moved to the next action,
    never STOP)."""
    import torch

    from benchmark.reference import cma
    from vlnce_torch.trainers import scan_eval

    runner = harness.runner(cell)
    controls = {"bf16_tf32": cma.Precision(enc="bf16", rest="tf32"), "tf32_only": cma.Precision(rest="tf32")}
    s = runner.Setup(cell, T0)
    for k, seed in enumerate(seeds):
        if k:
            s.reseed(seed)
        got = runner.check(s, runner.window(s, 0.0, max_chunks=1), controls)
        line = {"seed": seed, "program": _judged(cell, got)}
        line.update({name: _judged(cell, c) for name, c in got["controls"].items()})
        line["rms"] = {"program": got["program_rms"], "fp8": got["unit_rms"],
                       **{name: c["rms"] for name, c in got["controls"].items()}}
        yield line
    for seed in seeds[:FAULT_SEEDS]:
        s.trainer.policy.__dict__.pop(scan_eval._CACHE_ATTR, None)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        s.reseed(seed)
        got = runner.check(s, runner.window(s, 0.0, max_chunks=1))
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        yield {"seed": seed, "program_tf32_on": _judged(cell, got)}
    s.free_program()

    class OneRowOff(scan_eval.Categorical):
        def mode(self):
            a = super().mode().clone()
            a[0] = torch.remainder(a[0], self.logits.shape[-1] - 1) + 1
            return a

    scan_eval.Categorical = OneRowOff
    s = runner.Setup(cell, T0)
    for k, seed in enumerate(seeds[:FAULT_SEEDS]):
        if k:
            s.reseed(seed)
        yield {"seed": seed, "one_row_off": _judged(cell, runner.check(s, runner.window(s, 0.0, max_chunks=1)))}
    s.free_program()


def _label_altered(batch):
    """The batch with its first row's first label moved to the next action,
    its weights as they were: the fault of a label altered where it is
    gathered, planted in the reference put in the program's place."""
    oracle = batch["oracle"].clone()
    oracle[0, 0] = (oracle[0, 0] + 1) % 4
    return {**batch, "oracle": oracle}


def training(cell, seeds):
    """Per seed: the program; the reference in TF32 in its place (the
    control); and the reference with half of each batch left out and with
    one label altered, in its place (the faults)."""
    from benchmark.reference import cma
    from benchmark.reference import train as ref_train

    runner = harness.runner(cell)
    s = runner.Setup(cell, T0)
    lr = float(s.config.IL.lr)
    for k, seed in enumerate(seeds):
        if k:
            s.reseed(seed)
        batches = s.check_rows()
        ref = ref_train.adam_steps(s.W, s.arch, batches, lr=lr)
        tf32 = ref_train.adam_steps(s.W, s.arch, batches, lr=lr, prec=cma.Precision(rest="tf32"))
        half = [{k2: (v[:, : s.N // 2] if k2 != "tokens" else v[: s.N // 2]) for k2, v in b.items()} for b in batches]
        halved = ref_train.adam_steps(s.W, s.arch, half, lr=lr)
        altered = ref_train.adam_steps(s.W, s.arch, [_label_altered(b) for b in batches], lr=lr)
        worst = {}
        for kind, run_, keep in (("grad", "grad", list(ref["grad"])), ("delta", "delta", ref_train.moved_leaves(ref))):
            gaps = ref_train.leaf_gaps(s.first[run_], ref[run_], keep)
            worst[kind] = sorted(gaps, key=gaps.get)[-3:]
        finite = {"nonfinite_losses": 0.0, "tf32_switched_on": 0.0}
        yield {"seed": seed, "program": _judged(cell, {**ref_train.compare(s.first, ref), **finite}),
               "control": _judged(cell, {**ref_train.compare(tf32, ref), **finite}),
               "half_batch": _judged(cell, {**ref_train.compare(halved, ref), **finite}),
               "label_altered": _judged(cell, {**ref_train.compare(altered, ref), **finite}),
               "worst_leaves": {**worst, "left_out": sorted(set(ref["grad"]) - set(ref_train.moved_leaves(ref)))}}


def summarize(lines):
    """Per role: the largest reading of the program and the smallest of
    every other role, number by number, and whether the role came out
    correct on every seed it was read on."""
    out = {}
    for line in lines:
        for role, got in line.items():
            if not isinstance(got, dict) or "numbers" not in got:
                continue
            pick = max if role == "program" else min
            r = out.setdefault(role, {"numbers": dict(got["numbers"]), "correct_on_every_seed": True, "seeds": 0})
            r["numbers"] = {k: pick(v, got["numbers"][k]) for k, v in r["numbers"].items()}
            r["correct_on_every_seed"] &= got["correct"]
            r["seeds"] += 1
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--first-seed", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    args = ap.parse_args(argv)
    harness.set_environment()
    cell = harness.load_cell(args.workload, args.first_seed, 0.0, False)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    kind = {"scan_rollout": rollout, "dagger_train": training}[cell.traffic["runner"]]
    lines = []
    for line in kind(cell, seeds):
        lines.append(line)
        print(json.dumps(line), flush=True)
    print(json.dumps({"summary": summarize(lines), "seeds": len(seeds), "device": harness.power_limit()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
