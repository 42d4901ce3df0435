"""The readings that the limits of `correct` of the DD-PPO cells are set
from, at the cell's own size, on the card: for each seed, the numbers a
run compares (benchmark/runners/ddppo_train.check), and the same numbers
for the controls (the reference a precision step below the
configuration's, put in the program's place: fp8 encoders with the rest
in TF32, the unit of the rollout's gaps; bf16 encoders with the rest in
TF32; f32 encoders with the rest in TF32, what TF32 alone moves) and for
the planted faults (the reference with the probability ratio unclipped;
the reference drawing the first row's next pano; the program with TF32
switched on; the program's step moved 5 cm along x; the program's
minibatch steps on the first half of each minibatch's steps), each judged
against the cell's limits as a run judges the program. One build of the
program serves every seed.

    python3 -m benchmark.control_ppo --workload wpn.ddppo_train --first-seed <n> --seeds 12

Prints one JSON line per seed, then a summary line (benchmark/control.py's
`summarize`): the largest reading of the program and the smallest of each
control and fault, whether each came out correct on every seed, and on how
many it did. The benchmark's own runs never run this.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.control import FAULT_SEEDS, _judged, summarize  # noqa: E402


def half_batch(step):
    """A planted fault: the minibatch step `step` (WDDPPO's) on the first
    half of the minibatch's T steps, the rest of the batch left out of
    training."""

    def halved(sample, clip_param, T, mark):
        keep = max(T // 2, 1)
        obs, hidden0, actions, prev_actions, *rest = sample

        def cut(tree):
            return {k: v[:keep] for k, v in tree.items()}

        return step((cut(obs), hidden0, cut(actions), cut(prev_actions), *(v[:keep] for v in rest)), clip_param, keep, mark)

    return halved


def ppo(cell, seeds, s=None):
    """The lines of the seeds, on the runner's Setup `s` (one is built
    where it is None)."""
    import torch

    from benchmark.reference import cma

    runner = harness.runner(cell)
    controls = {"bf16_tf32": cma.Precision(enc="bf16", rest="tf32"), "tf32_only": cma.Precision(rest="tf32")}
    if s is None:
        s = runner.Setup(cell, T0)
    for seed in seeds:
        if seed != s.seed:
            s.reseed(seed)
        got = runner.check(s, s.first, controls, faults=True)
        finite = {"nonfinite_losses": 0.0}
        line = {"seed": seed, "program": _judged(cell, {**got, **finite})}
        line.update({name: _judged(cell, {**c, **finite}) for name, c in got["controls"].items()})
        line.update({name: _judged(cell, {**c, **finite}) for name, c in got["faults"].items()})
        line["rms"] = got["rms"]
        yield line
    for seed in seeds[:FAULT_SEEDS]:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        s.reseed(seed)
        got = runner.check(s, s.first)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        yield {"seed": seed, "program_tf32_on": _judged(cell, {**got, "nonfinite_losses": 0.0})}
    from vlnce_torch.rl import device_rollout

    step = device_rollout.waypoint_step

    def moved(*args, **kwargs):
        pos, heading = step(*args, **kwargs)
        shift = torch.zeros_like(pos)  # made on the device: the step graph's capture copies nothing from the host
        shift[:, 0] = 0.05
        return pos + shift, heading

    device_rollout.waypoint_step = moved  # captured into the step graph of the collector reseed builds
    try:
        for seed in seeds[:FAULT_SEEDS]:
            s.reseed(seed)
            got = runner.check(s, s.first)
            yield {"seed": seed, "program_step_moved": _judged(cell, {**got, "nonfinite_losses": 0.0})}
    finally:
        device_rollout.waypoint_step = step
    agent = s.trainer.agent
    full = agent._minibatch_step
    agent._minibatch_step = half_batch(full)
    try:
        for seed in seeds:  # the update's checks are the only ones that see it: every seed
            s.reseed(seed)
            got = runner.check(s, s.first)
            yield {"seed": seed, "program_half_batch": _judged(cell, {**got, "nonfinite_losses": 0.0})}
    finally:
        agent._minibatch_step = full


def correct_seeds(lines):
    """Per role: on how many of the seeds it was read on it came out
    correct."""
    out = {}
    for line in lines:
        for role, got in line.items():
            if isinstance(got, dict) and "correct" in got:
                out[role] = out.get(role, 0) + int(got["correct"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--first-seed", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    args = ap.parse_args(argv)
    harness.set_environment()
    cell = harness.load_cell(args.workload, args.first_seed, 0.0, False)
    if cell.traffic["runner"] != "ddppo_train":
        raise SystemExit(f"benchmark.control_ppo reads the DD-PPO cells; {args.workload} runs {cell.traffic['runner']}")
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    lines = []
    for line in ppo(cell, seeds):
        lines.append(line)
        print(json.dumps(line), flush=True)
    print(json.dumps({"summary": summarize(lines), "correct_seeds": correct_seeds(lines), "seeds": len(seeds),
                      "device": harness.power_limit()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
