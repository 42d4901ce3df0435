"""DAgger's training epochs over the trajectory bank on the card: the window
runs `data/device_bank.run_fused_epoch` with the trainer's
`parallel/il_step.build_il_train_step` (masked Adam) epoch after epoch
over a `DeviceTrajectoryBank` until `--seconds` have passed, and counts
whole epochs.

Set-up builds the policy and its optimizer through the trainer, loads the
benchmark's weights, fills the bank on the card from the seed, then drives
the same policy and optimizer through their first steps with the
window's own call and gather: three steps on fifteen different episodes
(the steps the reference follows), then one step at each padded length an
epoch can have, so nothing new is met inside the window.

`correct`: the plain reference (benchmark/reference/train.py) takes the
three steps from the same weights and rows in f32. Compared: each step's
loss, the first gradient as Adam holds it after one step (its first
moment over 1 - beta1), and the change of the parameters after the three
steps, by leaf; the window's non-finite losses (none may be); and the
process's TF32 switches after the window (off, as the configuration's f32
states).
"""

from __future__ import annotations

import gc
import math
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import generate, harness, program, roofline, weights
from benchmark import trace as tracing
from benchmark.reference import cma
from benchmark.reference import train as ref_train


class Runs:
    """An epoch of the given (T_b, [K, N] episode ids) runs over a bank: what
    `run_fused_epoch` reads of a batch iterator."""

    def __init__(self, bank, coef: float, runs):
        self.bank, self.coef, self._runs = bank, coef, list(runs)

    def epoch_runs(self):
        yield from self._runs


class Recorded:
    """The trainer's iterator, its runs recorded as they are handed out (and,
    with `limit`, cut after that many steps)."""

    def __init__(self, riter, limit: int = 0):
        self.bank, self.coef, self.riter, self.limit = riter.bank, riter.coef, riter, limit
        self.runs: List = []

    def epoch_runs(self):
        steps = 0
        for T_b, rows in self.riter.epoch_runs():
            self.runs.append((T_b, rows))
            yield T_b, rows
            steps += len(rows)
            if self.limit and steps >= self.limit:
                return


class Setup:
    """The program built for a cell (`__init__`), and a seed's weights, bank
    and first steps in it (`reseed`). One build serves several seeds in the
    control script."""

    def __init__(self, cell: harness.Cell, t0: float):
        from vlnce_torch.data.device_bank import run_fused_epoch

        self.cell, self.t0 = cell, t0
        self.phases = {"imports": time.perf_counter() - t0}
        self.run_fused_epoch = run_fused_epoch
        self.device = torch.device(cell.device)
        torch.backends.cuda.matmul.allow_tf32 = False  # the configuration's f32 is f32
        torch.backends.cudnn.allow_tf32 = False
        program.build_kernels(self.device)
        self._mark("kernels")
        self.config = harness.program_config(cell, {"TASK_CONFIG.SEED": harness.program_seed(cell.seed),
                                                     "CUDA.DEVICE": self.device.type})
        self.trainer = program.trainer_with_policy(self.config, "dagger")
        self.arch = program.arch(self.config)
        self.step = self.trainer._get_train_step()
        il = self.config.IL
        self.N = int(il.batch_size)
        self.coef = float(il.inflection_weight_coef) if bool(il.use_iw) else 1.0
        self.feat_shapes = {"rgb_features": (2048, 4, 4),
                            "depth_features": (self.arch.depth_channels, self.arch.depth_spatial, self.arch.depth_spatial),
                            "progress": (1,)}
        self.rows = self.bank = None
        self._mark("policy")
        self.reseed(cell.seed)

    def _mark(self, name: str) -> None:
        """The seconds since the last mark, under `name`."""
        self.phases[name] = time.perf_counter() - self.t0 - sum(self.phases.values())

    def reseed(self, seed: int) -> None:
        """The seed's weights (Adam's state cleared), bank and iterator, then
        the checked steps and one step at every padded length."""
        from vlnce_torch.data.device_bank import DeviceTrajectoryBank, ResidentBatchIterator
        from vlnce_torch.tasks.sensors import MAX_INSTRUCTION_LEN

        self.seed = seed
        params = self.cell.params
        self.rows = self.bank = self.riter = None
        gc.collect()
        self.W = weights.make(cma.param_spec(self.arch), seed, self.device, gains=self.cell.config["weights"]["gains"])
        program.load_weights(self.trainer.policy, self.W)
        self.trainer.optimizer.state.clear()
        self._mark("weights")
        self.rows = r = generate.bank(params, seed, self.device, self.feat_shapes, self.arch.vocab, MAX_INSTRUCTION_LEN)
        self.bank = DeviceTrajectoryBank(r["data"], r["prev"], r["oracle"], r["instruction"], r["offsets"], r["lengths"],
                                         self.feat_shapes, trash_index=r["trash"], instr_uuid="instruction")
        il = self.config.IL
        self.riter = ResidentBatchIterator(self.bank, batch_size=self.N, use_iw=bool(il.use_iw),
                                           inflection_weight_coef=float(il.inflection_weight_coef),
                                           seed=harness.program_seed(seed), time_major=True)
        self.lengths = r["lengths"]
        self.tokens = generate.bank_instruction_lengths(params, len(self.lengths))
        rng = np.random.default_rng(seed + 1)
        n_check = int(params["check_steps"])
        self.check_ids = rng.choice(len(self.lengths), size=n_check * self.N, replace=False).reshape(n_check, self.N)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self._mark("bank")
        self.first = self._first_steps()
        self._warm_lengths(self.N, rng)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self._mark("first steps")

    def _run(self, batches) -> List:
        runs = [(self.bank.batch_T(list(ids)), np.asarray([ids], np.int64)) for ids in batches]
        return self.epoch(Runs(self.bank, self.coef, runs))

    def epoch(self, riter) -> List:
        with torch.profiler.record_function("run_fused_epoch"):  # names the trace's idle gaps
            return self.run_fused_epoch(riter, self.step)

    def trainable(self):
        return [(n, p) for n, p in self.trainer.policy.named_parameters() if p.requires_grad]

    def _first_steps(self) -> Dict:
        """The checked steps through the window's own call: the first alone
        (its gradient is read from Adam's first moment), then the rest."""
        opt = self.trainer.optimizer
        beta1 = opt.param_groups[0]["betas"][0]
        out = {"losses": [row[0] for row in self._run(self.check_ids[:1])]}
        out["grad"] = {n: opt.state[p]["exp_avg"].detach() / (1 - beta1) for n, p in self.trainable()}
        out["losses"] += [row[0] for row in self._run(self.check_ids[1:])]
        out["delta"] = {n: p.detach() - self.W[n] for n, p in self.trainable()}
        return out

    def _warm_lengths(self, N: int, rng) -> None:
        """One step at every padded length an epoch can produce."""
        q = 16
        Ts = sorted({int(-(-int(L) // q) * q) for L in self.lengths})
        batches = []
        for T in Ts:
            fits = np.flatnonzero(self.lengths <= T)
            top = np.flatnonzero((self.lengths <= T) & (self.lengths > T - q))
            ids = [int(rng.choice(top))] + [int(i) for i in rng.choice(fits, size=N - 1, replace=False)]
            batches.append(ids)
        self._run(batches)

    def check_rows(self) -> List[Dict[str, torch.Tensor]]:
        """The checked episodes' rows, as the benchmark made them."""
        r, out = self.rows, []
        shapes = {"rgb": (2048, 4, 4), "depth": (self.arch.depth_channels, self.arch.depth_spatial, self.arch.depth_spatial)}
        for ids in self.check_ids:
            eps = []
            for e in ids:
                lo, L = int(r["offsets"][e]), int(r["lengths"][e])
                eps.append({
                    "rgb": r["data"]["rgb_features"][lo : lo + L].float().reshape((L,) + shapes["rgb"]),
                    "depth": r["data"]["depth_features"][lo : lo + L].float().reshape((L,) + shapes["depth"]),
                    "progress": r["data"]["progress"][lo : lo + L, 0].clone(), "prev": r["prev"][lo : lo + L].clone(),
                    "oracle": r["oracle"][lo : lo + L].clone(), "tokens": r["instruction"][e].clone()})
            eps_T = int(-(-max(int(r["lengths"][e]) for e in ids) // 16) * 16)
            out.append(ref_train.il_batch(eps, eps_T, self.coef))
        return out

    def free_program(self) -> None:
        self.trainer = self.bank = self.riter = self.step = None
        self.rows = {k: v for k, v in self.rows.items() if k in ("offsets", "lengths")}
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def frames_and_flops(s: Setup, runs) -> Dict[str, float]:
    """Real frames of the steps handed out, and their model FLOPs."""
    frames = flops = 0.0
    bounds = []
    for T_b, rows in runs:
        for ids in rows:
            L = s.lengths[ids]
            frames += float(L.sum())
            flops += sum(float(l) * roofline.train_frame_flops(s.arch, float(s.tokens[e])) for l, e in zip(L, ids))
            bounds.append(roofline.b1_backward_s(int(T_b), len(ids), s.arch.hidden))
    return {"frames": frames, "flops": flops, "steps": float(len(bounds)),
            "b1_bwd_bound_s": float(np.mean(bounds)) if bounds else 0.0}


def run(cell: harness.Cell, t0: float) -> Dict:
    s = Setup(cell, t0)
    losses: List = []
    recorded: List = []
    prof = None
    if cell.trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        rec = Recorded(s.riter, limit=int(cell.params["trace_steps"]))
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
        with record_function("bench_window"):
            t_w0 = time.perf_counter()
            losses += s.epoch(rec)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t_w0
        prof.stop()
        recorded += rec.runs
        epochs = 0
    else:
        t_w0 = time.perf_counter()
        epochs = 0
        while True:
            rec = Recorded(s.riter)
            losses += s.epoch(rec)
            recorded += rec.runs
            epochs += 1
            if time.perf_counter() - t_w0 >= cell.seconds:
                break
        window_s = time.perf_counter() - t_w0
    setup_s = t_w0 - t0
    device = harness.device_description(cell.chips) if s.device.type == "cuda" else {}
    trace = None
    if prof is not None:
        events = prof.profiler.kineto_results.events()
        span = next(e for e in events if e.name() == "bench_window")
        trace = tracing.Trace(events, span.start_ns(), span.start_ns() + span.duration_ns())
    work = frames_and_flops(s, recorded)
    nonfinite = sum(1 for row in losses if not all(math.isfinite(x) for x in row))
    ctx = {"trace": trace, "window_s": window_s, "epochs": epochs, **work}
    print(f"{epochs} epochs, {len(losses)} steps, {work['frames']:.0f} frames in {window_s:.3f} s", file=sys.stderr)
    print(f"set-up {setup_s:.3f} s: " + ", ".join(f"{k} {v:.3f}" for k, v in s.phases.items()), file=sys.stderr)
    tf32 = float(torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32)
    batches = s.check_rows()
    run_numbers = s.first
    s.free_program()
    t_ref = time.perf_counter()
    ref = ref_train.adam_steps(s.W, s.arch, batches, lr=float(s.config.IL.lr))
    print(f"reference {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    compared = {**ref_train.compare(run_numbers, ref), "nonfinite_losses": float(nonfinite), "tf32_switched_on": tf32}
    return {
        "setup_s": setup_s, "e2e": {"train_frames_per_s": work["frames"] / window_s}, "ctx": ctx,
        "attempted": len(losses), "failed": nonfinite, "compared": compared, "device": device,
    }
