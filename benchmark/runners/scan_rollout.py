"""Closed-loop rollouts on the card: the window calls
`trainers/scan_eval.run_scan_rollouts` on one chunk of EVAL.SCAN_BATCH
episodes after another until `--seconds` have passed, and counts whole
chunks. Each call sets up its chunk on the host (scenes, a Dijkstra field
per new goal, the instruction features read from their files, one
upload), then replays the captured step graph (render, B2, the policy with
B1, the dynamics) SCAN_SEGMENT steps at a time and reads each segment back.

Set-up builds the policy through the trainer, loads the benchmark's
weights (the action head at unit gain, STOP far below: every episode runs
its step cap), writes the seeded feature files, and rolls out one warm-up
chunk on every scene outside the window, which captures the graph.

`correct`: one chunk of the window, drawn from the seed, is replayed by
the plain reference (benchmark/reference) in f32: it renders, transforms
and steps the world itself, from the episodes' inputs and the program's
actions, and runs the policy at every step, in f32 and with its encoders
in fp8 (the unit of the gaps). Compared: how far the logits the step
graph left after the chunk's last step lie from the f32 reference's; the
widest gap by which the f32 logit of an action the program took lies
below the f32 best; the episodes that stopped before the cap (none may);
and whether the process let the f32 products run in TF32. The last
step's logits carry the whole episode: the rendered frames, the
transforms, the encoders, both GRUs' states over 128 steps and the poses
the actions led to; the gap sees each action as it was committed.
"""

from __future__ import annotations

import gc
import math
import os
import shutil
import sys
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import generate, harness, program, roofline, weights
from benchmark import trace as tracing
from benchmark.reference import cma, grid


def _episodes(eps: List[Dict], split: str):
    """The traffic's episodes as the program's episode records, with RxR's
    instruction records (the features are read from their files)."""
    from vlnce_torch.tasks.episodes import ExtendedInstructionData, NavigationGoal, VLNEpisode

    out = []
    for e in eps:
        instruction = ExtendedInstructionData(instruction_text="", instruction_id=str(e["instruction"]),
                                              language="en-US", split=split)
        out.append(VLNEpisode(
            episode_id=e["id"], trajectory_id=e["id"], scene_id=e["scene"], start_position=list(e["start"]),
            start_rotation=list(e["rotation"]), instruction=instruction,
            goals=[NavigationGoal(position=list(e["goal"]), radius=3.0)],
            reference_path=[list(e["start"]), list(e["goal"])],
            info={"geodesic_distance": math.hypot(e["goal"][0] - e["start"][0], e["goal"][2] - e["start"][2])},
        ))
    return out


def _with_rotation(eps: List[Dict]) -> List[Dict]:
    """The start heading as the dataset gives it: a quaternion [x, y, z, w]
    about the up axis."""
    for e in eps:
        h = e["heading"] / 2.0
        e["rotation"] = [0.0, math.sin(h), 0.0, math.cos(h)]
    return eps


def replay(W, arch: cma.Arch, eps: List[Dict], actions, features: Dict[int, np.ndarray], config, device,
           precisions=(cma.F32,), steps: int = 0, keep_logits: bool = False) -> Dict:
    """Replay `actions` [n, T] of `eps` in the reference, once in each of
    `precisions` (the first, f32, is the judge), on the same inputs and
    trajectory. Returns each one's logits after the last step ("finals"),
    and the widest gap by which a chosen action's logit lies below the
    judge's best ("gaps"): for the first, the given actions; for each
    other, its own best action at each step. With `actions` None the judge
    takes its own best action for `steps` steps; `keep_logits` returns its
    logits at each step too ("logits")."""
    sim = config.TASK_CONFIG.SIMULATOR
    tf = config.RL.POLICY.OBS_TRANSFORMS
    enabled = list(tf.ENABLED_TRANSFORMS)
    resize = int(tf.RESIZE_SHORTEST_EDGE.SIZE) if "ResizeShortestEdge" in enabled else 0
    crops = {k: tuple(v) for k, v in tf.CENTER_CROPPER_PER_SENSOR.SENSOR_CROPS} if "CenterCropperPerSensor" in enabled else {}
    cams = program.cameras(config)
    use_tilt = "LOOK_UP" in list(config.TASK_CONFIG.TASK.POSSIBLE_ACTIONS)
    turn = math.radians(float(sim.TURN_ANGLE))
    tilt_step = math.radians(float(getattr(sim, "TILT_ANGLE", sim.TURN_ANGLE)))
    p = dict(W)
    n = len(eps)
    T = steps if actions is None else actions.shape[1]
    sc = grid.scene_batch([e["scene"] for e in eps], device)
    pos = torch.tensor([e["start"] for e in eps], dtype=torch.float32, device=device)
    heading = torch.tensor([grid.heading_from_quaternion(e["rotation"]) for e in eps], dtype=torch.float32, device=device)
    tilt = torch.zeros(n, device=device)
    max_len = int(config.TASK_CONFIG.TASK.RXR_INSTRUCTION_SENSOR.max_text_len)
    instr = np.zeros((n, max_len, arch.feature_dim), np.float32)  # BERT features, zero rows past the instruction
    for i, e in enumerate(eps):
        f = features[e["instruction"]][:max_len, : arch.feature_dim]
        instr[i, : f.shape[0]] = f
    acts = None if actions is None else torch.from_numpy(actions.astype(np.int64)).to(device)
    kept = []
    with torch.no_grad():
        embs = []
        for prec in precisions:
            with cma.strict_f32():
                embs.append(cma.instruction(p, torch.from_numpy(instr).to(device), arch, prec))
        states = [(torch.zeros(n, arch.hidden, device=device), torch.zeros(n, arch.hidden, device=device)) for _ in precisions]
        prev = torch.zeros(n, dtype=torch.long, device=device)
        gaps = torch.zeros(len(precisions), device=device)
        for t in range(T):
            obs = grid.observe(sc, pos, heading, tilt if use_tilt else None, cams, resize, crops)
            mask = torch.full((n,), 0.0 if t == 0 else 1.0, device=device)
            logits = []
            for k, prec in enumerate(precisions):
                with cma.strict_f32():
                    rgb_f, depth_f = cma.visual(p, obs["rgb"], obs["depth"], prec)
                    out, h1, h2, _ = cma.step(p, arch, rgb_f, depth_f, embs[k], prev, mask, *states[k], prec=prec)
                states[k] = (h1, h2)
                logits.append(out)
            if keep_logits:
                kept.append(logits[0])
            a = logits[0].argmax(dim=1) if acts is None else acts[:, t]
            best = logits[0].max(dim=1).values
            chosen = [a] + [lg.argmax(dim=1) for lg in logits[1:]]
            below = torch.stack([(best - logits[0].gather(1, c[:, None])[:, 0]).max() for c in chosen])
            gaps = torch.maximum(gaps, below)
            prev = a
            pos, heading, tilt = grid.step(sc["occupancy"], pos, heading, tilt, a, float(sim.FORWARD_STEP_SIZE), turn,
                                           tilt_step, bool(sim.HABITAT_SIM_V0.ALLOW_SLIDING))
    out = {"finals": logits, "gaps": gaps.tolist()}
    if keep_logits:
        out["logits"] = kept
    return out


class Setup:
    """The program built for a cell (`__init__`), and a seed's traffic and
    weights in it, warmed up (`reseed`): what the window and the checks
    need. One build serves several seeds in the control script."""

    def __init__(self, cell: harness.Cell, t0: float):
        self.cell, self.t0 = cell, t0
        self.phases = {"imports": time.perf_counter() - t0}
        self.device = torch.device(cell.device)
        torch.backends.cuda.matmul.allow_tf32 = False  # the configuration's f32 is f32
        torch.backends.cudnn.allow_tf32 = False
        program.build_kernels(self.device)
        self._mark("kernels")
        self.tmp = tempfile.mkdtemp(prefix="bench_rxr_")
        self.features_dir = os.path.join(self.tmp, "features")
        self.config = harness.program_config(cell, {
            "TASK_CONFIG.SEED": harness.program_seed(cell.seed),
            "TASK_CONFIG.TASK.RXR_INSTRUCTION_SENSOR.features_path": os.path.join(self.features_dir, "{id}.npz"),
            "CUDA.DEVICE": self.device.type,
        })
        self.B = int(self.config.EVAL.SCAN_BATCH)
        self.cap = int(self.config.TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS)
        if self.cap % int(self.config.EVAL.SCAN_SEGMENT):
            # the last segment would run past the cap, and the logits it leaves be of a step no action reports
            raise ValueError("this cell needs MAX_EPISODE_STEPS to be a multiple of EVAL.SCAN_SEGMENT")
        from vlnce_torch.trainers import scan_eval

        self.scan_eval = scan_eval
        self.trainer = program.trainer_with_policy(self.config)
        self.arch = program.arch(self.config)
        self._mark("policy")
        self.reseed(cell.seed)

    def _mark(self, name: str) -> None:
        """The seconds since the last mark, under `name`."""
        self.phases[name] = time.perf_counter() - self.t0 - sum(self.phases.values())

    def reseed(self, seed: int) -> None:
        """The seed's episodes, feature files and weights; then one warm-up
        chunk on every scene (the first captures the step graph)."""
        self.seed = seed
        params = self.cell.params
        split = str(self.config.EVAL.SPLIT)
        stream = generate.scan_stream({**params, "chunk": self.B}, seed, int(params["stream_chunks"]))
        self.features = stream["features"]
        generate.write_features(self.features, self.features_dir)
        self._mark("traffic")
        self.chunks = [_with_rotation(c) for c in stream["chunks"]]
        self.program_chunks = [_episodes(c, split) for c in self.chunks]
        warmup = _with_rotation(stream["warmup"])
        wcfg = self.cell.config["weights"]
        self.W = weights.make(cma.param_spec(self.arch), seed, self.device, stop_bias=float(wcfg["stop_bias"]),
                              gains=wcfg["gains"])
        if int(wcfg["center_steps"]):
            center_head(self, warmup, int(wcfg["center_steps"]))
        program.load_weights(self.trainer.policy, self.W)
        self._mark("weights")
        self.run_chunk(_episodes(warmup, split))
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self._mark("warm-up chunk")

    def segment_logits(self) -> torch.Tensor:
        """The logits of the last step the chunk's segment ran, [B, A]: what
        the timed path wrote for checks (a copy on the device, no read-back)."""
        segments = list(self.scan_eval.policy_cache(self.trainer.policy).values())
        return segments[-1].logits.clone()

    def run_chunk(self, eps, stats=None):
        t = self.trainer
        with torch.profiler.record_function("run_scan_rollouts"):  # names the trace's idle gaps
            return self.scan_eval.run_scan_rollouts(t.policy, t.obs_transforms, self.config, eps, t.generator, stats=stats)

    def free_program(self) -> None:
        self.trainer.policy.__dict__.pop(self.scan_eval._CACHE_ATTR, None)
        self.trainer = None
        shutil.rmtree(self.tmp, ignore_errors=True)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def center_head(s: Setup, eps: List[Dict], steps: int) -> None:
    """Shift every action's bias but STOP's by its mean logit over the
    reference's own greedy rollout of `eps` for `steps` steps: a head whose
    choice turns on what the episode sees rather than on a constant
    offset."""
    logits = replay(s.W, s.arch, eps, None, s.features, s.config, s.device, steps=steps, keep_logits=True)["logits"]
    mean = torch.cat(logits).mean(dim=0)
    mean[0] = 0.0
    s.W["action_distribution.linear.bias"].sub_(mean)


def window(s: Setup, seconds: float, max_chunks: int = 0) -> Dict:
    """Chunks one after another until `seconds` have passed (or
    `max_chunks` have run): the actions, the calls' stats, each chunk's
    last-step logits as the step graph left them (a copy on the device),
    the time."""
    actions, stats, finals = [], [], []
    t_start = time.perf_counter()
    while True:
        if len(actions) == len(s.program_chunks):
            raise RuntimeError(f"the traffic's {len(s.program_chunks)} chunks ran out inside the window")
        st: Dict = {}
        actions.append(s.run_chunk(s.program_chunks[len(actions)], st))
        stats.append(st)
        finals.append(s.segment_logits())
        if max_chunks and len(actions) >= max_chunks:
            break
        if not max_chunks and time.perf_counter() - t_start >= seconds:
            break
    return {"actions": actions, "stats": stats, "finals": finals, "window_s": time.perf_counter() - t_start}


FP8 = cma.Precision(enc="fp8", rest="tf32")  # a precision step below the configuration's: the unit of the gaps


def _rms(a: torch.Tensor, b: torch.Tensor) -> float:
    """The root mean square of two sets of logits' differences, STOP's
    aside (it sits 1000 below the others)."""
    return float(((a[:, 1:].float() - b[:, 1:].float()) ** 2).mean().sqrt())


def tf32_switched_on() -> float:
    """1 where the process lets the library's f32 products (cuBLAS, cuDNN)
    run in TF32, which the configuration's f32 rules out; else 0."""
    return float(torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32)


def check(s: Setup, win: Dict, controls: Dict[str, cma.Precision] = None) -> Dict:
    """The compared numbers of a window: one of its chunks, drawn from the
    seed, replayed in the reference along the program's actions, in f32 and
    with the encoders in fp8 (the rest in TF32), whose deviation from the
    f32 logits is the unit (the seed's weights set the logits' scale; the
    ratios stay).
    - `final_logit_rel`: how far the logits the step graph left after the
      chunk's last step lie from the f32 reference's (root mean square,
      STOP's aside), in that unit;
    - `widest_gap_rel`: the widest gap, over the chunk's steps, by which the
      f32 logit of an action the program took lies below the f32 best, in
      that unit: what sees a commit of the wrong action;
    - `stopped_early`: the episodes of the window that stopped before the
      cap;
    - `tf32_switched_on`: the process's TF32 switches after the window.
    With `controls` ({name: precision}), the same numbers of the reference
    in each of those precisions put in the program's place (along the
    program's actions, its own best action at each step taken as its
    choice), under "controls"; the control script reads them."""
    tf32 = tf32_switched_on()
    n_chunks = len(win["actions"])
    seqs = [a for chunk in win["actions"] for a in chunk]
    short = sum(1 for a in seqs if len(a) != s.cap or bool((np.asarray(a) == 0).any()))
    k = int(np.random.default_rng(s.seed + 1).integers(n_chunks))
    n = min(int(s.cell.params["sample_episodes"]), s.B)
    eps = s.chunks[k][:n]
    acts = np.stack([np.resize(np.asarray(a, np.int64), s.cap) for a in win["actions"][k][:n]])
    extra = dict(controls or {})
    ref = replay(s.W, s.arch, eps, acts, s.features, s.config, s.device, (cma.F32, FP8) + tuple(extra.values()))
    f32, unit = ref["finals"][0], _rms(ref["finals"][1], ref["finals"][0])
    prog = win["finals"][k][:n]
    out = {"final_logit_rel": _rms(prog, f32) / unit, "widest_gap_rel": ref["gaps"][0] / unit,
           "stopped_early": float(short), "tf32_switched_on": tf32, "program_rms": _rms(prog, f32), "unit_rms": unit}
    if controls:
        out["controls"] = {name: {"final_logit_rel": _rms(ref["finals"][i], f32) / unit,
                                  "widest_gap_rel": ref["gaps"][i] / unit, "stopped_early": 0.0,
                                  "tf32_switched_on": tf32, "rms": _rms(ref["finals"][i], f32)}
                           for i, name in enumerate(["fp8"] + list(extra), start=1)}
    hist = np.bincount(acts.reshape(-1), minlength=s.arch.num_actions).tolist()
    print(f"chunk {k}: actions by kind {hist}; last logits off the f32 reference by {out['program_rms']:.6f} "
          f"(root mean square), the fp8 reference's by {unit:.6f}; widest gap of a taken action {ref['gaps'][0]:.6f}",
          file=sys.stderr)
    return out


def run(cell: harness.Cell, t0: float) -> Dict:
    s = Setup(cell, t0)
    params = cell.params
    prof = None
    if cell.trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
        with record_function("bench_window"):
            t_w0 = time.perf_counter()
            win = window(s, cell.seconds, max_chunks=int(params["trace_chunks"]))
        torch.cuda.synchronize()
        prof.stop()
    else:
        t_w0 = time.perf_counter()
        win = window(s, cell.seconds)
    setup_s = t_w0 - t0
    device = harness.device_description(cell.chips) if s.device.type == "cuda" else {}
    trace = None
    if prof is not None:
        events = prof.profiler.kineto_results.events()
        span = next(e for e in events if e.name() == "bench_window")
        trace = tracing.Trace(events, span.start_ns(), span.start_ns() + span.duration_ns())
        prof = None
    env_steps = sum(int(st["env_steps"]) for st in win["stats"])
    setup_seconds = sum(float(st["setup_seconds"]) for st in win["stats"])
    replays = sum(int(st["replays"]) for st in win["stats"])
    n_eps = sum(len(a) for a in win["actions"])
    tokens = float(np.mean([len(s.features[e["instruction"]]) for c in s.chunks[: len(win["actions"])] for e in c]))
    rgb_side = program.transformed_hw(s.config, "rgb")[0]
    least = roofline.rollout_step_least_s(s.arch, rgb_side, tokens)
    sim = s.config.TASK_CONFIG.SIMULATOR
    size = int(s.config.RL.POLICY.OBS_TRANSFORMS.RESIZE_SHORTEST_EDGE.SIZE)
    b2_pair = 0.0  # one resize of the RGB frames (u8) and one of the depth frames (f32) per step
    for cam, channels, itemsize in ((sim.RGB_SENSOR, 3, 1), (sim.DEPTH_SENSOR, 1, 4)):
        hw = (int(cam.HEIGHT), int(cam.WIDTH))
        out = (int(hw[0] * size / min(hw)), int(hw[1] * size / min(hw)))
        b2_pair += roofline.b2_s(s.B, hw, out, channels, itemsize, itemsize)
    ctx = {
        "trace": trace, "window_s": win["window_s"], "setup_seconds": setup_seconds, "replays": replays,
        "env_steps": env_steps,
        "b1_bound_s": roofline.b1_forward_s(1, s.B, s.arch.hidden, gates=False),
        "b2_pair_bound_s": b2_pair,
        "least_s": least["least_s"] * env_steps,
    }
    for k, st in enumerate(win["stats"]):
        print(f"chunk {k}: {st['seconds']:.4f} s, host set-up {st['setup_seconds']:.4f} s, {st['env_steps']} env steps",
              file=sys.stderr)
    print(f"set-up {setup_s:.3f} s: " + ", ".join(f"{k} {v:.3f}" for k, v in s.phases.items()), file=sys.stderr)
    s.free_program()
    t_ref = time.perf_counter()
    compared = check(s, win)
    print(f"reference {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    return {
        "setup_s": setup_s, "e2e": {"rollout_env_steps_per_s": env_steps / win["window_s"]}, "ctx": ctx,
        "attempted": n_eps, "failed": int(compared["stopped_early"]), "compared": compared, "device": device,
    }
