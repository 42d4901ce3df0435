"""DD-PPO updates of the waypoint policy on the card: the window calls the
trainer's `train_update_on_device` update after update until `--seconds`
have passed, and counts whole updates. An update is one rollout of
NUM_ENVIRONMENTS slots for RL.PPO.num_steps sampled steps on the card
(`rl/device_rollout`: one CUDA graph replay a step, the bootstrap value and
GAE in a second graph, one read-back) and the PPO update of the batch it
left there (`WDDPPO.update_device_scan`: ppo_epoch x num_mini_batch
minibatch steps enqueued after one index upload, the frozen CNNs
recomputed over every frame, B1 forward and backward, the clip and Adam).
Every update is the same work whatever the seed.

Set-up builds the trainer, its policy and WDDPPO through the trainer's
own set-up (`benchmark/program.trainer_with_policy`), loads the
benchmark's weights, hands the seed's split to `start_device_rollout`
(the episode bank, its goal fields built on the card in one launch), seeds
the trainer's generator (the rollouts' uniforms) and the minibatch
permutations, then runs the checked first update and `warm_updates` more,
so nothing is captured or met for the first time inside the window.

`correct`: the plain reference (benchmark/reference/waypoint.py, ppo.py)
in f32, against what the first update of the timed path produced.
From its rollout: the 12-view frames against the reference's render at
the recorded pose, each step's move and reward against the plain step
along the program's (r, theta), each drawn pano against the reference's
inverse CDF at the rollout's uniforms, and the values and the taken
actions' log-probabilities against the reference's forward over the
program's observations, in units of the deviation of the reference with
its encoders in fp8 and the rest in TF32 (the control). From its update,
taken by the reference over the same batch and minibatches: each
minibatch step from the program's own weights and Adam moments before it
(its loss, its gradient after the clip and its change, median leaf), and
the whole update from the same weights (the change after its last step,
median leaf). Also the window's non-finite losses and the process's TF32
switches.
"""

from __future__ import annotations

import gc
import math
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import generate_ppo, harness, program, roofline, roofline_wpn, weights
from benchmark import trace as tracing
from benchmark.reference import cma, grid, waypoint
from benchmark.reference import ppo as ref_ppo

PROGRAM_METHODS = ("start_device_rollout", "train_update_on_device")
FP8 = cma.Precision(enc="fp8", rest="tf32")  # a precision step below the configuration's: the unit of the rollout's gaps
_ACTIONS = ("pano", "offset", "distance")


def require_program_path() -> None:
    """Exit before any heavy set-up where the program's trainer lacks the
    on-card update this cell drives."""
    from vlnce_torch.trainers.ddppo_waypoint_trainer import DDPPOWaypointTrainer

    missing = [m for m in PROGRAM_METHODS if not hasattr(DDPPOWaypointTrainer, m)]
    if missing:
        raise SystemExit(f"benchmark: the program's DDPPOWaypointTrainer has no {missing}: this cell drives the "
                         f"trainer's on-card update, which this checkout does not have")


def arch_of(config) -> waypoint.Arch:
    mc = config.MODEL
    wc, ie = mc.WAYPOINT, mc.INSTRUCTION_ENCODER
    if not (wc.continuous_distance and wc.continuous_offset and wc.predict_distance and wc.predict_offset):
        raise ValueError("the reference holds the continuous distance and offset heads (1-wpn-cc) only")
    if mc.RGB_ENCODER.cnn_type != "TorchVisionResNet18" or mc.STATE_ENCODER.rnn_type != "GRU":
        raise ValueError("the reference holds the ResNet18 RGB encoder and GRU state encoders only")
    return waypoint.Arch(
        hidden=int(mc.STATE_ENCODER.hidden_size), rgb_out=int(mc.RGB_ENCODER.output_size),
        depth_out=int(mc.DEPTH_ENCODER.output_size), num_panos=int(config.TASK_CONFIG.TASK.PANO_ROTATIONS),
        depth_hw=int(config.TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.HEIGHT), vocab=int(ie.vocab_size),
        embed=int(ie.embedding_size), instr_hidden=int(ie.hidden_size), normalize_rgb=bool(mc.normalize_rgb),
        min_distance=float(wc.min_distance_prediction), max_distance=float(wc.max_distance_prediction),
        min_distance_var=float(wc.min_distance_var), max_distance_var=float(wc.max_distance_var),
        min_offset_var=float(wc.min_offset_var), max_offset_var=float(wc.max_offset_var),
        offset_temperature=float(wc.offset_temperature),
    )


def _episodes(split: List[Dict]):
    """The traffic's episodes as the program's episode records."""
    from vlnce_torch.tasks.episodes import InstructionData, NavigationGoal, VLNEpisode

    return [VLNEpisode(
        episode_id=e["id"], trajectory_id=e["id"], scene_id=e["scene"], start_position=list(e["start"]),
        start_rotation=generate_ppo.rotation(e["heading"]),
        instruction=InstructionData(instruction_text="", instruction_tokens=list(e["tokens"])),
        goals=[NavigationGoal(position=list(e["goal"]), radius=3.0)], reference_path=[list(e["start"]), list(e["goal"])],
        info={"geodesic_distance": math.hypot(e["goal"][0] - e["start"][0], e["goal"][2] - e["start"][2])},
    ) for e in split]


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.detach().clone()


class Setup:
    """The program built for a cell (`__init__`), and a seed's split,
    weights and first updates in it (`reseed`). One build serves several
    seeds in the control script."""

    def __init__(self, cell: harness.Cell, t0: float):
        require_program_path()
        self.cell, self.t0 = cell, t0
        self.phases = {"imports": time.perf_counter() - t0}
        self.device = torch.device(cell.device)
        torch.backends.cuda.matmul.allow_tf32 = False  # the configuration's f32 is f32
        torch.backends.cudnn.allow_tf32 = False
        program.build_kernels(self.device)
        self._mark("kernels")
        config = harness.program_config(cell, {"TASK_CONFIG.SEED": harness.program_seed(cell.seed),
                                               "CUDA.DEVICE": self.device.type})
        self.trainer = program.trainer_with_policy(config, "ddppo-waypoint")
        self.config = self.trainer.config
        self.arch = arch_of(self.config)
        self.N, self.T = int(self.config.NUM_ENVIRONMENTS), int(self.config.RL.PPO.num_steps)
        self._mark("policy")
        self.reseed(cell.seed)

    def _mark(self, name: str) -> None:
        """The seconds since the last mark, under `name`."""
        self.phases[name] = time.perf_counter() - self.t0 - sum(self.phases.values())

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def reseed(self, seed: int) -> None:
        """The seed's split and weights (Adam's state cleared), a fresh
        collector over the split (the bank built), the seeded generator and
        permutations; then the checked first update and the warm-ups."""
        t = self.trainer
        self.seed = seed
        t.collector = None
        gc.collect()
        self.split = generate_ppo.ppo_split(self.cell.params, seed, self.arch.vocab)
        self.W = weights.make(waypoint.param_spec(self.arch), seed, self.device, gains=self.cell.config["weights"]["gains"])
        program.load_weights(t.policy, self.W)
        t.agent.optimizer.state.clear()
        t.agent.optimizer_steps = 0
        self._mark("weights")
        t.start_device_rollout(_episodes(self.split))
        self._sync()
        self._mark("bank")
        t.generator.manual_seed(harness.program_seed(seed))
        self.rng = np.random.RandomState(harness.program_seed(seed))
        self.updates = 0
        self.first = self._checked_update()
        for _ in range(int(self.cell.params["warm_updates"])):
            self.update()
        self._sync()
        self._mark("first updates")

    def update(self) -> Dict[str, float]:
        stats, _ = self.trainer.train_update_on_device(self.updates, self.rng)
        self.updates += 1
        return stats

    def _checked_update(self) -> Dict:
        """The first update through the window's own call, its inputs and
        results recorded on the way: the rollout's batch and uniforms, the
        minibatch permutations' state, and for each minibatch step the
        trainable leaves and Adam's moments before it, its loss, its
        gradient after the clip and its change; then the change after the
        update."""
        agent, collector = self.trainer.agent, self.trainer.collector
        named = [(n, p) for n, p in self.trainer.policy.named_parameters() if p.requires_grad]
        rec: Dict = {"losses": [], "states": [], "grads": [], "changes": []}
        update, loss, step = agent.update_device_scan, agent.loss, agent._minibatch_step
        adam = agent.optimizer.state

        def recorded_update(batch, rng, update_idx=0, clock=None):
            rec.update(batch=_clone(batch), uniforms=collector._uniforms.clone(), rng=rng.get_state(),
                       start={n: p.detach().clone() for n, p in named})
            return update(batch, rng, update_idx=update_idx, clock=clock)

        def recorded_loss(sample, clip_param, T):
            total, stats = loss(sample, clip_param, T)
            rec["losses"].append(total.detach())
            return total, stats

        def recorded_step(*args):
            before = {n: p.detach().clone() for n, p in named}
            moments = {n: {k: v.detach().clone() for k, v in adam[p].items()} for n, p in named if p in adam}
            out = step(*args)
            rec["states"].append({"before": before, "adam": moments})
            rec["grads"].append({n: p.grad.detach().clone() for n, p in named})
            rec["changes"].append({n: p.detach() - before[n] for n, p in named})
            return out

        agent.update_device_scan, agent.loss, agent._minibatch_step = recorded_update, recorded_loss, recorded_step
        try:
            self.update()
        finally:
            del agent.update_device_scan, agent.loss  # the class's methods again
            agent._minibatch_step = step
        rec["losses"] = [float(x) for x in rec["losses"]]
        rec["delta"] = {n: p.detach() - rec["start"][n] for n, p in named}
        return rec

    def free_program(self) -> None:
        self.trainer = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


# ------------------------------------------------------------------ check
def ppo_cfg(config) -> Dict:
    ppo = config.RL.PPO
    keys = ("clip_param", "value_loss_coef", "entropy_coef", "pano_entropy_coef", "offset_entropy_coef",
            "distance_entropy_coef", "offset_regularize_coef", "lr", "eps", "max_grad_norm")
    return {**{k: float(ppo[k]) for k in keys}, "clip_value_loss": bool(ppo.clip_value_loss), "betas": (0.9, 0.999)}


def _slot_episodes(s: Setup, masks_next: torch.Tensor) -> List[List[Dict]]:
    """[t][n]: the episode slot n ran at step t of the first rollout: the
    split's episodes n, n + N, n + 2N, ... (the collector's round-robin
    streams), one more after each done."""
    dones = torch.cat([torch.zeros(1, s.N, device=masks_next.device), (masks_next == 0).float()[:-1]]).cumsum(0)
    k = dones.long().cpu().numpy()
    return [[s.split[(n + s.N * int(k[t, n])) % len(s.split)] for n in range(s.N)] for t in range(s.T)]


def _fields(eps: List[Dict], cache: Dict) -> Dict:
    """Each episode's goal field (f64, plain Dijkstra) and start distance."""
    out = {}
    for e in eps:
        if e["id"] in out:
            continue
        key = (e["scene"], e["goal"][0], e["goal"][2])
        if key not in cache:
            occ = grid.scene(e["scene"])["occupancy"]
            cache[key] = waypoint.scene_field(occ, (e["goal"][0], e["goal"][2]))
        f = cache[key]
        occ = grid.scene(e["scene"])["occupancy"]
        si, sj = waypoint.cell_of(occ, e["start"][0], e["start"][2])
        out[e["id"]] = (f, max(float(f[si, sj]), 1e-6))
    return out


def world_checks(s: Setup, rec: Dict) -> Dict[str, float]:
    """The frames at the recorded poses (the shares of depth values off by
    more than 1e-3 and of RGB values off by more than 1: a ray that grazes a
    corner flips a column where the poses differ by rounding), and each
    step's move, start and reward, against the plain reference."""
    b, dev = rec["batch"], s.device
    obs = b["obs"]
    T, N, P = s.T, s.N, s.arch.num_panos
    masks, masks_next = b["masks"][..., 0], b["masks_next"][..., 0]
    eps = _slot_episodes(s, masks_next)
    flat = [e for row in eps for e in row]
    pos = torch.zeros(T * N, 3, device=dev)
    pos[:, 0::2] = obs["globalgps"].reshape(T * N, 2).float()
    heading = obs["heading"].reshape(T * N).float()
    # the frames
    sc = grid.scene_batch([e["scene"] for e in flat], dev)
    cams = {c["kind"]: c for c in program.cameras(s.config)}
    off = {"depth": 0.0, "rgb": 0.0}
    for i in range(P):
        h = heading + torch.tensor(2.0 * math.pi / P * i, dtype=torch.float32, device=dev)
        for kind, tol in (("depth", 1e-3), ("rgb", 1)):
            frames = obs[kind].reshape((T * N,) + tuple(obs[kind].shape[2:]))[:, i]
            ref = grid.render(sc, pos, h, None, cams[kind])
            off[kind] += float(((frames.float() - ref.float()).abs() > tol).float().mean()) / P
    # the moves and the rewards along the program's actions
    sim = s.config.TASK_CONFIG
    rm = sim.TASK.WAYPOINT_REWARD_MEASURE
    rmd = {"slack_reward": float(rm.slack_reward), "distance_scalar": float(rm.distance_scalar),
           "success_reward": float(rm.success_reward), "success_distance": float(sim.TASK.SUCCESS.SUCCESS_DISTANCE)}
    fields = _fields(flat, {})
    field_t = torch.from_numpy(np.stack([fields[e["id"]][0] for e in flat]).astype(np.float32)).to(dev)
    d0 = torch.tensor([fields[e["id"]][1] for e in flat], dtype=torch.float32, device=dev)
    pano = b["actions"]["pano"].reshape(T * N).long()
    stop = pano == P
    r = b["actions"]["distance"].reshape(T * N).float()
    theta = torch.remainder((pano % P).float() * (2 * math.pi / P) + b["actions"]["offset"].reshape(T * N).float(),
                            2 * math.pi)
    new_pos, new_heading = waypoint.waypoint_step(sc["occupancy"], pos, heading, r, theta, stop)
    first = masks.reshape(T * N) == 0
    prev_d = torch.where(first, d0, waypoint.field_at(field_t, pos))
    reward, _ = waypoint.waypoint_reward(field_t, prev_d, pos, new_pos, r, stop, rmd)
    reward_gap = float((reward - b["rewards"].reshape(T * N)).abs().max())
    start = torch.tensor([[e["start"][0], e["start"][2]] for e in flat], device=dev)
    pose_gap = float(torch.where(first, (pos[:, 0::2] - start).norm(dim=1), torch.zeros_like(d0)).max())
    nxt = (masks_next[:-1] == 1).reshape(-1)
    got_pos, got_heading = pos[N:][nxt], heading[N:][nxt]
    want_pos, want_heading = new_pos[: (T - 1) * N][nxt], new_heading[: (T - 1) * N][nxt]
    if len(got_pos):
        turn = torch.remainder(got_heading - want_heading + math.pi, 2 * math.pi) - math.pi
        pose_gap = max(pose_gap, float((got_pos - want_pos).norm(dim=1).max()), float(turn.abs().max()))
    return {"render_depth_off_share": off["depth"], "render_rgb_off_share": off["rgb"], "pose_gap": pose_gap,
            "reward_gap": reward_gap}


def reference_batch(s: Setup, rec: Dict, prec: cma.Precision) -> Dict:
    """The first rollout's tensors as the reference takes them [T, N, ...],
    the frames' features computed in `prec`."""
    b = rec["batch"]
    obs = b["obs"]
    T, N = s.T, s.N
    rows = {k: v.reshape((T * N,) + tuple(v.shape[2:])) for k, v in obs.items()}
    masks = b["masks"][..., 0]
    with torch.no_grad(), cma.strict_f32():
        rgb_f, depth_f = waypoint.encode_steps(s.W, s.arch, rows, masks.reshape(T * N), prec)
    out = {"rgb_f": rgb_f.reshape((T, N) + tuple(rgb_f.shape[1:])), "depth_f": depth_f.reshape((T, N) + tuple(depth_f.shape[1:])),
           "instruction": obs["instruction"], "angle_features": obs["angle_features"], "masks": masks,
           "hidden0": b["hidden0"], "prev_actions": {k: b["prev_actions"][k][..., 0] for k in _ACTIONS},
           "actions": {k: b["actions"][k][..., 0] for k in _ACTIONS}}
    for k in ("old_log_probs", "value_preds", "returns", "advantages"):
        out[k] = b[k][..., 0]
    return out


def forward(s: Setup, batch: Dict, prec: cma.Precision) -> Dict[str, torch.Tensor]:
    """The reference's forward over the whole rollout from its first state:
    values, the taken actions' log-probabilities, the pano logits [T, N]."""
    T, N = s.T, s.N
    W = s.W
    with torch.no_grad(), cma.strict_f32():
        emb = cma.instruction(W, batch["instruction"].reshape(T * N, -1), s.arch.instr, prec)
        emb = emb.reshape((T, N) + tuple(emb.shape[1:]))
        out = waypoint.sequence(W, s.arch, batch["rgb_f"], batch["depth_f"], emb, batch["prev_actions"], batch["masks"],
                                batch["angle_features"], batch["hidden0"], prec)
        logp, _ = waypoint.evaluate(out, batch["actions"], s.arch)
    return {"value": out["value"], "logp": logp, "logits": out["logits"]}


def _rms(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(((a.float() - b.float()) ** 2).mean().sqrt())


def check(s: Setup, rec: Dict, controls: Dict[str, cma.Precision] = None, faults: bool = False) -> Dict:
    """The compared numbers of the first update (module docstring):
    render_depth_off_share, render_rgb_off_share, pose_gap, reward_gap (the
    world); pano_draw_gap, value_rel, logp_rel (the rollout's policy);
    loss_gap, grad_gap, step_gap (each minibatch step from the program's
    state before it), update_gap_median (the whole update from the same
    weights); tf32_switched_on.
    With `controls` ({name: precision}) the same numbers of the reference in
    each precision put in the program's place, under "controls"; with
    `faults` those of the reference with a fault planted, under "faults":
    `unclipped` (the probability ratio left unclipped in the update) and
    `pano_moved` (the first row's drawn pano moved to the next, never
    STOP)."""
    tf32 = float(torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32)
    world = world_checks(s, rec)
    u = rec["uniforms"][:, 0, :]  # [T, N]: the pano draws' uniforms
    b = reference_batch(s, rec, cma.F32)
    ref = forward(s, b, cma.F32)
    unit_batch = reference_batch(s, rec, FP8)
    unit = forward(s, unit_batch, FP8)
    units = {"value": _rms(unit["value"], ref["value"]), "logp": _rms(unit["logp"], ref["logp"])}
    taken = b["actions"]["pano"].long()

    def policy_numbers(value, logp, pano) -> Dict[str, float]:
        return {"pano_draw_gap": float(waypoint.cdf_gap(ref["logits"], pano, u).max()),
                "value_rel": _rms(value, ref["value"]) / units["value"], "logp_rel": _rms(logp, ref["logp"]) / units["logp"]}

    cfg = ppo_cfg(s.config)
    pp = s.config.RL.PPO
    rng = np.random.RandomState()
    rng.set_state(rec["rng"])
    rows = ref_ppo.minibatch_plan(s.N, int(pp.ppo_epoch), int(pp.num_mini_batch), rng)

    def reference_update(batch, prec=cma.F32, unclipped=False) -> Dict:
        """Each step from the program's state before it, and the whole
        update from the same weights."""
        return {**ref_ppo.steps(s.W, s.arch, batch, rows, cfg, rec["states"], prec, unclipped),
                "delta": ref_ppo.update(s.W, s.arch, batch, rows, cfg, prec, unclipped)}

    upd = reference_update(b)
    out = {**world, **policy_numbers(b["value_preds"], b["old_log_probs"], taken),
           **ref_ppo.compare(rec, upd), "tf32_switched_on": tf32,
           "rms": {"value": _rms(b["value_preds"], ref["value"]), "logp": _rms(b["old_log_probs"], ref["logp"]),
                   "unit_value": units["value"], "unit_logp": units["logp"]}}
    print(f"first rollout: pano actions by kind {torch.bincount(taken.reshape(-1), minlength=13).tolist()}, "
          f"{int((b['masks'] == 0).sum())} episode starts; values off the f32 reference by {out['rms']['value']:.3e} "
          f"(fp8 control {units['value']:.3e}), log-probs by {out['rms']['logp']:.3e} ({units['logp']:.3e}); "
          f"update losses {rec['losses']}, reference {upd['losses']}", file=sys.stderr)
    if controls:
        out["controls"] = {}
        for name, prec in {"fp8": FP8, **controls}.items():
            cb = unit_batch if name == "fp8" else reference_batch(s, rec, prec)
            c = unit if name == "fp8" else forward(s, cb, prec)
            numbers = policy_numbers(c["value"], c["logp"], waypoint.draw_pano(c["logits"], u))
            out["controls"][name] = {**world, **numbers, **ref_ppo.compare(reference_update(cb, prec), upd),
                                     "tf32_switched_on": tf32}
    if faults:
        moved = waypoint.draw_pano(ref["logits"], u)
        moved[:, 0] = torch.remainder(moved[:, 0] + 1, s.arch.num_panos)  # the next pano, never STOP
        out["faults"] = {
            "unclipped": {**world, **policy_numbers(b["value_preds"], b["old_log_probs"], taken),
                          **ref_ppo.compare(reference_update(b, unclipped=True), upd),
                          "tf32_switched_on": tf32},
            "pano_moved": {**world, **policy_numbers(ref["value"], ref["logp"], moved), **ref_ppo.compare(upd, upd),
                           "tf32_switched_on": tf32},
        }
    return out


# ------------------------------------------------------------------ window
def run(cell: harness.Cell, t0: float) -> Dict:
    s = Setup(cell, t0)
    t = s.trainer
    before = {"replays": t.collector.replays, "steps": t.agent.minibatch_steps}
    stats: List[Dict[str, float]] = []
    prof = None
    if cell.trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
        with record_function("bench_window"):
            t_w0 = time.perf_counter()
            for _ in range(int(cell.params["trace_updates"])):
                stats.append(s.update())
        s._sync()
        window_s = time.perf_counter() - t_w0
        prof.stop()
    else:
        t_w0 = time.perf_counter()
        while True:
            stats.append(s.update())
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
        prof = None
    updates = len(stats)
    env_steps = updates * s.T * s.N
    pp = s.config.RL.PPO
    K = int(pp.ppo_epoch) * int(pp.num_mini_batch)
    rows = s.N // int(pp.num_mini_batch)
    H = s.arch.hidden
    b1 = (2 * (s.T + 1) * roofline.b1_forward_s(1, s.N, H, gates=False) + 2 * K * roofline.b1_forward_s(s.T, rows, H, gates=True))
    ctx = {
        "trace": trace, "window_s": window_s, "updates": updates, "env_steps": env_steps,
        "replays": t.collector.replays - before["replays"], "minibatch_steps": t.agent.minibatch_steps - before["steps"],
        "least_s": updates * roofline_wpn.update_least_s(s.arch, s.N, s.T, K, rows)["least_s"],
        "b1_bound_s": b1 / (2 * (s.T + 1) + 2 * K),
        "b1_bwd_bound_s": roofline.b1_backward_s(s.T, rows, H),
    }
    nonfinite = sum(1 for st in stats if not all(math.isfinite(v) for v in st.values()))
    print(f"{updates} updates, {env_steps} env steps, {ctx['minibatch_steps']} minibatch steps in {window_s:.3f} s",
          file=sys.stderr)
    print(f"set-up {setup_s:.3f} s: " + ", ".join(f"{k} {v:.3f}" for k, v in s.phases.items()), file=sys.stderr)
    first = s.first
    s.free_program()
    t_ref = time.perf_counter()
    compared = check(s, first)
    compared.pop("rms")
    print(f"reference {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    return {
        "setup_s": setup_s, "e2e": {"train_frames_per_s": env_steps / window_s}, "ctx": ctx,
        "attempted": updates, "failed": nonfinite, "compared": {**compared, "nonfinite_losses": float(nonfinite)},
        "device": device,
    }
