"""On-device closed-loop evaluation and inference: the device-resident grid
world and the policy in one loop on the card, read back once per segment.

Port of vlnce_tpu/trainers/scan_eval.py. The host eval loop
(base_trainer._eval_checkpoint) renders on the host, acts on the card and
steps on the host at every env step. Here the whole loop (render ->
obs transforms -> policy act -> collision-filtered step) runs on the card
(envs/device_sim.py) for a chunk of SCAN_BATCH episodes, SCAN_SEGMENT steps
at a time:

- **One dispatch per segment.** The JAX package jits a `lax.scan` of the
  segment. Here one env step is captured once in a CUDA graph
  (`StepGraph`), which is replayed SCAN_SEGMENT times: the step counter `g`
  and the output row live in device tensors, so a replay needs nothing
  from the host. Inside the step nothing synchronizes with the host (no
  read-back, no branch on a tensor). The graph is captured at the first
  chunk of a shape and kept on the policy; later chunks copy their scenes
  and start poses into its input buffers. A capture that fails raises: there
  is no eager fallback on the card. On the CPU the same step runs eagerly.
- **One read-back per segment**: the segment's actions and the done flags,
  in one copy. The loop leaves a chunk early between segments once every
  episode has called STOP, and pads the last chunk to SCAN_BATCH episodes
  so that the shapes stay those of the graph.
- **Random numbers.** A sampled action (EVAL.SAMPLE) is the inverse CDF of
  the policy's distribution at a uniform drawn beforehand: each segment
  draws its [SCAN_SEGMENT, B] uniforms from the trainer's generator in one
  launch outside the graph, and step g reads row g. Graph and eager draw the
  same numbers.

The measures are the host loop's: the recorded actions are replayed through
the port's host VLNTask with no cameras (`metrics_from_actions`), so every
measure comes from the same code as in the host eval loop.

With `CUDA.FEATURE_BANK_DIR` the step looks the frozen features up in the
scenes' precomputed banks (data/feature_bank.py) in place of rendering: the
bank tensors are fixed per shape like the scenes, and each chunk copies its
banks in. The banks' shapes and the episodes' coverage
(`CUDA.FEATURE_BANK_MAX_DIST`) are checked when the loop starts.

The JAX module's `_eval_mesh` has no counterpart: it is None under several
processes, so each rank runs its scan on its own card, and the port has no
one-process mesh to shard the scan over. With `VIDEO_OPTION` the host replay
keeps its cameras and composes each step's frame (`metrics_from_actions`);
the step graph on the card does not change.

Imported scene geometry (`SIMULATOR.GEOMETRY_DIR`, `CONNECTIVITY_GRAPHS`)
is installed when the loop starts (`scene_import.apply_scene_geometry`). A
chunk's grids pad to its largest scene, and the grid size is part of the
graph's key, so chunks of a larger scene capture graphs of their own.
"""

from __future__ import annotations

import gc
import json
import math
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from vlnce_torch.data.feature_bank import (
    FeatureBankBatch,
    check_bank_coverage,
    load_bank_batch,
    load_bank_shapes,
    lookup_features,
)
from vlnce_torch.envs.device_sim import (
    SceneBatch,
    camera_specs_from_config,
    progress_batch,
    render_batch,
    scene_batch,
    scene_inputs,
    step_batch,
    step_tilt,
    upload,
)
from vlnce_torch.envs.scene_import import apply_scene_geometry
from vlnce_torch.models.distributions import Categorical
from vlnce_torch.ops.obs_transforms import apply_obs_transforms_batch, get_active_obs_transforms
from vlnce_torch.tasks.datasets import make_dataset
from vlnce_torch.tasks.geometry import heading_from_quaternion
from vlnce_torch.tasks.sensors import MAX_INSTRUCTION_LEN
from vlnce_torch.utils.logging import logger
from vlnce_torch.utils.profiling import annotate, maybe_profile
from vlnce_torch.utils.progress import tqdm
from vlnce_torch.utils.video import append_text_to_image, generate_video, observations_to_image

_R2R_ACTIONS = ["STOP", "MOVE_FORWARD", "TURN_LEFT", "TURN_RIGHT"]
_RXR_ACTIONS = _R2R_ACTIONS + ["LOOK_UP", "LOOK_DOWN"]
_CACHE_ATTR = "_scan_segment_cache"
_CACHE_MAX = 8


def bank_setup(config, episodes) -> Optional[Tuple[str, float, tuple]]:
    """The feature-bank route of a loop on the card: None without
    CUDA.FEATURE_BANK_DIR, else (bank_dir, max_dist, (rgb_shape,
    depth_shape)), after the shapes are read from the first episode's bank
    and every episode's start is checked against the banks' coverage."""
    bank_dir = str(config.CUDA.FEATURE_BANK_DIR or "")
    if not bank_dir:
        return None
    max_dist = float(config.CUDA.FEATURE_BANK_MAX_DIST or 0.0)
    shapes = load_bank_shapes(bank_dir, episodes[0])
    check_bank_coverage(bank_dir, episodes, max_dist)
    return bank_dir, max_dist, shapes


def bank_key(setup: Optional[Tuple[str, float, tuple]], bank: Optional[FeatureBankBatch]) -> Optional[tuple]:
    """What a segment's graph depends on in the bank route: the radius and the tensors' shapes."""
    if setup is None:
        return None
    return (setup[1], tuple(bank.node_pos.shape), tuple(bank.rgb.shape), tuple(bank.depth.shape), bank.rgb_shape,
            bank.depth_shape)


def load_chunk_bank(setup: Tuple[str, float, tuple], chunk: List, device) -> FeatureBankBatch:
    """A chunk's banks on `device` in one upload, of the shapes `bank_setup` read."""
    bank = load_bank_batch(setup[0], chunk, device=device)
    if (bank.rgb_shape, bank.depth_shape) != setup[2]:
        raise ValueError(f"feature-bank shapes changed across chunks: {(bank.rgb_shape, bank.depth_shape)} vs {setup[2]}")
    return bank


def _check_supported(config) -> None:
    sim_type = config.TASK_CONFIG.SIMULATOR.TYPE
    if sim_type != "GridWorldSim-v0":
        raise ValueError(
            f"EVAL.ON_DEVICE_SCAN requires the device-resident grid world (SIMULATOR.TYPE=GridWorldSim-v0), got "
            f"{sim_type!r}. Host-bound simulators cannot run inside the loop on the card: use the host eval loop."
        )
    actions = list(config.TASK_CONFIG.TASK.POSSIBLE_ACTIONS)
    if actions not in (_R2R_ACTIONS, _RXR_ACTIONS):
        raise ValueError(
            f"EVAL.ON_DEVICE_SCAN supports the discrete R2R action space {_R2R_ACTIONS} or the RxR space "
            f"{_RXR_ACTIONS}, got {actions}"
        )
    apply_scene_geometry(config.TASK_CONFIG.SIMULATOR)  # real-scene grids, if configured


def _episode_batch_arrays(episodes, instr_uuid: str = "instruction", task_cfg=None) -> Dict[str, np.ndarray]:
    """Start poses and the policy's instruction input per episode: R2R
    policies take zero-padded token ids, RxR policies (sensor_uuid
    "rxr_instruction") the BERT features the host path's
    RxRInstructionSensor loads."""
    pos = np.zeros((len(episodes), 3), np.float32)
    heading = np.zeros((len(episodes),), np.float32)
    for i, ep in enumerate(episodes):
        pos[i] = np.asarray(ep.start_position, np.float32)
        heading[i] = heading_from_quaternion(np.asarray(ep.start_rotation, np.float64))
    if instr_uuid == "instruction":
        instr = np.zeros((len(episodes), MAX_INSTRUCTION_LEN), np.int32)
        for i, ep in enumerate(episodes):
            tokens = ep.instruction.instruction_tokens or []
            n = min(len(tokens), MAX_INSTRUCTION_LEN)
            instr[i, :n] = np.asarray(tokens[:n], np.int32)
    else:
        from vlnce_torch.tasks.sensors import RxRInstructionSensor

        sensor = RxRInstructionSensor(config=task_cfg.TASK.RXR_INSTRUCTION_SENSOR)
        instr = np.stack([sensor.get_observation(episode=ep) for ep in episodes])
    return {"instruction": instr, "pos": pos, "heading": heading}


def chunk_tensors(chunk, instr_uuid: str, task_cfg, device, extra: Optional[Dict[str, np.ndarray]] = None):
    """A chunk's scenes, instruction and start poses (and `extra` arrays) on
    `device` in one upload, then its goal fields built there. Returns
    (SceneBatch, {instruction, pos, heading, goal_fields, goal_index,
    *extra}), with `scene_batch`'s per-goal fields and the episodes' rows of
    them. Its parts are the spans `scan.instructions`, `scan.scenes` (the
    host's scene arrays, and after the upload the field build,
    `scan.field_build`) and `scan.upload`."""
    with annotate("scan.instructions"):
        arrays = _episode_batch_arrays(chunk, instr_uuid=instr_uuid, task_cfg=task_cfg)
    with annotate("scan.scenes"):
        scene = scene_inputs(chunk)
    with annotate("scan.upload"):
        on_dev = upload({**{f"scene.{k}": v for k, v in scene.items()}, **arrays, **(extra or {})}, device)
    with annotate("scan.scenes"):
        inputs = {k: on_dev.pop(f"scene.{k}") for k in scene}
        scenes, on_dev["goal_fields"] = scene_batch(inputs)
    on_dev["goal_index"] = inputs["goal_index"]
    return scenes, on_dev


def _launch_counts() -> Dict[str, int]:
    from vlnce_torch.ops import preprocess, rnn

    return {"gru_sequence": rnn.gru_sequence.launches, "fused_resize_normalize": preprocess.fused_resize_normalize.launches}


class StepGraph:
    """One env step of a closed loop, run n times per segment.

    `compute()` reads the loop's state from fixed tensors and returns the
    step's results; `commit(results)` writes them back in place. On a CUDA
    device (unless `eager`) the step is warmed up once on a side stream (the
    kernels' builds, their tables' uploads and the libraries' plans happen
    there), then `commit(compute())` is captured in a CUDA graph and each
    step is one replay; a failed capture raises. Elsewhere, or with `eager`
    (for comparisons only), each step runs the ops eagerly.
    `capture_launches` holds each kernel wrapper's launches recorded by the
    capture: each replay runs them again."""

    def __init__(self, compute: Callable, commit: Callable, device: torch.device, eager: bool = False):
        self.compute, self.commit = compute, commit
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.replays = 0
        self.capture_launches: Dict[str, int] = {}
        self.capture_seconds = 0.0
        if device.type == "cuda" and not eager:
            with annotate("scan.capture"):
                self._capture(device)

    @torch.no_grad()
    def _capture(self, device) -> None:
        t0 = time.perf_counter()
        main = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self.compute()  # warm-up: its results are dropped, the state is unchanged
        main.wait_stream(side)
        before = _launch_counts()
        graph = torch.cuda.CUDAGraph()
        # the collector stays off during the capture: on the card a collection
        # inside it invalidated the capture (cudaErrorStreamCaptureInvalidated,
        # first reported by cuDNN as CUDNN_STATUS_INTERNAL_ERROR), in some runs
        # of tests/test_torch_kernels.py::test_rollout_graph_matches_eager
        collecting = gc.isenabled()
        gc.disable()
        try:
            # thread_local: another thread may launch work meanwhile (recollection
            # captures its render step on the trainer's prefetch thread)
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self.commit(self.compute())
        finally:
            if collecting:
                gc.enable()
        self.capture_launches = {k: v - before[k] for k, v in _launch_counts().items()}
        self.graph = graph
        self.capture_seconds = time.perf_counter() - t0

    @torch.no_grad()
    def run(self, n: int) -> None:
        for _ in range(n):
            if self.graph is not None:
                self.graph.replay()
            else:
                self.commit(self.compute())
        self.replays += n


def policy_cache(policy) -> Dict[tuple, object]:
    """Built segments, kept on the policy they captured (not in a module
    dict keyed by id(policy), which a new policy could reuse)."""
    cache = policy.__dict__.get(_CACHE_ATTR)
    if cache is None:
        cache = {}
        policy.__dict__[_CACHE_ATTR] = cache
    return cache


def cached(policy, key: tuple, build: Callable):
    return cached_in(policy_cache(policy), key, build, _CACHE_MAX)


def cached_in(cache: Dict, key: tuple, build: Callable, limit: int):
    """cache[key], built on a miss; a FIFO of at most `limit` entries."""
    if key not in cache:
        while len(cache) >= limit:
            cache.pop(next(iter(cache)))
        cache[key] = build()
    return cache[key]


class SegmentTally:
    """The segments a loop ran, with each one's counters when the loop first
    used it, and the segments it built (each a graph capture on the card).
    A loop over chunks of different grid sizes runs several segments: its
    counts are the sums over them."""

    def __init__(self):
        self.used: Dict[int, Tuple[Any, Tuple[int, int, int]]] = {}
        self.built: List[Any] = []

    def recording(self, make: Callable) -> Callable:
        def build():
            segment = make()
            self.built.append(segment)
            return segment

        return build

    def use(self, segment) -> None:
        self.used.setdefault(id(segment), (segment, (segment.segments, segment.readbacks, segment.step.replays)))

    def stats(self) -> Dict[str, Any]:
        pairs = list(self.used.values())
        return {
            "segments": sum(seg.segments - c[0] for seg, c in pairs),
            "readbacks": sum(seg.readbacks - c[1] for seg, c in pairs),
            "replays": sum(seg.step.replays - c[2] for seg, c in pairs),
            "graph": all(seg.step.graph is not None for seg, _ in pairs),
            "captures": sum(seg.step.graph is not None for seg in self.built),
            "capture_seconds": sum(seg.step.capture_seconds for seg in self.built),
            "capture_launches": dict(pairs[0][0].step.capture_launches),
        }


class ScanSegment:
    """The eval loop's segment for a chunk of B episodes: `seg_len` env steps
    per `run()`, one read-back. Its state (poses, tilt, recurrent state,
    previous actions, done flags, the step counter g) and its inputs (the
    chunk's scenes and instructions, the segment's uniforms) are fixed
    tensors on the policy's device; `load()` copies a chunk into them. With
    `bank` (a FeatureBankBatch) the step looks the frozen features up in it
    in place of rendering."""

    def __init__(self, policy, transforms, specs, sim_cfg, deterministic: bool, seg_len: int, scenes: SceneBatch,
                 instruction: torch.Tensor, instr_uuid: str = "instruction", use_tilt: bool = False, eager: bool = False,
                 bank: Optional[FeatureBankBatch] = None, bank_max_dist: float = 0.0):
        device = policy.device
        B = scenes.occupancy.shape[0]
        self.B, self.seg_len, self.device = B, seg_len, device
        forward_step = float(sim_cfg.FORWARD_STEP_SIZE)
        turn_angle = math.radians(float(sim_cfg.TURN_ANGLE))
        tilt_angle = math.radians(float(getattr(sim_cfg, "TILT_ANGLE", sim_cfg.TURN_ANGLE)))
        allow_sliding = bool(sim_cfg.HABITAT_SIM_V0.ALLOW_SLIDING)

        # the first chunk's inputs, so that the warm-up before the capture
        # reads real scenes and token ids
        self.scenes = SceneBatch(*(t.clone() for t in scenes))
        self.instruction = instruction.clone()
        self.pos = torch.zeros(B, 3, device=device)
        self.heading = torch.zeros(B, device=device)
        self.tilt = torch.zeros(B, device=device)
        self.rnn = policy.initial_rnn_states(B)
        self.prev_actions = torch.zeros(B, 1, dtype=torch.long, device=device)
        self.done = torch.zeros(B, dtype=torch.bool, device=device)
        self.g = torch.zeros(1, dtype=torch.long, device=device)
        self.draws = torch.zeros(seg_len, B, device=device)
        # the segment's actions, and the done flags after it in the last row:
        # what one read-back brings home
        self.out = torch.zeros(seg_len + 1, B, dtype=torch.int32, device=device)
        self.logits = torch.zeros(B, policy.num_actions, device=device)  # the last step's, for checks
        self.segments = self.readbacks = 0
        self.deterministic = deterministic
        self.bank = None if bank is None else bank.clone()

        def compute():
            if self.bank is not None:
                obs = lookup_features(self.bank, self.pos, self.heading, max_dist=bank_max_dist)
            else:
                obs = render_batch(self.scenes, self.pos, self.heading, specs, tilt=self.tilt if use_tilt else None)
            obs[instr_uuid] = self.instruction
            obs["progress"] = progress_batch(self.scenes, self.pos)
            batch = apply_obs_transforms_batch(obs, transforms)
            masks = (self.g != 0).to(torch.float32).reshape(1, 1).repeat(B, 1)
            logits, rnn, _ = policy(batch, self.rnn, self.prev_actions, masks)
            row = torch.remainder(self.g, seg_len)
            dist = Categorical(logits)
            action = dist.mode() if deterministic else dist.icdf(self.draws.index_select(0, row)[0])
            a = torch.where(self.done, 0, action.reshape(-1).to(torch.int32))
            done = self.done | (a == 0)
            pos, heading = step_batch(self.scenes, self.pos, self.heading, a, forward_step, turn_angle, allow_sliding)
            tilt = step_tilt(self.tilt, a, tilt_angle) if use_tilt else self.tilt
            pos = torch.where(self.done[:, None], self.pos, pos)
            heading = torch.where(self.done, self.heading, heading)
            tilt = torch.where(self.done, self.tilt, tilt)
            return pos, heading, tilt, rnn, action, done, a, row, logits

        def commit(results):
            pos, heading, tilt, rnn, action, done, a, row, logits = results
            self.logits.copy_(logits)
            self.pos.copy_(pos)
            self.heading.copy_(heading)
            self.tilt.copy_(tilt)
            self.rnn.copy_(rnn)
            self.prev_actions.copy_(action)
            self.done.copy_(done)
            self.out.index_copy_(0, row, a[None])
            self.out[seg_len].copy_(done)
            self.g.add_(1)

        self.step = StepGraph(compute, commit, device, eager=eager)

    def load(self, scenes: SceneBatch, instruction: torch.Tensor, pos: torch.Tensor, heading: torch.Tensor,
             bank: Optional[FeatureBankBatch] = None) -> None:
        """Start a chunk: its inputs into the segment's tensors, the state
        reset. Device copies only."""
        for dst, src in zip(self.scenes, scenes):
            dst.copy_(src)
        if bank is not None:
            self.bank.copy_(bank)
        self.instruction.copy_(instruction)
        self.pos.copy_(pos)
        self.heading.copy_(heading)
        for t in (self.tilt, self.rnn, self.prev_actions, self.done, self.g, self.out):
            t.zero_()

    def run(self, generator: Optional[torch.Generator] = None):
        """seg_len steps, then the one read-back: (actions [seg_len, B] int32,
        done [B] bool) on the host, in the spans `scan.replays` and
        `scan.readback`."""
        if not self.deterministic:
            self.draws.uniform_(0.0, 1.0, generator=generator)
        with annotate("scan.replays"):
            self.step.run(self.seg_len)
        with annotate("scan.readback"):
            out = self.out.cpu().numpy().copy()  # on the CPU, .cpu() is the tensor itself
        self.segments += 1
        self.readbacks += 1
        return out[: self.seg_len], out[self.seg_len].astype(bool)


def run_scan_rollouts(policy, transforms, config, episodes: List, generator: Optional[torch.Generator] = None,
                      progress_cb=None, stats: Optional[Dict[str, float]] = None, eager: bool = False) -> List[np.ndarray]:
    """Closed-loop rollouts of `episodes` on the policy's device; returns each
    episode's actions up to and including STOP, or to the step cap. `stats`
    (if given) gets the segment, replay and read-back counts and the
    seconds spent (of them, the chunks' host setup and upload); `eager` runs the step without a graph (comparisons
    only)."""
    task_cfg = config.TASK_CONFIG
    apply_scene_geometry(task_cfg.SIMULATOR)  # real-scene grids, if configured
    specs = camera_specs_from_config(task_cfg.SIMULATOR)
    T_max = int(task_cfg.ENVIRONMENT.MAX_EPISODE_STEPS)
    B = max(1, int(config.EVAL.SCAN_BATCH))
    seg_len = max(1, min(int(config.EVAL.SCAN_SEGMENT), T_max))
    deterministic = not bool(config.EVAL.SAMPLE)
    instr_uuid = str(getattr(config.MODEL.INSTRUCTION_ENCODER, "sensor_uuid", "instruction"))
    use_tilt = "LOOK_UP" in list(task_cfg.TASK.POSSIBLE_ACTIONS)
    device = policy.device
    bank = bank_setup(config, episodes)

    all_actions: List[np.ndarray] = []
    t0 = time.perf_counter()
    segment = None
    tally = SegmentTally()
    setup_seconds = 0.0
    for lo in range(0, len(episodes), B):
        chunk = episodes[lo : lo + B]
        real = len(chunk)
        chunk = chunk + [chunk[-1]] * (B - real)  # a padded last chunk keeps the graph's shapes
        with annotate("scan.chunk"):
            with annotate("scan.setup"):
                t_setup = time.perf_counter()
                scenes, arrays = chunk_tensors(chunk, instr_uuid, task_cfg, device)
                chunk_bank = None
                if bank is not None:
                    with annotate("scan.bank"):
                        chunk_bank = load_chunk_bank(bank, chunk, device)
                setup_seconds += time.perf_counter() - t_setup
            key = ("eval", tuple(specs), B, seg_len, deterministic, instr_uuid, use_tilt,
                   tuple(type(t).__name__ for t in transforms), tuple(scenes.occupancy.shape),
                   tuple(arrays["instruction"].shape), task_cfg.SIMULATOR.FORWARD_STEP_SIZE,
                   task_cfg.SIMULATOR.TURN_ANGLE, eager, bank_key(bank, chunk_bank))
            segment = cached(policy, key, tally.recording(lambda: ScanSegment(
                policy, transforms, specs, task_cfg.SIMULATOR, deterministic, seg_len, scenes, arrays["instruction"],
                instr_uuid=instr_uuid, use_tilt=use_tilt, eager=eager, bank=chunk_bank,
                bank_max_dist=0.0 if bank is None else bank[1])))
            with annotate("scan.load"):
                segment.load(scenes, arrays["instruction"], arrays["pos"], arrays["heading"], chunk_bank)
            tally.use(segment)  # a segment from the cache carries the counts of earlier calls
            collected = []
            t = 0
            while t < T_max:
                actions, done = segment.run(generator)
                collected.append(actions)
                t += seg_len
                if done.all():
                    break  # every episode of the chunk has called STOP
        acts = np.concatenate(collected, axis=0)[:T_max]
        for i in range(real):
            seq = acts[:, i]
            stops = np.flatnonzero(seq == 0)
            all_actions.append(seq[: int(stops[0]) + 1] if len(stops) else seq)
            if progress_cb is not None:
                progress_cb()
    if stats is not None and segment is not None:
        stats.update({
            "seconds": time.perf_counter() - t0, "setup_seconds": setup_seconds, "seg_len": seg_len, "batch": B,
            **tally.stats(), "env_steps": int(sum(len(s) for s in all_actions)),
        })
    return all_actions


def _replay_task(config, keep_cameras: bool = False, keep_measures: bool = True):
    """A host simulator and VLNTask of the config with no cameras and no
    sensors (and no measures unless kept), for replaying actions."""
    from vlnce_torch.envs import ensure_registered
    from vlnce_torch.registry import registry
    from vlnce_torch.tasks.task import VLNTask

    ensure_registered()
    task_cfg = config.TASK_CONFIG.clone()
    task_cfg.defrost()
    if not keep_cameras:
        task_cfg.SIMULATOR.AGENT_0.SENSORS = []
    task_cfg.TASK.SENSORS = []
    if not keep_measures:
        task_cfg.TASK.MEASUREMENTS = []
    task_cfg.freeze()
    sim = registry.get_simulator(task_cfg.SIMULATOR.TYPE)(task_cfg.SIMULATOR)
    return sim, VLNTask(task_cfg.TASK, sim), int(task_cfg.ENVIRONMENT.MAX_EPISODE_STEPS)


def _start(sim, task, ep) -> None:
    sim.reconfigure(ep.scene_id)
    sim.reset()
    sim.set_agent_state(ep.start_position, ep.start_rotation)
    task.reset(ep)


def metrics_from_actions(config, episodes: List, action_seqs: List[np.ndarray], writer=None,
                         checkpoint_index: int = 0) -> Dict[str, Dict]:
    """Replay recorded actions through the host measures; returns the
    per-episode info dicts the host eval loop records. With no VIDEO_OPTION
    the replay runs with zero cameras; otherwise the cameras stay attached
    and each step's frame is composed and written as the host eval loop
    does (base_trainer.py)."""
    video = list(getattr(config, "VIDEO_OPTION", []) or [])
    sim, task, max_steps = _replay_task(config, keep_cameras=bool(video))
    stats: Dict[str, Dict] = {}
    for ep, seq in zip(episodes, action_seqs):
        _start(sim, task, ep)
        steps = 0
        frames = []
        for a in seq:
            obs = task.step(int(a), ep)
            steps += 1
            if video:
                frame = observations_to_image(obs, task.measurements.get_metrics())
                frames.append(append_text_to_image(frame, ep.instruction.instruction_text))
            if task.is_stop_called or steps >= max_steps:
                break
        metrics = task.measurements.get_metrics()
        stats[ep.episode_id] = {k: v for k, v in metrics.items() if np.isscalar(v) or isinstance(v, (int, float))}
        if video:
            generate_video(
                video_option=video, video_dir=config.VIDEO_DIR, images=frames,
                episode_id=ep.episode_id, checkpoint_idx=checkpoint_index,
                metrics={"spl": stats[ep.episode_id].get("spl", 0.0)}, tb_writer=writer,
            )
    return stats


def infos_from_actions(config, episodes: List, action_seqs: List[np.ndarray]) -> Dict[str, List[Dict]]:
    """Replay recorded actions, recording the inference info (position,
    heading, stop) at the start and after every step: the payload the host
    inference loop collects from VLNCEInferenceEnv.get_info."""
    sim, task, max_steps = _replay_task(config, keep_measures=False)

    def info() -> Dict:
        state = sim.get_agent_state()
        return {
            "position": [float(x) for x in state.position],
            "heading": heading_from_quaternion(state.rotation),
            "stop": task.is_stop_called,
        }

    preds: Dict[str, List[Dict]] = {}
    for ep, seq in zip(episodes, action_seqs):
        _start(sim, task, ep)
        infos = [info()]
        steps = 0
        for a in seq:
            task.step(int(a), ep)
            infos.append(info())
            steps += 1
            if task.is_stop_called or steps >= max_steps:
                break
        preds[ep.episode_id] = infos
    return preds


def _setup(trainer, config, load_from_ckpt: bool) -> List:
    _check_supported(config)
    trainer.obs_transforms = get_active_obs_transforms(config)
    observation_space, action_space = trainer._get_spaces(config)
    trainer._initialize_policy(config, load_from_ckpt=load_from_ckpt, observation_space=observation_space,
                               action_space=action_space)
    return list(make_dataset(config.TASK_CONFIG.DATASET.TYPE, config.TASK_CONFIG.DATASET).episodes)


def _profile_dir(config, run: str) -> str:
    """Where a loop on the card writes its torch.profiler trace: a folder of
    CUDA.PROFILE_DIR per run, or "" (no trace) where that is unset."""
    root = str(config.CUDA.PROFILE_DIR or "")
    return os.path.join(root, run) if root else ""


def inference_on_device(trainer, config) -> None:
    """The scan counterpart of BaseVLNCETrainer.inference's env loop: actions
    collected on the card, the pose trace from the host replay, predictions
    written in the r2r or rxr format."""
    with maybe_profile(_profile_dir(config, "inference")):
        episodes = _setup(trainer, config, os.path.exists(config.IL.ckpt_to_load))
        # the rollout reads EVAL.SAMPLE; inference's flag is INFERENCE.SAMPLE
        run_cfg = config.clone()
        run_cfg.defrost()
        run_cfg.EVAL.SAMPLE = bool(config.INFERENCE.SAMPLE)
        run_cfg.freeze()
        scan = {}
        pbar = tqdm(total=len(episodes), desc="scan-inference")
        action_seqs = run_scan_rollouts(trainer.policy, trainer.obs_transforms, run_cfg, episodes, trainer.generator,
                                        progress_cb=pbar.update, stats=scan)
        pbar.close()
        t0 = time.perf_counter()
        episode_predictions = infos_from_actions(config, episodes, action_seqs)
        trainer.last_loop_timing = {**scan, "replay_seconds": time.perf_counter() - t0}
        instruction_ids: Dict[str, str] = {}
        if config.INFERENCE.FORMAT == "rxr":
            for ep in episodes:
                k = getattr(ep.instruction, "instruction_id", None) or ep.episode_id
                instruction_ids[ep.episode_id] = int(k) if str(k).isdigit() else k
        trainer._write_predictions(config, episode_predictions, instruction_ids)


def eval_checkpoint_on_device(trainer, config, checkpoint_path: str, writer, checkpoint_index: int,
                              stats_fname: Optional[str]) -> Dict[str, float]:
    """The scan counterpart of BaseVLNCETrainer._eval_checkpoint's env loop."""
    with maybe_profile(_profile_dir(config, f"eval_ckpt_{checkpoint_index}")):
        episodes = _setup(trainer, config, os.path.exists(checkpoint_path))
        if config.EVAL.EPISODE_COUNT > -1:
            episodes = episodes[: config.EVAL.EPISODE_COUNT]

        scan = {}
        pbar = tqdm(total=len(episodes), desc=f"scan-eval ckpt {checkpoint_index}")
        action_seqs = run_scan_rollouts(trainer.policy, trainer.obs_transforms, config, episodes, trainer.generator,
                                        progress_cb=pbar.update, stats=scan)
        pbar.close()
        t0 = time.perf_counter()
        stats_episodes = metrics_from_actions(config, episodes, action_seqs, writer=writer,
                                              checkpoint_index=checkpoint_index)
        trainer.last_loop_timing = timing = {**scan, "replay_seconds": time.perf_counter() - t0}
        trainer._last_eval_episode_stats = stats_episodes

        aggregated: Dict[str, float] = {}
        if stats_episodes:
            for k in next(iter(stats_episodes.values())).keys():
                aggregated[k] = float(np.mean([v[k] for v in stats_episodes.values()]))
        if stats_fname is not None and stats_episodes:
            with open(stats_fname, "w") as f:
                json.dump(aggregated, f, indent=4)

        steps = timing.get("env_steps", 0)
        seconds = timing.get("seconds", 0.0) + timing["replay_seconds"]
        logger.info(
            f"Episodes evaluated (on-device scan): {len(stats_episodes)}; {steps} env steps in {seconds:.1f}s "
            f"(device loop {timing.get('seconds', 0.0):.2f}s, host replay {timing['replay_seconds']:.2f}s)"
        )
        for k, v in aggregated.items():
            logger.info(f"{k}: {v:.6f}")
            writer.add_scalar(f"eval_{config.EVAL.SPLIT}_{k}", v, checkpoint_index + 1)
        return aggregated
