"""DAgger collection on the card: render + frozen-encoder features + policy
act + device expert + beta mix + sim step, one CUDA graph replay per env
step, one read-back of the done flags per segment.

Port of vlnce_tpu/trainers/device_dagger.py. The
host collection loop (dagger_trainer._update_dataset) renders on the host
and crosses to the card at every env step. Here the device-resident grid
world (envs/device_sim.py) and its expert (`expert_action`, the host
ShortestPathSensor's rule) run the loop for a chunk of NUM_ENVIRONMENTS
episodes on the card, CUDA.DAGGER_SEGMENT steps per segment, with the
segment machinery of trainers/scan_eval.py (`StepGraph`: one step captured,
replayed; eager on the CPU). Each step writes its row of the store payload
(progress, prev_action, oracle, done_before and the frozen encoders'
features, flattened) into output tensors; after a segment the done flags
come back in one read-back and the rows are kept on the card.

Wire dtypes are JAX's: bf16 features leave the segment as f16 clamped to
the f16 range (exact for bf16 values in range), f32 rows as f16 where
IL.DAGGER.lmdb_fp16 is set; without it the features are stored as f32.

The policy's action is drawn (the JAX package's act with deterministic
False) as the inverse CDF of a uniform, and the beta mix `where(u < beta,
expert, policy)` takes a second uniform: both are drawn per segment from
the trainer's generator into a [DAGGER_SEGMENT, 2, B] tensor outside the
graph. beta sits in a device scalar, so one graph serves every round.

Two consumers share the chunk loop `_chunk_rollouts`:

- `collect_episodes_on_device`: after a chunk its rows come back in one bulk
  copy, in the schema the trajectory store expects;
- `collect_episodes_resident` (CUDA.DAGGER_RESIDENT): nothing but the done
  flags comes back; the rows are packed on the card, episode-major, into a
  `data/device_bank.DeviceTrajectoryBank` that the IL train step reads
  directly.

With CUDA.FEATURE_BANK_DIR the step looks the frozen features up in a
precomputed bank (data/feature_bank.py) in place of rendering; the
looked-up features are the payload rows, in the store and in the bank, and
the device expert, which steers by the scene's geometry, is unchanged.

Episode selection is the JAX path's: the first update_size episodes in
dataset order (`DaggerTrainer._collection_plan`).
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from vlnce_torch.data.feature_bank import lookup_features
from vlnce_torch.envs.device_sim import (
    SceneBatch,
    camera_specs_from_config,
    expert_action,
    progress_batch,
    render_batch,
    step_batch,
    upload,
)
from vlnce_torch.envs.scene_import import apply_scene_geometry
from vlnce_torch.models.distributions import Categorical
from vlnce_torch.ops.obs_transforms import apply_obs_transforms_batch
from vlnce_torch.trainers.scan_eval import (
    SegmentTally,
    StepGraph,
    bank_key,
    bank_setup,
    cached,
    chunk_tensors,
    load_chunk_bank,
)
from vlnce_torch.utils.logging import logger

_F16_MAX = 65504.0


def _goal_xz(episodes) -> np.ndarray:
    """Each episode's first goal's x, z [B, 2] f32: the host ShortestPathSensor
    steers by episode.goals[0].position."""
    return np.asarray([[float(ep.goals[0].position[0]), float(ep.goals[0].position[-1])] for ep in episodes],
                      np.float32)


def _expert_field(tensors: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Each episode's first-goal distance field [B, N, N] f32, the expert's:
    that goal's row of the chunk's goal fields, built on the device with the
    rest (`chunk_tensors`' goal_fields and goal_index; +inf in the padding
    of a smaller grid)."""
    return tensors["goal_fields"][tensors["goal_index"][:, 0].long()]


def _wire(v: torch.Tensor, store_f16: bool) -> torch.Tensor:
    if v.dtype == torch.bfloat16:
        return v.float().clamp(-_F16_MAX, _F16_MAX).to(torch.float16)
    if store_f16 and v.dtype == torch.float32:
        return v.to(torch.float16)
    return v


class DaggerSegment:
    """The collection loop's segment for a chunk of B episodes: `seg_len`
    env steps per `run()`, one read-back of the done flags. State, inputs
    and the payload rows are fixed tensors on the policy's device; `load()`
    copies a chunk in. With `bank` (a FeatureBankBatch) the step looks the
    frozen features up in it in place of rendering."""

    def __init__(self, policy, transforms, specs, config, seg_len: int, scenes: SceneBatch, tensors: Dict[str, torch.Tensor],
                 eager: bool = False, bank=None, bank_max_dist: float = 0.0):
        task_cfg = config.TASK_CONFIG
        sim_cfg = task_cfg.SIMULATOR
        device = policy.device
        B = scenes.occupancy.shape[0]
        self.B, self.seg_len, self.device = B, seg_len, device
        forward_step = float(sim_cfg.FORWARD_STEP_SIZE)
        turn_angle = math.radians(float(sim_cfg.TURN_ANGLE))
        allow_sliding = bool(sim_cfg.HABITAT_SIM_V0.ALLOW_SLIDING)
        goal_radius = float(task_cfg.TASK.SHORTEST_PATH_SENSOR.GOAL_RADIUS)
        store_f16 = bool(config.IL.DAGGER.lmdb_fp16)
        instr_uuid = str(config.MODEL.INSTRUCTION_ENCODER.sensor_uuid)

        # the first chunk's inputs, so that the probe and the warm-up read real data
        self.scenes = SceneBatch(*(t.clone() for t in scenes))
        self.inputs = {k: tensors[k].clone() for k in ("instruction", "expert_field", "goal_xz")}
        self.pos = tensors["pos"].clone()
        self.heading = tensors["heading"].clone()
        self.rnn = policy.initial_rnn_states(B)
        self.prev_actions = torch.zeros(B, 1, dtype=torch.long, device=device)
        self.done = torch.zeros(B, dtype=torch.bool, device=device)
        self.g = torch.zeros(1, dtype=torch.long, device=device)
        self.beta = torch.zeros((), device=device)
        self.draws = torch.zeros(seg_len, 2, B, device=device)
        self.segments = self.readbacks = 0
        self.bank = None if bank is None else bank.clone()

        def compute():
            if self.bank is not None:
                obs = lookup_features(self.bank, self.pos, self.heading, max_dist=bank_max_dist)
                feats = dict(obs)  # the lookup is the frozen-feature payload (the encoders take it as is)
            else:
                obs = render_batch(self.scenes, self.pos, self.heading, specs)
            obs[instr_uuid] = self.inputs["instruction"]
            obs["progress"] = progress_batch(self.scenes, self.pos)
            batch = apply_obs_transforms_batch(obs, transforms)
            masks = (self.g != 0).to(torch.float32).reshape(1, 1).repeat(B, 1)
            logits, rnn, _ = policy(batch, self.rnn, self.prev_actions, masks)
            row = torch.remainder(self.g, seg_len)
            draws = self.draws.index_select(0, row)[0]  # [2, B]
            action = Categorical(logits).icdf(draws[0])  # [B, 1]
            expert = expert_action(self.scenes.occupancy, self.inputs["expert_field"], self.inputs["goal_xz"],
                                   self.pos, self.heading, goal_radius, turn_angle, origin=self.scenes.origin_xz)
            mixed = torch.where(draws[1] < self.beta, expert.long(), action[:, 0])
            a = torch.where(self.done, 0, mixed.to(torch.int32))
            emit = {
                "progress": _wire(obs["progress"], store_f16),
                "prev_action": self.prev_actions.reshape(-1).to(torch.int32),
                "oracle": expert,
                "done_before": self.done,
            }
            for k, v in (feats if self.bank is not None else policy.visual_features()).items():
                emit[k] = _wire(v.reshape(B, -1), store_f16)
            pos, heading = step_batch(self.scenes, self.pos, self.heading, a, forward_step, turn_angle, allow_sliding)
            pos = torch.where(self.done[:, None], self.pos, pos)
            heading = torch.where(self.done, self.heading, heading)
            return pos, heading, rnn, mixed[:, None], self.done | (a == 0), emit, row

        def commit(results):
            pos, heading, rnn, mixed, done, emit, row = results
            for k, v in emit.items():  # first: done_before is the state's done
                self.rows[k].index_copy_(0, row, v[None])
            self.pos.copy_(pos)
            self.heading.copy_(heading)
            self.rnn.copy_(rnn)
            self.prev_actions.copy_(mixed)
            self.done.copy_(done)
            self.flags[seg_len].copy_(done)
            self.g.add_(1)

        # one probe step for the payload's keys, shapes and dtypes
        with torch.no_grad():
            emit = compute()[5]
        if self.bank is not None:
            self.feat_shapes = {"rgb_features": self.bank.rgb_shape, "depth_features": self.bank.depth_shape}
        else:
            self.feat_shapes = {k: tuple(policy.visual_features()[k].shape[1:]) for k in emit if k.endswith("_features")}
        self.rows = {k: torch.zeros((seg_len,) + tuple(v.shape), dtype=v.dtype, device=device) for k, v in emit.items()}
        self.flags = torch.zeros(seg_len + 1, B, dtype=torch.uint8, device=device)
        self.rows["done_before"] = self.flags[:seg_len].view(torch.bool)  # the read-back's rows
        self.step = StepGraph(compute, commit, device, eager=eager)

    def load(self, scenes: SceneBatch, tensors: Dict[str, torch.Tensor], beta: float, bank=None) -> None:
        for dst, src in zip(self.scenes, scenes):
            dst.copy_(src)
        if bank is not None:
            self.bank.copy_(bank)
        for k, v in self.inputs.items():
            v.copy_(tensors[k])
        self.pos.copy_(tensors["pos"])
        self.heading.copy_(tensors["heading"])
        for t in (self.rnn, self.prev_actions, self.done, self.g, self.flags):
            t.zero_()
        self.beta.fill_(beta)

    def run(self, generator: Optional[torch.Generator] = None):
        """seg_len steps, then the one read-back: (done_before [seg_len, B],
        done after [B]) on the host. The payload rows stay on the card:
        returns them as copies too."""
        self.draws.uniform_(0.0, 1.0, generator=generator)
        self.step.run(self.seg_len)
        rows = {k: v.clone() for k, v in self.rows.items() if k != "done_before"}
        flags = self.flags.cpu().numpy().astype(bool)
        self.segments += 1
        self.readbacks += 1
        return flags[: self.seg_len], flags[self.seg_len], rows


def _chunk_rollouts(policy, transforms, config, episodes: List, beta: float, generator=None, stats=None,
                    eager: bool = False):
    """The beta-mixed collection, chunk by chunk. Yields (real, instruction
    [B, ...] on the card, pieces, done_before [T, B] numpy, feat_shapes) per
    chunk of NUM_ENVIRONMENTS episodes: `pieces` are the segments' payload
    rows on the card ([seg_len, B, ...] each)."""
    task_cfg = config.TASK_CONFIG
    apply_scene_geometry(task_cfg.SIMULATOR)  # real-scene grids, if configured
    # the feature-bank route: its shapes and the episodes' coverage are checked here, before any chunk
    bank = bank_setup(config, episodes)
    specs = camera_specs_from_config(task_cfg.SIMULATOR)
    T_max = int(task_cfg.ENVIRONMENT.MAX_EPISODE_STEPS)
    B = max(1, int(config.NUM_ENVIRONMENTS))
    instr_uuid = str(config.MODEL.INSTRUCTION_ENCODER.sensor_uuid)
    # episodes finish in tens of steps: a segment of the whole step cap would
    # compute and read back hundreds of padded steps per env
    seg_len = max(1, min(int(config.CUDA.DAGGER_SEGMENT), T_max))
    device = policy.device
    t0 = time.perf_counter()
    segment = None
    tally = SegmentTally()
    setup_seconds = 0.0
    for lo in range(0, len(episodes), B):
        chunk = episodes[lo : lo + B]
        real = len(chunk)
        chunk = chunk + [chunk[-1]] * (B - real)
        t_setup = time.perf_counter()
        scenes, tensors = chunk_tensors(chunk, instr_uuid, task_cfg, device, {"goal_xz": _goal_xz(chunk)})
        tensors["expert_field"] = _expert_field(tensors)
        chunk_bank = None if bank is None else load_chunk_bank(bank, chunk, device)
        setup_seconds += time.perf_counter() - t_setup
        key = ("dagger", tuple(specs), B, seg_len, bool(config.IL.DAGGER.lmdb_fp16),
               float(task_cfg.TASK.SHORTEST_PATH_SENSOR.GOAL_RADIUS), task_cfg.SIMULATOR.TURN_ANGLE,
               task_cfg.SIMULATOR.FORWARD_STEP_SIZE, bool(task_cfg.SIMULATOR.HABITAT_SIM_V0.ALLOW_SLIDING),
               tuple(type(t).__name__ for t in transforms), instr_uuid, tuple(scenes.occupancy.shape),
               tuple(tensors["instruction"].shape), eager, bank_key(bank, chunk_bank))
        segment = cached(policy, key, tally.recording(lambda: DaggerSegment(
            policy, transforms, specs, config, seg_len, scenes, tensors, eager=eager, bank=chunk_bank,
            bank_max_dist=0.0 if bank is None else bank[1])))
        segment.load(scenes, tensors, beta, chunk_bank)
        tally.use(segment)  # a segment from the cache carries the counts of earlier calls
        pieces, done_rows = [], []
        t = 0
        while t < T_max:
            done_before, done_after, rows = segment.run(generator)
            pieces.append(rows)
            done_rows.append(done_before)
            t += seg_len
            if done_after.all():
                break
        yield real, tensors["instruction"], pieces, np.concatenate(done_rows, axis=0)[:T_max], segment.feat_shapes
    if stats is not None and segment is not None:
        stats.update({"seconds": time.perf_counter() - t0, "setup_seconds": setup_seconds, "seg_len": seg_len,
                      "batch": B, **tally.stats()})


def _episode_lengths(done_before: np.ndarray, real: int, T_max: int) -> np.ndarray:
    """The first done flag of each env column: the steps recorded for its
    episode. An env whose STOP lands on the last step of the final segment
    gets no done flag into done_before (the flags are those before each
    step, and the loop leaves on the state after it): its length is the
    number of recorded rows, not T_max."""
    recorded = int(done_before.shape[0])
    lengths = np.empty((real,), np.int64)
    for b in range(real):
        ends = np.flatnonzero(done_before[:, b])
        T_ep = int(ends[0]) if len(ends) else min(recorded, T_max)
        lengths[b] = max(T_ep, 1)  # an episode that starts at its goal: one STOP step
    return lengths


def collect_episodes_on_device(policy, transforms, config, episodes: List, beta: float, generator=None,
                               progress_cb=None, stats: Optional[Dict] = None,
                               eager: bool = False) -> List[Tuple[Dict[str, np.ndarray], np.ndarray, np.ndarray]]:
    """Collect `episodes` with the beta-mixed expert / policy on the card.
    Returns (traj_obs, prev_actions, oracle_actions) per episode in episode
    order: the payload the host loop's flush_episode writes into the
    trajectory store. `stats` (if given) gets the segment and read-back
    counts and the seconds; `eager` runs the step without a graph
    (comparisons only)."""
    T_max = int(config.TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS)
    store_f16 = bool(config.IL.DAGGER.lmdb_fp16)
    instr_uuid = str(config.MODEL.INSTRUCTION_ENCODER.sensor_uuid)
    results = []
    chunk_readbacks = 0
    for real, instruction, pieces, done_before, feat_shapes in _chunk_rollouts(
        policy, transforms, config, episodes, beta, generator, stats=stats, eager=eager
    ):
        # one bulk read-back per chunk: the rows crossed nowhere else
        seq = {k: torch.cat([p[k] for p in pieces])[:T_max].cpu().numpy() for k in pieces[0]}
        instr_np = instruction.cpu().numpy()
        chunk_readbacks += 1
        lengths = _episode_lengths(done_before, real, T_max)
        for b in range(real):
            T_ep = int(lengths[b])
            traj_obs = {
                instr_uuid: np.repeat(instr_np[b][None], T_ep, axis=0),
                "progress": seq["progress"][:T_ep, b],
            }
            for k, shape in feat_shapes.items():
                flat = seq[k][:T_ep, b]
                if not store_f16:  # f16 was only the wire dtype
                    flat = flat.astype(np.float32)
                traj_obs[k] = flat.reshape((T_ep,) + shape)
            prev = seq["prev_action"][:T_ep, b].astype(np.int64)
            oracle = seq["oracle"][:T_ep, b].astype(np.int64)
            results.append((traj_obs, prev, oracle))
            if progress_cb is not None:
                progress_cb()
    if stats is not None:
        stats["chunk_readbacks"] = chunk_readbacks
        stats["env_steps"] = int(sum(len(r[1]) for r in results))
    return results


def _build_pack(pieces: List[Dict[str, torch.Tensor]], T_cut: int, sel: torch.Tensor, keys) -> Dict[str, torch.Tensor]:
    """A chunk's pack on the card (the JAX module's `_build_pack`, without
    the jit it builds): the segments' rows joined along time and cut to the
    step cap, then the episode-major valid rows `sel` of the flat [t * B +
    b] rows taken by one `index_select` per key. prev_action and oracle
    become int32."""
    out = {}
    for k in keys:
        seq = torch.cat([p[k] for p in pieces])[:T_cut]
        g = seq.reshape((seq.shape[0] * seq.shape[1],) + tuple(seq.shape[2:])).index_select(0, sel)
        out[k] = g.to(torch.int32) if k in ("prev_action", "oracle") else g
    return out


def collect_episodes_resident(policy, transforms, config, episodes: List, beta: float, generator=None,
                              progress_cb=None, stats: Optional[Dict] = None, eager: bool = False):
    """Collect `episodes` on the card and keep them there: returns a
    DeviceTrajectoryBank whose rows never visit the host. Per chunk the only
    read-backs are the done flags (one per segment); the rows are packed
    episode-major by `_build_pack` with the one small upload of its `sel`
    index. `stats` as `collect_episodes_on_device` fills it (with
    `chunk_readbacks` 0)."""
    from vlnce_torch.data.device_bank import DeviceTrajectoryBank

    T_max = int(config.TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS)
    B = max(1, int(config.NUM_ENVIRONMENTS))
    device = policy.device
    row_chunks, prev_chunks, oracle_chunks, instr_chunks = [], [], [], []
    all_lengths: List[int] = []
    shapes: Dict[str, tuple] = {}
    for real, instruction, pieces, done_before, feat_shapes in _chunk_rollouts(
        policy, transforms, config, episodes, beta, generator, stats=stats, eager=eager
    ):
        lengths = _episode_lengths(done_before, real, T_max)
        T_cut = min(sum(int(p["oracle"].shape[0]) for p in pieces), T_max)
        # the episode-major flat (t, b) indices of the episodes' rows
        sel = np.concatenate([np.arange(lengths[b], dtype=np.int64) * B + b for b in range(real)])
        packed = _build_pack(pieces, T_cut, upload({"sel": sel}, device)["sel"], tuple(pieces[0]))
        prev_chunks.append(packed.pop("prev_action"))
        oracle_chunks.append(packed.pop("oracle"))
        row_chunks.append(packed)
        instr_chunks.append(instruction[:real])
        all_lengths.extend(int(x) for x in lengths)
        shapes = {**feat_shapes, "progress": (1,)}
        if progress_cb is not None:
            for _ in range(real):
                progress_cb()
    bank = DeviceTrajectoryBank.from_rows(row_chunks, prev_chunks, oracle_chunks, instr_chunks, all_lengths, shapes,
                                          instr_uuid=str(config.MODEL.INSTRUCTION_ENCODER.sensor_uuid))
    if stats is not None:
        stats["chunk_readbacks"] = 0
        stats["env_steps"] = bank.num_steps
    logger.info(f"device bank: {len(bank)} episodes, {bank.num_steps} steps, {bank.nbytes() / 2**20:.1f} MiB resident")
    return bank
