"""On-device RL rollout collection: the grid world, the waypoint policy and
the reward on the card, one CUDA graph replay per env step.

Port of vlnce_tpu/rl/device_rollout.py. The host rollout of the
ddppo-waypoint trainer crosses the host and the card at every env step
(render and pickling in the simulator workers, one upload, the act step, the
download of the actions). Here the whole collection loop (pano render, obs
transforms, the policy's act, GO_TOWARD_POINT dynamics, the shaped reward,
the auto-reset from a preloaded episode queue, the history frames) runs on
the card for PPO.num_steps steps, and the PPO batch stays there for
`WDDPPO.update_device_scan`:

- **One env step is one replay of a CUDA graph** (`ops/graphs.StepGraph`):
  the carry (poses, recurrent state, previous actions, mask, distance to
  the goal, the slots' episode indices, step counts, episode rewards,
  history frames) and the step counter `g` live in fixed tensors; each
  step writes row g of the [T, B, ...] output buffers by `index_copy_`.
  The bootstrap value, the returns and the normalized advantages are a
  second graph, replayed once after the T steps. On the CPU, or with
  `eager` (comparisons only), the same steps run eagerly.
- **Random draws.** A rollout draws its [T, 3, B] uniforms from the
  trainer's generator in one launch outside the graph; step g's pano,
  distance and offset are the inverse CDFs of the policy's distributions at
  row g (`WaypointPolicy.act(uniforms=...)`). The JAX rollout folds the step
  into a key, so sampled rollouts agree with it in distribution only; greedy
  ones agree exactly.
- **Episodes.** One round-robin stream of the train split per slot (the
  analog of construct_envs' scene split and the workers' auto-reset). The
  whole split (at most CUDA.EPISODE_BANK_MAX episodes) is built once as a
  bank on the card; a rollout then uploads only its [B, Q] slot map (Q = T +
  1, one done per step at most) and gathers its queue from the bank on the
  card. Above the cap each rollout builds its queue. Either way the host
  uploads the distinct scenes and each episode's goal cells, and the card
  builds the distinct goals' fields in one launch of `goal_distance_fields`
  (csrc/goal_field.cu; its plain relaxation on the CPU), equal to the
  host's Dijkstra fields bit for bit. Imported scenes of mixed sizes pad to
  the split's largest grid.
- **Spans** (`utils/profiling.annotate`): `ppo.bank` around the bank's
  build, holding `ppo.field_build`; per rollout `ppo.rollout` around
  `ppo.load` (the queue's gather, the graphs' build at a new grid size),
  `ppo.replays` (the T step replays and the bootstrap) and `ppo.readback`.
- **One read-back per rollout**: the episode stats, the slots' episode
  indices and the running episode rewards, in one copy.
- **Stored features.** Each step also keeps its act step's frozen-backbone
  outputs (`WaypointPredictionNet.backbone_features`: the 12 views and the
  masked history frame, [T, B, 13, C, h, w] in the compute dtype) under
  the batch's `features`, beside the frames in `obs`; the PPO update reads
  them in place of running the backbones again. The bootstrap's are not
  kept: no update reads them.

Parity: the dynamics are device_sim.waypoint_step, the reward
device_sim.waypoint_reward (both held against the host env), and done is
STOP or the step cap, as in the JAX module. Gathers on the card never
multiply a field by a one-hot mask, so the `inf` distances of cells that
are navigable in another queued scene cannot poison the stats.

Across ranks each rank collects its own rollout on its own card, as the
JAX trainer does under several processes (its collector mesh is None
there), and the PPO update joins the ranks. Left out of the JAX module: the
one-process mesh (`mesh`, `_carry_structure` and the pjit branch, which
shard the env axis over the chips of one process; the port has one card per
process), and the [B, F] flattening of the emitted observations, which
exists only for the TPU's tile padding: the observations keep their
natural shapes ([T, B, 12, 224, 224, 3] u8 and so on).
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from vlnce_torch.envs.device_sim import (
    _pad_grid,
    camera_specs_from_config,
    goal_fields,
    nearest_free_cell_map,
    render_arrays,
    upload,
    waypoint_reward,
    waypoint_step,
)
from vlnce_torch.envs.gridworld import _RES, get_scene
from vlnce_torch.envs.scene_import import apply_scene_geometry
from vlnce_torch.ops.graphs import StepGraph, cached_in, launch_counts
from vlnce_torch.ops.obs_transforms import apply_obs_transforms_batch
from vlnce_torch.tasks.datasets import make_dataset
from vlnce_torch.tasks.geometry import heading_from_quaternion
from vlnce_torch.tasks.sensors import MAX_INSTRUCTION_LEN
from vlnce_torch.utils.logging import logger
from vlnce_torch.utils.profiling import annotate

_ACTION_KEYS = ("pano", "offset", "distance")
_STAT_KEYS = ("reward", "count", "success", "distance_to_goal")
_GRAPH_SIZES_MAX = 8  # grid sizes whose queue and graphs a collector keeps (a FIFO, as scan eval keeps its segments)


class EpisodeQueue(NamedTuple):
    """Per-slot queues of upcoming episodes, stacked [B, Q, ...]. Slot b's
    active episode is entry ep_idx[b]; auto-reset advances the index."""

    occupancy: torch.Tensor  # [B, Q, N, N] bool
    wall_colors: torch.Tensor  # [B, Q, N, N, 3] uint8
    origin: torch.Tensor  # [B, Q, 2] f32 world (x, z) of cell [0, 0]'s corner
    floor_color: torch.Tensor  # [B, Q, 3] uint8
    ceil_color: torch.Tensor  # [B, Q, 3] uint8
    goal_field: torch.Tensor  # [B, Q, N, N] f32
    nearest: torch.Tensor  # [B, Q, N, N, 2] int32
    d0: torch.Tensor  # [B, Q] f32
    start_pos: torch.Tensor  # [B, Q, 3] f32
    start_heading: torch.Tensor  # [B, Q] f32
    instruction: torch.Tensor  # [B, Q, L] int32


def _episode_entry(ep) -> Dict:
    """What the host reads of an episode: its scene, its goals' cells as
    the host's Dijkstra snaps them (BaseScene.snap_goal_cell), its start
    cell, pose and instruction tokens."""
    scene = get_scene(ep.scene_id)
    goals = []
    for goal in ep.goals:
        g = np.asarray(goal.position, np.float64)
        goals.append(scene.snap_goal_cell(*scene.world_to_cell(float(g[0]), float(g[-1]))))
    s = np.asarray(ep.start_position, np.float64)
    tokens = ep.instruction.instruction_tokens or []
    instr = np.zeros((MAX_INSTRUCTION_LEN,), np.int32)
    n = min(len(tokens), MAX_INSTRUCTION_LEN)
    instr[:n] = np.asarray(tokens[:n], np.int32)
    return {
        "scene": ep.scene_id,
        "goals": goals,
        "start_cell": scene.world_to_cell(float(s[0]), float(s[-1])),
        "start_pos": s.astype(np.float32),
        "start_heading": np.float32(heading_from_quaternion(np.asarray(ep.start_rotation, np.float64))),
        "instruction": instr,
    }


def build_episode_queue(episodes_by_slot: List[List], device) -> EpisodeQueue:
    """The episodes of every slot, stacked [S, Q, ...] on `device`. The
    host uploads the distinct scenes once with each episode's row of them,
    goal cells and start; the card gathers each episode's grids and builds
    the distinct goals' fields in one launch of `goal_distance_fields`
    (device_sim.goal_fields, in the span `ppo.field_build`: equal to the
    host's Dijkstra fields bit for bit), each episode's field the minimum
    over its goals and d0 max(field at the start cell, 1e-6). Imported
    scenes of mixed sizes pad to the largest grid here as
    `device_sim.build_scene_batch` pads them: blocked and +inf; `nearest`
    pads by repeating its edge, so a padded lookup still names a navigable
    cell of the scene. The padded size is part of the result: the render
    shades walls by the grid's width."""
    S, Q = len(episodes_by_slot), len(episodes_by_slot[0])
    entries = [_episode_entry(ep) for slot in episodes_by_slot for ep in slot]
    rows: Dict[str, int] = {}
    for e in entries:
        rows.setdefault(e["scene"], len(rows))
    scenes = [get_scene(sid) for sid in rows]
    n = max(sc.occupancy.shape[0] for sc in scenes)
    cells: Dict[Tuple[int, int, int], int] = {}
    goal_rows = []
    for e in entries:
        row = rows[e["scene"]]
        goal_rows.append([cells.setdefault((row, *cell), len(cells)) for cell in e["goals"]])
    goal_index = np.full((len(entries), max(len(g) for g in goal_rows)), len(cells), np.int32)
    for i, g in enumerate(goal_rows):
        goal_index[i, : len(g)] = g

    def padded(sc, name, fill):
        return _pad_grid(getattr(sc, name), n, fill)

    t = upload({
        "occupancy": np.stack([padded(sc, "occupancy", True) for sc in scenes]),
        "wall_colors": np.stack([padded(sc, "wall_colors", 0) for sc in scenes]),
        "nearest": np.stack([np.pad(nearest_free_cell_map(sid), [(0, n - sc.occupancy.shape[0])] * 2 + [(0, 0)],
                                    mode="edge") for sid, sc in zip(rows, scenes)]),
        "origin": np.asarray([sc.origin for sc in scenes], np.float32).reshape(-1, 2),
        "floor_color": np.stack([sc.floor_color for sc in scenes]),
        "ceil_color": np.stack([sc.ceil_color for sc in scenes]),
        "field_cells": np.asarray(list(cells), np.int32).reshape(-1, 3),
        "goal_index": goal_index,
        "start_cell": np.asarray([e["start_cell"] for e in entries], np.int32),
        "row": np.asarray([rows[e["scene"]] for e in entries], np.int64),
        **{f: np.stack([e[f] for e in entries]) for f in ("start_pos", "start_heading", "instruction")},
    }, device)
    with annotate("ppo.field_build"):
        goal_field, d0, _ = goal_fields(t["occupancy"], t["field_cells"], t["goal_index"], t["start_cell"],
                                        torch.full((len(entries),), -1.0, device=t["start_cell"].device))
    row = t["row"]
    flat = {f: t[f].index_select(0, row) for f in ("occupancy", "wall_colors", "nearest", "origin", "floor_color",
                                                    "ceil_color")}
    flat.update(goal_field=goal_field, d0=d0, start_pos=t["start_pos"], start_heading=t["start_heading"],
                instruction=t["instruction"])
    return EpisodeQueue(**{f: flat[f].reshape((S, Q) + tuple(flat[f].shape[1:])) for f in EpisodeQueue._fields})


def _select_axis1(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr [B, Q, ...]; idx [B] integer -> [B, ...] = arr[b, idx[b]], one
    gather of rows of the flattened [B * Q, ...] array (exact for every
    dtype; the JAX module's one-hot sum exists only because a dynamic gather
    lowers to the TPU's scalar unit)."""
    B, Q = arr.shape[:2]
    rows = torch.arange(B, device=arr.device) * Q + idx.long()
    return arr.reshape((B * Q,) + tuple(arr.shape[2:])).index_select(0, rows)


def _gather_slot(queue: EpisodeQueue, ep_idx: torch.Tensor) -> EpisodeQueue:
    """Each slot's active episode: [B, Q, ...] -> [B, ...]."""
    return EpisodeQueue(*(_select_axis1(arr, ep_idx) for arr in queue))


def compute_returns_device(rewards, values, masks_next, next_value, gamma: float, tau: float, use_gae: bool):
    """GAE or discounted returns as a reverse loop over T on the device: the
    counterpart of ActionDictRolloutStorage.compute_returns, in the JAX
    scan's order of operations. rewards, values, masks_next [T, B, 1];
    next_value [B, 1] -> returns [T, B, 1]."""
    T = rewards.shape[0]
    out = []
    if use_gae:
        gae = torch.zeros_like(next_value)
        for t in reversed(range(T)):
            v_next = values[t + 1] if t + 1 < T else next_value
            delta = rewards[t] + gamma * v_next * masks_next[t] - values[t]
            gae = delta + gamma * tau * masks_next[t] * gae
            out.append(gae + values[t])
    else:
        ret = next_value
        for t in reversed(range(T)):
            ret = rewards[t] + gamma * ret * masks_next[t]
            out.append(ret)
    return torch.stack(out[::-1])


class DeviceRolloutCollector:
    """The rollout loop on the card for one env batch of B slots: the
    captured step, its state and output buffers, and the per-slot episode
    schedule. `collect_device` runs one rollout of T steps."""

    def __init__(self, policy, obs_transforms, config, num_envs: int, eager: bool = False, episodes=None):
        task_cfg = config.TASK_CONFIG
        sim_type = task_cfg.SIMULATOR.TYPE
        if sim_type != "GridWorldSim-v0":
            raise ValueError(
                f"CUDA.ON_DEVICE_ROLLOUT requires SIMULATOR.TYPE=GridWorldSim-v0 (got {sim_type!r}); "
                f"host-bound simulators cannot step inside the loop on the card"
            )
        if config.ENV_NAME != "VLNCEWaypointEnv":
            raise ValueError(
                f"CUDA.ON_DEVICE_ROLLOUT implements VLNCEWaypointEnv reward/done semantics "
                f"(got ENV_NAME={config.ENV_NAME!r})"
            )
        apply_scene_geometry(task_cfg.SIMULATOR)  # real-scene grids, if configured

        self.policy = policy
        self.transforms = obs_transforms
        self.device = policy.device
        self.eager = eager
        self.B = num_envs
        self.T = int(config.RL.PPO.num_steps)
        self.Q = self.T + 1  # worst case: one done per rollout step
        self.max_ep_steps = int(task_cfg.ENVIRONMENT.MAX_EPISODE_STEPS)
        self.specs = camera_specs_from_config(task_cfg.SIMULATOR)
        self._rotate_agent = bool(task_cfg.TASK.ACTIONS.GO_TOWARD_POINT.rotate_agent)
        self._allow_sliding = bool(task_cfg.SIMULATOR.HABITAT_SIM_V0.ALLOW_SLIDING)
        max_move = float(config.MODEL.WAYPOINT.max_distance_prediction)
        self._max_samples = max(2, int(math.ceil(max_move / (0.25 * _RES))) + 1)
        rm = task_cfg.TASK.WAYPOINT_REWARD_MEASURE
        self._reward_kwargs = dict(
            slack_reward=float(rm.slack_reward),
            use_distance_scaled_slack_reward=bool(rm.use_distance_scaled_slack_reward),
            scale_slack_on_prediction=bool(rm.scale_slack_on_prediction),
            success_reward=float(rm.success_reward),
            distance_scalar=float(rm.distance_scalar),
            success_distance=float(task_cfg.TASK.SUCCESS.SUCCESS_DISTANCE),
        )
        ppo = config.RL.PPO
        self._gae_bits = (bool(ppo.use_gae), float(ppo.gamma), float(ppo.tau), bool(ppo.use_normalized_advantage))
        num_panos = int(task_cfg.TASK.PANO_ROTATIONS)
        orient = [2 * np.pi / num_panos * i for i in range(num_panos)]
        self._angle_features = torch.from_numpy(
            np.stack([np.array([np.sin(o), np.cos(o), 0.0, 1.0]) for o in orient]).astype(np.float32)
        ).to(self.device)

        # episode schedule: round-robin over the train split (the configured
        # dataset's, or `episodes`), one stream per slot (the analog of
        # construct_envs' scene split + auto-reset)
        eps = list(make_dataset(task_cfg.DATASET.TYPE, task_cfg.DATASET).episodes if episodes is None else episodes)
        if not eps:
            raise ValueError("no episodes in the train split")
        self._slot_streams = [eps[i :: self.B] or eps for i in range(self.B)]
        self._slot_ptr = [0] * self.B

        # the episode bank on the card: a rollout's queue is then one [B, Q]
        # index upload and a gather on the card, in place of restacking and
        # uploading about Q x B episodes' grids every rollout
        bank_cap = int(config.CUDA.EPISODE_BANK_MAX)
        self._bank_episodes = eps if len(eps) <= bank_cap else None
        if self._bank_episodes is None:
            logger.info(f"on-device rollout: the split has {len(eps)} episodes > CUDA.EPISODE_BANK_MAX={bank_cap}; "
                        "each rollout uploads its episode queue")
        self._bank: Optional[EpisodeQueue] = None  # built by initial_carry_and_obs
        self._bank_pos = {id(ep): i for i, ep in enumerate(eps)} if self._bank_episodes else None

        self._state: Optional[Dict[str, torch.Tensor]] = None  # the carry, set by initial_carry_and_obs
        self._fresh = False
        # a queue pads to its own largest grid, as the JAX module's does (it
        # recompiles per size): the graphs' input queue [B, Q, ...] and both
        # graphs for each grid size, a FIFO of _GRAPH_SIZES_MAX sizes
        self._graphs: Dict[int, Tuple[EpisodeQueue, object, object]] = {}
        self._queue: Optional[EpisodeQueue] = None  # the current size's input queue
        self._step = self._bootstrap = None  # the current size's graphs
        self._buffers: Optional[Dict] = None  # the outputs, shaped at the first collect
        # what the collections did, for the caller's accounting
        self.rollouts = self.readbacks = self.replays = self.builds = 0
        self.capture_seconds = 0.0
        self.capture_launches: Dict[str, Dict[str, int]] = {}
        self.build_launches: Dict[str, int] = {}

    # -- episode scheduling ----------------------------------------------------
    def _slot_episode(self, slot: int, offset: int):
        stream = self._slot_streams[slot]
        return stream[(self._slot_ptr[slot] + offset) % len(stream)]

    def _rollout_inputs(self) -> Tuple[EpisodeQueue, np.ndarray]:
        """(bank [E, ...], slot_map [B, Q]) such that bank[slot_map] is the
        slots' episode queue. With the bank on the card only the index map
        crosses to the card per rollout; above the cap the slots' queue is
        built (`build_episode_queue`: bank = the flattened queue, identity
        map)."""
        if self._bank_episodes is not None:
            slot_map = np.asarray(
                [[self._bank_pos[id(self._slot_episode(b, q))] for q in range(self.Q)] for b in range(self.B)], np.int64
            )
            return self._bank, slot_map
        queue = build_episode_queue([[self._slot_episode(b, q) for q in range(self.Q)] for b in range(self.B)], self.device)
        flat = EpisodeQueue(*(a.reshape((-1,) + tuple(a.shape[2:])) for a in queue))
        return flat, np.arange(self.B * self.Q, dtype=np.int64).reshape(self.B, self.Q)

    # -- one step ----------------------------------------------------------------
    def _assemble_obs(self, scene: EpisodeQueue, pos, heading, hist_rgb, hist_depth) -> Dict[str, torch.Tensor]:
        obs = render_arrays(scene.occupancy, scene.wall_colors, scene.floor_color, scene.ceil_color, pos, heading,
                            self.specs, origin=scene.origin)
        obs["instruction"] = scene.instruction
        obs["angle_features"] = self._angle_features[None].expand((pos.shape[0],) + tuple(self._angle_features.shape))
        obs["globalgps"] = pos[:, 0::2].to(torch.float32)
        obs["heading"] = (torch.remainder(heading + math.pi, 2.0 * math.pi) - math.pi)[:, None].to(torch.float32)
        batch = apply_obs_transforms_batch(obs, self.transforms)
        batch["rgb_history"] = hist_rgb
        batch["depth_history"] = hist_depth
        return batch

    def _compute(self) -> Dict:
        """One env step from the carry; returns what `_commit` writes."""
        s, B = self._state, self.B
        queue = self._queue
        scene = _gather_slot(queue, s["ep_idx"])
        pos, heading = s["pos"], s["heading"]
        batch = self._assemble_obs(scene, pos, heading, s["hist_rgb"], s["hist_depth"])
        uniforms = self._uniforms.index_select(0, s["g"])[0]  # [3, B]
        prev_a = {k: s[f"prev_{k}"] for k in _ACTION_KEYS}
        out = self.policy.act(batch, s["rnn"], prev_a, s["mask"], deterministic=False, uniforms=uniforms)
        stop = out["stop"].reshape(B).bool()
        r = out["r"].reshape(B).to(torch.float32)
        theta = out["theta"].reshape(B).to(torch.float32)

        moved, moved_heading = waypoint_step(scene.occupancy, scene.nearest, pos, heading, r, theta, self._rotate_agent,
                                             self._max_samples, self._allow_sliding, scene.origin)
        new_pos = torch.where(stop[:, None], pos, moved)
        new_heading = torch.where(stop, heading, moved_heading)
        reward, d_new, success = waypoint_reward(scene.goal_field, s["prev_d"], pos[:, 0::2], new_pos, r, stop,
                                                 origin=scene.origin, **self._reward_kwargs)

        done = stop | (s["step_in_ep"] + 1 >= self.max_ep_steps)
        ep_reward = s["ep_reward"] + reward[:, None]
        done_f = done.to(torch.float32)[:, None]
        stats = torch.stack([done_f * ep_reward, done_f, done_f * success[:, None], done_f * d_new[:, None]])

        # auto-reset from the queue (the workers' auto-reset)
        ep_idx = torch.where(done, torch.clamp(s["ep_idx"] + 1, max=self.Q - 1), s["ep_idx"])
        nxt = _gather_slot(queue, ep_idx)
        # the history frame: the pano frame the agent moved toward; zeros on
        # STOP (reference ddppo_waypoint_trainer.py:190-200) and after a reset
        pano = out["action_elements"]["pano"].reshape(B).long()
        num_p = batch["rgb"].shape[1]
        blank = (stop | done)[:, None, None, None]
        hist_rgb = torch.where(blank, torch.zeros_like(s["hist_rgb"]), _select_axis1(batch["rgb"], pano % num_p))
        hist_depth = torch.where(blank, torch.zeros_like(s["hist_depth"]), _select_axis1(batch["depth"], pano % num_p))
        return {
            "obs": batch, "features": self.policy.net.backbone_features(), "out": out, "reward": reward[:, None],
            "mask_next": (~done).to(torch.float32)[:, None], "stats": stats,
            "carry": {
                "pos": torch.where(done[:, None], nxt.start_pos, new_pos),
                "heading": torch.where(done, nxt.start_heading, new_heading),
                "rnn": out["rnn_states"],
                **{f"prev_{k}": out["action_elements"][k].to(torch.float32) for k in _ACTION_KEYS},
                "mask": (~done).to(torch.float32)[:, None],
                "prev_d": torch.where(done, nxt.d0, d_new),
                "ep_idx": ep_idx,
                "step_in_ep": torch.where(done, torch.zeros_like(s["step_in_ep"]), s["step_in_ep"] + 1),
                "ep_reward": torch.where(done[:, None], torch.zeros_like(ep_reward), ep_reward),
                "hist_rgb": hist_rgb,
                "hist_depth": hist_depth,
            },
        }

    def _commit(self, res: Dict) -> None:
        """Row g of the outputs (the step's INPUT observations, their
        frozen-backbone features, previous actions and mask among them),
        then the carry, in place."""
        s, buf, row = self._state, self._buffers, self._state["g"]
        for group in ("obs", "features"):
            for k, v in res[group].items():
                buf[group][k].index_copy_(0, row, v[None])
        out = res["out"]
        for k in _ACTION_KEYS:
            buf["actions"][k].index_copy_(0, row, out["action_elements"][k].to(torch.float32)[None])
            buf["prev_actions"][k].index_copy_(0, row, s[f"prev_{k}"][None])
        buf["masks"].index_copy_(0, row, s["mask"][None])
        buf["old_log_probs"].index_copy_(0, row, out["action_log_probs"].to(torch.float32)[None])
        buf["value_preds"].index_copy_(0, row, out["value"].to(torch.float32)[None])
        buf["rewards"].index_copy_(0, row, res["reward"][None])
        buf["masks_next"].index_copy_(0, row, res["mask_next"][None])
        self._stat_sums.add_(res["stats"])
        for k, v in res["carry"].items():
            s[k].copy_(v)
        s["g"].add_(1)

    def _compute_bootstrap(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The value of the carry's state (one more policy forward), the
        returns and the advantages, normalized without Bessel's correction
        as jnp.std and np.std do."""
        s, buf = self._state, self._buffers
        use_gae, gamma, tau, normalize = self._gae_bits
        scene = _gather_slot(self._queue, s["ep_idx"])
        obs = self._assemble_obs(scene, s["pos"], s["heading"], s["hist_rgb"], s["hist_depth"])
        next_value = self.policy.get_value(obs, s["rnn"], {k: s[f"prev_{k}"] for k in _ACTION_KEYS}, s["mask"])
        values = buf["value_preds"]
        returns = compute_returns_device(buf["rewards"], values, buf["masks_next"], next_value.to(torch.float32),
                                         gamma, tau, use_gae)
        adv = returns - values
        if normalize:
            adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-5)
        return returns, adv

    def _commit_bootstrap(self, res) -> None:
        self._buffers["returns"].copy_(res[0])
        self._buffers["advantages"].copy_(res[1])

    # -- buffers and graphs --------------------------------------------------------
    def _build(self) -> None:
        """Both graphs on the loaded queue; at the first build also the output
        buffers, shaped by one probe step."""
        before = launch_counts()
        if self._buffers is None:
            self._build_buffers()
        self._step = StepGraph(self._compute, self._commit, self.device, eager=self.eager)
        self._bootstrap = StepGraph(self._compute_bootstrap, self._commit_bootstrap, self.device, eager=self.eager)
        self.builds += 1
        self.capture_seconds += self._step.capture_seconds + self._bootstrap.capture_seconds
        self.capture_launches = {"step": dict(self._step.capture_launches),
                                 "bootstrap": dict(self._bootstrap.capture_launches)}
        self.build_launches = {k: self.build_launches.get(k, 0) + v - before[k] for k, v in launch_counts().items()}

    def _build_buffers(self) -> None:
        T, B, dev = self.T, self.B, self.device
        with torch.no_grad():
            probe = self._compute()

        def rows(v: torch.Tensor) -> torch.Tensor:
            return torch.zeros((T,) + tuple(v.shape), dtype=v.dtype, device=dev)

        def col() -> torch.Tensor:
            return torch.zeros(T, B, 1, device=dev)

        self._buffers = {
            "obs": {k: rows(v) for k, v in probe["obs"].items()},
            "features": {k: rows(v) for k, v in probe["features"].items()},
            "actions": {k: col() for k in _ACTION_KEYS},
            "prev_actions": {k: col() for k in _ACTION_KEYS},
            **{k: col() for k in ("masks", "old_log_probs", "value_preds", "rewards", "masks_next", "returns",
                                  "advantages")},
            "hidden0": torch.zeros_like(self._state["rnn"]),
        }
        del probe

    def _load_queue(self, bank: EpisodeQueue, slot_map: np.ndarray) -> None:
        """The slots' queue into the graph's input tensors: the slot map's
        upload and one gather from the bank per field, all on the card."""
        idx = upload({"slot_map": slot_map}, self.device)["slot_map"].reshape(-1)
        for dst, src in zip(self._queue, bank):
            dst.copy_(src.index_select(0, idx).reshape(dst.shape))

    # -- public API --------------------------------------------------------------
    def initial_carry_and_obs(self) -> Dict[str, np.ndarray]:
        """Build the episode bank (at most CUDA.EPISODE_BANK_MAX episodes;
        span `ppo.bank`) and set up the slots' state; their poses and start
        distances are their first episodes', taken from the first rollout's
        queue when it is loaded. Returns an empty dict: nothing is rendered
        here, the first rollout emits the step-0 observations itself."""
        if self._bank_episodes is not None and self._bank is None:
            with annotate("ppo.bank"):
                self._bank = EpisodeQueue(*(a[0] for a in build_episode_queue([self._bank_episodes], self.device)))
        rgb_spec = next(s for s in self.specs if s.kind == "rgb")
        depth_spec = next(s for s in self.specs if s.kind == "depth")
        B, dev = self.B, self.device
        self._fresh = True  # the slots' poses and start distances are still to be set
        self._state = {
            "pos": torch.zeros(B, 3, device=dev),
            "heading": torch.zeros(B, device=dev),
            "rnn": self.policy.initial_rnn_states(B),
            **{f"prev_{k}": torch.zeros(B, 1, device=dev) for k in _ACTION_KEYS},
            "mask": torch.zeros(B, 1, device=dev),  # 0: the recurrence starts afresh
            "prev_d": torch.zeros(B, device=dev),
            "ep_idx": torch.zeros(B, dtype=torch.int64, device=dev),
            "step_in_ep": torch.zeros(B, dtype=torch.int64, device=dev),
            "ep_reward": torch.zeros(B, 1, device=dev),
            "hist_rgb": torch.zeros(B, rgb_spec.height, rgb_spec.width, 3, dtype=torch.uint8, device=dev),
            "hist_depth": torch.zeros(B, depth_spec.height, depth_spec.width, 1, device=dev),
            "g": torch.zeros(1, dtype=torch.int64, device=dev),
        }
        return {}

    def load_rollout(self) -> None:
        """Everything a rollout needs before its steps, on the card (span
        `ppo.load`): the queue gathered from the bank by the slot map (the
        graphs built at a grid size first met), the step counter, the stats
        and the rollout's first recurrent state."""
        if self._state is None:
            raise RuntimeError("call initial_carry_and_obs() before collect_device()")
        with annotate("ppo.load"):
            self._load_rollout()

    def _load_rollout(self) -> None:
        bank, slot_map = self._rollout_inputs()
        B, Q, dev = self.B, self.Q, self.device
        if self._buffers is None:
            self._uniforms = torch.zeros(self.T, 3, B, device=dev)
            self._stat_sums = torch.zeros(len(_STAT_KEYS), B, 1, device=dev)
        n = int(bank.occupancy.shape[-1])
        built = self._graphs.get(n)
        if built is None:
            self._queue = EpisodeQueue(*(torch.empty((B, Q) + tuple(a.shape[1:]), dtype=a.dtype, device=dev) for a in bank))
        else:
            self._queue, self._step, self._bootstrap = built
        self._load_queue(bank, slot_map)
        if self._fresh:  # each slot at its queue's entry 0, its first episode
            for k, v in (("pos", self._queue.start_pos), ("heading", self._queue.start_heading), ("prev_d", self._queue.d0)):
                self._state[k].copy_(v[:, 0])
            self._fresh = False
        self._state["g"].zero_()
        if built is None:
            self._build()  # the warm-ups compute on the loaded queue
            cached_in(self._graphs, n, lambda: (self._queue, self._step, self._bootstrap), _GRAPH_SIZES_MAX)
        self._stat_sums.zero_()
        self._buffers["hidden0"].copy_(self._state["rnn"])

    def run_rollout(self, generator: Optional[torch.Generator] = None) -> None:
        """The rollout's uniforms (one launch), its T steps and the bootstrap
        (span `ppo.replays`): nothing here reads a value back."""
        with annotate("ppo.replays"):
            self._uniforms.uniform_(0.0, 1.0, generator=generator)
            self._step.run(self.T)
            self._bootstrap.run(1)
        self.replays += self.T

    def collect_device(self, current_episode_reward, running_episode_stats, generator=None):
        """One rollout of T steps on the card. Returns (the PPO batch, T x B):
        the batch's tensors stay on the card (for
        WDDPPO.update_device_scan) and are the collector's buffers, valid
        until the next rollout. Only the slots' episode stats, indices and
        rewards are read back, in one copy. Spans: `ppo.rollout` around `ppo.load`, `ppo.replays` and
        `ppo.readback`."""
        with annotate("ppo.rollout"):
            self.load_rollout()
            self.run_rollout(generator)
            with annotate("ppo.readback"):
                return self._read_back(current_episode_reward, running_episode_stats)

    def _read_back(self, current_episode_reward, running_episode_stats):
        B, s = self.B, self._state
        packed = torch.cat([self._stat_sums.reshape(-1), s["ep_idx"].to(torch.float32), s["ep_reward"].reshape(-1)])
        host = packed.cpu().numpy().copy()  # the one read-back (on the CPU, .cpu() is the tensor itself)
        self.rollouts += 1
        self.readbacks += 1
        stats = host[: len(_STAT_KEYS) * B].reshape(len(_STAT_KEYS), B, 1)
        ep_idx = host[len(_STAT_KEYS) * B : (len(_STAT_KEYS) + 1) * B].astype(np.int64)
        ep_reward = host[(len(_STAT_KEYS) + 1) * B :].reshape(B, 1)

        # each slot's stream advances by the episodes it finished; the one in
        # flight becomes queue entry 0 of the next rollout
        for b in range(B):
            self._slot_ptr[b] = (self._slot_ptr[b] + int(ep_idx[b])) % len(self._slot_streams[b])
        s["ep_idx"].zero_()

        current_episode_reward[:] = ep_reward
        for k, v in zip(_STAT_KEYS, stats):
            if k not in running_episode_stats:
                running_episode_stats[k] = np.zeros((B, 1), np.float32)
            running_episode_stats[k] += v
        buf = self._buffers
        batch = {k: buf[k] for k in ("obs", "features", "hidden0", "actions", "prev_actions", "value_preds", "returns",
                                     "masks", "old_log_probs", "advantages", "rewards", "masks_next")}
        return batch, self.T * B
