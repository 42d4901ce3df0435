"""Vectorized environment pool (VectorEnv semantics).

Re-provides the habitat VectorEnv surface the trainers use — step / reset /
reset_at / pause_at / resume_all / call_at / current_episodes /
number_of_episodes / episode_over / get_metrics (reference
common/env_utils.py:91-96, base_il_trainer.py:331,354,572) — over forked
worker processes with pipe messaging, mirroring the reference's process
isolation model. A `workers_ignore_signals` analog is
unnecessary: workers trap KeyboardInterrupt themselves.

Two implementations:
- VectorEnv: one process per env (throughput workhorse).
- ThreadedVectorEnv: same API, envs in-process (tests/debug; also what the
  recollection dataset uses under pytest).

Large observations travel through a shared-memory ring
(`envs/shm_transport.py` over `native/obs_ring.cpp`): after the first
`reset`, each worker writes the sensors of at least 4 KiB into its own slot
and sends the rest (small sensors, reward, done, info) through its pipe,
as the JAX package does by default. The ring is on unless
`VLNCE_TORCH_SHM_OBS=0`; the constructor's `use_shm`, where given, decides
instead. Where it is wanted and the
library cannot be built or the segment opened, the pool raises instead of
falling back to pickles as the JAX pool does. A ring slot belongs to a
worker, not to a position in the active list, so `pause_at` and
`resume_all` carry it with the worker's pipe.

Workers are forked, possibly after the parent has initialised CUDA: a worker
runs the simulator and the task layer on numpy only and must never touch a
tensor on the card. A worker that dies closes its pipe, and the parent's next
receive from it raises EOFError; nothing retries.
"""

from __future__ import annotations

import itertools
import multiprocessing as mp
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

STEP = "step"
RESET = "reset"
RESET_AT = "reset_at"
CALL = "call"
CLOSE = "close"
EPISODE = "episode"
NUM_EPISODES = "num_episodes"
SPACES = "spaces"
GET_METRICS = "get_metrics"
EPISODE_OVER = "episode_over"
ATTACH_SHM = "attach_shm"
SHM_TAG = "__shm__"
_RING_IDS = itertools.count()  # one segment name per pool of this process


def _worker(conn, env_fn: Callable, env_fn_args: Tuple, auto_reset_done: bool) -> None:
    ring = None
    slot = 0
    seq = 0

    def send_obs(obs):
        """The observation as the pipe carries it: whole, or with the ring's
        sensors written to this worker's slot and a tag in their place."""
        nonlocal seq
        if ring is None:
            return obs
        seq += 1
        return (SHM_TAG, seq, ring.write_obs(slot, obs, seq))

    try:
        env = env_fn(*env_fn_args)
        while True:
            cmd, data = conn.recv()
            if cmd == STEP:
                obs, reward, done, info = env.step(data)
                if done and auto_reset_done:
                    obs = env.reset()
                conn.send((send_obs(obs), reward, done, info))
            elif cmd in (RESET, RESET_AT):
                conn.send(send_obs(env.reset()))
            elif cmd == ATTACH_SHM:
                from vlnce_torch.envs.shm_transport import ObsRing, ObsSchema

                name, n_slots, slot, schema = data
                ring = ObsRing(name, n_slots, ObsSchema.from_dict(schema), create=False)
                seq = 0
                conn.send(True)
            elif cmd == EPISODE:
                conn.send(env.current_episode)
            elif cmd == NUM_EPISODES:
                conn.send(env.number_of_episodes)
            elif cmd == EPISODE_OVER:
                conn.send(env.episode_over)
            elif cmd == GET_METRICS:
                conn.send(env.get_metrics())
            elif cmd == SPACES:
                conn.send((env.observation_space, env.action_space))
            elif cmd == CALL:
                name, args, kwargs = data
                target = getattr(env, name)
                conn.send(target(*args, **(kwargs or {})) if callable(target) else target)
            elif cmd == CLOSE:
                env.close()
                conn.send(True)
                break
    except KeyboardInterrupt:
        pass
    finally:
        conn.close()


class VectorEnv:
    def __init__(
        self,
        make_env_fn: Callable,
        env_fn_args: Sequence[Tuple],
        auto_reset_done: bool = True,
        multiprocessing_start_method: str = "fork",
        use_shm: Optional[bool] = None,
    ):
        self._auto_reset_done = auto_reset_done
        self._mp_ctx = mp.get_context(multiprocessing_start_method)
        self._workers: List[Any] = []
        self._conns: List[Any] = []
        self._paused: List[Tuple[int, Any, Any, int]] = []  # (original_index, conn, proc, slot)
        self._slot_of_conn: List[int] = list(range(len(env_fn_args)))
        for args in env_fn_args:
            parent, child = self._mp_ctx.Pipe()
            proc = self._mp_ctx.Process(
                target=_worker, args=(child, make_env_fn, args, auto_reset_done), daemon=True
            )
            proc.start()
            child.close()
            self._workers.append(proc)
            self._conns.append(parent)
        self._is_closed = False
        if use_shm is None:
            use_shm = os.environ.get("VLNCE_TORCH_SHM_OBS", "1") == "1"
        self._want_shm = use_shm
        self._ring = None

    # -- shm transport -------------------------------------------------------
    def _maybe_enable_shm(self, template_obs) -> None:
        """Open the ring from the first reset's observations and attach every
        active worker to its slot. Raises when the ring is wanted and cannot
        be built or opened; pipes stay when no sensor reaches the schema's
        `min_bytes`."""
        if not self._want_shm or self._ring is not None:
            return
        from vlnce_torch.envs import shm_transport

        schema = shm_transport.ObsSchema(template_obs)
        if not schema.fields:
            self._want_shm = False
            return
        name = f"{shm_transport.NAME_PREFIX}{os.getpid()}_{next(_RING_IDS)}"
        n = len(self._conns) + len(self._paused)
        self._ring = shm_transport.ObsRing(name, n, schema, create=True)
        for conn, slot in zip(self._conns, self._slot_of_conn):
            conn.send((ATTACH_SHM, (name, n, slot, schema.to_dict())))
        for conn in self._conns:
            conn.recv()

    def _resolve_obs(self, conn_index: int, payload):
        """A worker's observation payload -> the observation dict (the ring's
        sensors gathered from the worker's slot when the payload is tagged)."""
        if not (isinstance(payload, tuple) and len(payload) == 3 and payload[0] == SHM_TAG):
            return payload
        _, seq, rest = payload
        slot = self._slot_of_conn[conn_index]
        self._ring.wait([slot], seq)
        obs = dict(rest)
        for k, v in self._ring.gather([slot]).items():
            obs[k] = v[0]
        return obs

    @property
    def uses_shm(self) -> bool:
        """Whether observations ride the shared-memory ring."""
        return self._ring is not None

    # -- bookkeeping ---------------------------------------------------------
    @property
    def num_envs(self) -> int:
        return len(self._conns)

    def _all(self, cmd, datas=None):
        datas = datas if datas is not None else [None] * self.num_envs
        for conn, d in zip(self._conns, datas):
            conn.send((cmd, d))
        return [conn.recv() for conn in self._conns]

    # -- core API ------------------------------------------------------------
    def reset(self) -> List[Dict]:
        results = [self._resolve_obs(i, r) for i, r in enumerate(self._all(RESET))]
        if self._ring is None and results:
            self._maybe_enable_shm(results[0])
        return results

    def step(self, actions: Sequence[Any]) -> List[Tuple]:
        out = self._all(STEP, list(actions))
        return [(self._resolve_obs(i, obs), reward, done, info) for i, (obs, reward, done, info) in enumerate(out)]

    def reset_at(self, index: int) -> List[Dict]:
        self._conns[index].send((RESET_AT, None))
        return [self._resolve_obs(index, self._conns[index].recv())]

    def step_at(self, indices: Sequence[int], actions: Sequence[Any]) -> List[Tuple]:
        """Pipelined step of a subset of envs: all sends first, then all
        receives (keeps sim workers busy concurrently)."""
        self.step_at_async(indices, actions)
        return self.recv_at(indices)

    def step_at_async(self, indices: Sequence[int], actions: Sequence[Any]) -> None:
        """Dispatch step commands without waiting — the sims run while the
        caller does other work (e.g. device compute for another env group);
        pair with recv_at(indices). This is the double-buffered collection
        seam (overlap sim stepping with device compute)."""
        for i, a in zip(indices, actions):
            self._conns[i].send((STEP, a))

    def recv_at(self, indices: Sequence[int]) -> List[Tuple]:
        out = []
        for i in indices:
            obs, reward, done, info = self._conns[i].recv()
            out.append((self._resolve_obs(i, obs), reward, done, info))
        return out

    def current_episodes(self) -> List[Any]:
        return self._all(EPISODE)

    @property
    def number_of_episodes(self) -> List[int]:
        return self._all(NUM_EPISODES)

    def episodes_over(self) -> List[bool]:
        return self._all(EPISODE_OVER)

    def get_metrics(self) -> List[Dict]:
        return self._all(GET_METRICS)

    def call_at(self, index: int, function_name: str, function_args=None, function_kwargs=None):
        self._conns[index].send((CALL, (function_name, function_args or [], function_kwargs)))
        return self._conns[index].recv()

    def call(self, function_names: List[str], function_args_list=None):
        function_args_list = function_args_list or [[]] * len(function_names)
        for conn, name, args in zip(self._conns, function_names, function_args_list):
            conn.send((CALL, (name, args, None)))
        return [conn.recv() for conn in self._conns]

    @property
    def observation_spaces(self):
        return [s[0] for s in self._all(SPACES)]

    @property
    def action_spaces(self):
        return [s[1] for s in self._all(SPACES)]

    def pause_at(self, index: int) -> None:
        """Remove env `index` from the active set (its process stays alive)."""
        conn = self._conns.pop(index)
        proc = self._workers.pop(index)
        slot = self._slot_of_conn.pop(index)
        self._paused.append((index, conn, proc, slot))

    def resume_all(self) -> None:
        for index, conn, proc, slot in reversed(self._paused):
            self._conns.insert(index, conn)
            self._workers.insert(index, proc)
            self._slot_of_conn.insert(index, slot)
        self._paused = []

    def close(self) -> None:
        if self._is_closed:
            return
        for conn in self._conns + [p[1] for p in self._paused]:
            try:
                conn.send((CLOSE, None))
            except (BrokenPipeError, OSError):
                pass
        for conn in self._conns + [p[1] for p in self._paused]:
            try:
                conn.recv()
            except (EOFError, OSError):
                pass
        if self._ring is not None:
            self._ring.close()  # unlinks the segment
            self._ring = None
        for proc in self._workers + [p[2] for p in self._paused]:
            proc.join(timeout=5)
            if proc.is_alive():
                proc.terminate()
        self._is_closed = True

    def __del__(self):
        self.close()


class ThreadedVectorEnv:
    """Same API, in-process; deterministic and debuggable."""

    def __init__(self, make_env_fn: Callable, env_fn_args: Sequence[Tuple], auto_reset_done: bool = True, **_):
        self._envs = [make_env_fn(*args) for args in env_fn_args]
        self._auto_reset_done = auto_reset_done
        self._paused: List[Tuple[int, Any]] = []
        self._is_closed = False

    @property
    def num_envs(self) -> int:
        return len(self._envs)

    def reset(self):
        return [env.reset() for env in self._envs]

    def step(self, actions):
        out = []
        for env, action in zip(self._envs, actions):
            obs, reward, done, info = env.step(action)
            if done and self._auto_reset_done:
                obs = env.reset()
            out.append((obs, reward, done, info))
        return out

    def reset_at(self, index: int):
        return [self._envs[index].reset()]

    def step_at(self, indices, actions):
        out = []
        for i, a in zip(indices, actions):
            obs, reward, done, info = self._envs[i].step(a)
            if done and self._auto_reset_done:
                obs = self._envs[i].reset()
            out.append((obs, reward, done, info))
        return out

    def step_at_async(self, indices, actions) -> None:
        # threaded envs run synchronously; buffer the results for recv_at.
        # multiple groups can be in flight (two-group pipelined collection)
        if not hasattr(self, "_pending") or self._pending is None:
            self._pending = {}
        self._pending[tuple(indices)] = self.step_at(indices, actions)

    def recv_at(self, indices):
        return self._pending.pop(tuple(indices))

    def current_episodes(self):
        return [env.current_episode for env in self._envs]

    @property
    def number_of_episodes(self):
        return [env.number_of_episodes for env in self._envs]

    def episodes_over(self):
        return [env.episode_over for env in self._envs]

    def get_metrics(self):
        return [env.get_metrics() for env in self._envs]

    def call_at(self, index: int, function_name: str, function_args=None, function_kwargs=None):
        target = getattr(self._envs[index], function_name)
        return target(*(function_args or []), **(function_kwargs or {})) if callable(target) else target

    def call(self, function_names, function_args_list=None):
        function_args_list = function_args_list or [[]] * len(function_names)
        return [
            self.call_at(i, name, args) for i, (name, args) in enumerate(zip(function_names, function_args_list))
        ]

    @property
    def observation_spaces(self):
        return [env.observation_space for env in self._envs]

    @property
    def action_spaces(self):
        return [env.action_space for env in self._envs]

    def pause_at(self, index: int) -> None:
        self._paused.append((index, self._envs.pop(index)))

    def resume_all(self) -> None:
        for index, env in reversed(self._paused):
            self._envs.insert(index, env)
        self._paused = []

    def close(self) -> None:
        if not self._is_closed:
            for env in self._envs + [e for _, e in self._paused]:
                env.close()
            self._is_closed = True
