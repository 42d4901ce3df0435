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

Observations travel through the pipes as pickles; the shared-memory ring of
the JAX package (shm_transport + native/obs_ring.cpp) is not ported yet.

Workers are forked, possibly after the parent has initialised CUDA: a worker
runs the simulator and the task layer on numpy only and must never touch a
tensor on the card. A worker that dies closes its pipe, and the parent's next
receive from it raises EOFError; nothing retries.
"""

from __future__ import annotations

import multiprocessing as mp
from typing import Any, Callable, Dict, List, Sequence, Tuple

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


def _worker(conn, env_fn: Callable, env_fn_args: Tuple, auto_reset_done: bool) -> None:
    try:
        env = env_fn(*env_fn_args)
        while True:
            cmd, data = conn.recv()
            if cmd == STEP:
                obs, reward, done, info = env.step(data)
                if done and auto_reset_done:
                    obs = env.reset()
                conn.send((obs, reward, done, info))
            elif cmd in (RESET, RESET_AT):
                conn.send(env.reset())
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
    ):
        self._auto_reset_done = auto_reset_done
        self._mp_ctx = mp.get_context(multiprocessing_start_method)
        self._workers: List[Any] = []
        self._conns: List[Any] = []
        self._paused: List[Tuple[int, Any, Any]] = []  # (original_index, conn, proc)
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
        return self._all(RESET)

    def step(self, actions: Sequence[Any]) -> List[Tuple]:
        return self._all(STEP, list(actions))

    def reset_at(self, index: int) -> List[Dict]:
        self._conns[index].send((RESET_AT, None))
        return [self._conns[index].recv()]

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
        return [self._conns[i].recv() for i in indices]

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
        self._paused.append((index, conn, proc))

    def resume_all(self) -> None:
        for index, conn, proc in reversed(self._paused):
            self._conns.insert(index, conn)
            self._workers.insert(index, proc)
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
