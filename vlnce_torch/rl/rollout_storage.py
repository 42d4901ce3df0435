"""Rollout storage for dict-action PPO (port of
vlnce_tpu/rl/rollout_storage.py; reference
vlnce_baselines/common/rollout_storage.py:11-276).

[T+1, N, ...] buffers for obs/hidden/masks/prev_actions and [T, N, ...] for
actions/rewards/log-probs/values, GAE returns, and a recurrent minibatch
generator that permutes the envs with the caller's `np.random.RandomState`
(in the JAX package's order, so both packages draw the same env columns)
and yields time-major [T, n, ...] samples with step-0 hidden states.

Buffers live on the host as numpy, where the simulators' observations
arrive; the PPO update (rl/ppo.py) uploads each minibatch through pinned
copies.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np


class ActionDictRolloutStorage:
    ACTION_KEYS = ("pano", "offset", "distance")

    def __init__(
        self,
        num_steps: int,
        num_envs: int,
        observation_space,
        recurrent_hidden_state_size: int,
        num_recurrent_layers: int = 1,
    ):
        self.observations = {
            sensor: np.zeros((num_steps + 1, num_envs) + tuple(space.shape), dtype=space.dtype)
            for sensor, space in observation_space.spaces.items()
        }
        self.recurrent_hidden_states = np.zeros(
            (num_steps + 1, num_envs, num_recurrent_layers, recurrent_hidden_state_size), np.float32
        )
        self.rewards = np.zeros((num_steps, num_envs, 1), np.float32)
        self.value_preds = np.zeros((num_steps + 1, num_envs, 1), np.float32)
        self.returns = np.zeros((num_steps + 1, num_envs, 1), np.float32)
        self.action_log_probs = np.zeros((num_steps, num_envs, 1), np.float32)
        self.actions = {k: np.zeros((num_steps, num_envs, 1), np.float32) for k in self.ACTION_KEYS}
        self.prev_actions = {k: np.zeros((num_steps + 1, num_envs, 1), np.float32) for k in self.ACTION_KEYS}
        self.masks = np.zeros((num_steps + 1, num_envs, 1), np.float32)
        self.num_steps = num_steps
        self.num_envs = num_envs
        self.step = 0

    def insert(
        self,
        observations: Dict[str, np.ndarray],
        recurrent_hidden_states: np.ndarray,
        action: Dict[str, np.ndarray],
        action_log_probs: np.ndarray,
        value_preds: np.ndarray,
        rewards: np.ndarray,
        masks: np.ndarray,
    ) -> None:
        for sensor, v in observations.items():
            self.observations[sensor][self.step + 1] = np.asarray(v)
        self.recurrent_hidden_states[self.step + 1] = np.asarray(recurrent_hidden_states)
        for k in action:
            self.actions[k][self.step] = np.asarray(action[k]).reshape(self.num_envs, 1)
            self.prev_actions[k][self.step + 1] = np.asarray(action[k]).reshape(self.num_envs, 1)
        self.action_log_probs[self.step] = np.asarray(action_log_probs).reshape(self.num_envs, 1)
        self.value_preds[self.step] = np.asarray(value_preds).reshape(self.num_envs, 1)
        self.rewards[self.step] = np.asarray(rewards).reshape(self.num_envs, 1)
        self.masks[self.step + 1] = np.asarray(masks).reshape(self.num_envs, 1)
        self.step += 1

    def after_update(self) -> None:
        for sensor in self.observations:
            self.observations[sensor][0] = self.observations[sensor][self.step]
        self.recurrent_hidden_states[0] = self.recurrent_hidden_states[self.step]
        self.masks[0] = self.masks[self.step]
        for k in self.prev_actions:
            self.prev_actions[k][0] = self.prev_actions[k][self.step]
        self.step = 0

    def compute_returns(self, next_value: np.ndarray, use_gae: bool, gamma: float, tau: float) -> None:
        next_value = np.asarray(next_value).reshape(self.num_envs, 1)
        if use_gae:
            self.value_preds[self.step] = next_value
            gae = np.zeros((self.num_envs, 1), np.float32)
            for step in reversed(range(self.step)):
                delta = (
                    self.rewards[step]
                    + gamma * self.value_preds[step + 1] * self.masks[step + 1]
                    - self.value_preds[step]
                )
                gae = delta + gamma * tau * self.masks[step + 1] * gae
                self.returns[step] = gae + self.value_preds[step]
                assert not np.isnan(self.returns[step]).any(), "Return is NaN"
        else:
            self.returns[self.step] = next_value
            for step in reversed(range(self.step)):
                self.returns[step] = self.returns[step + 1] * gamma * self.masks[step + 1] + self.rewards[step]

    def recurrent_generator(self, advantages: np.ndarray, num_mini_batch: int, rng: np.random.RandomState) -> Iterator[Tuple]:
        """Yields per-env minibatches flattened to [T * n_mb, ...]
        (reference rollout_storage.py:154-276)."""
        N = self.num_envs
        assert N >= num_mini_batch
        T = self.step
        perm = rng.permutation(N)
        envs_per_batch = N // num_mini_batch
        for start in range(0, envs_per_batch * num_mini_batch, envs_per_batch):
            idx = perm[start : start + envs_per_batch]
            n = len(idx)

            # yielded time-major unflattened [T, n, ...]; the update flattens
            # them on the device
            obs_batch = {k: v[:T, idx] for k, v in self.observations.items()}
            hidden0 = self.recurrent_hidden_states[0, idx]
            actions_batch = {k: v[:T, idx] for k, v in self.actions.items()}
            prev_actions_batch = {k: v[:T, idx] for k, v in self.prev_actions.items()}
            value_preds_batch = self.value_preds[:T, idx]
            return_batch = self.returns[:T, idx]
            masks_batch = self.masks[:T, idx]
            old_log_probs_batch = self.action_log_probs[:T, idx]
            adv_targ = advantages[:T, idx]

            yield (
                obs_batch,
                hidden0,
                actions_batch,
                prev_actions_batch,
                value_preds_batch,
                return_batch,
                masks_batch,
                old_log_probs_batch,
                adv_targ,
                T,
                n,
            )
