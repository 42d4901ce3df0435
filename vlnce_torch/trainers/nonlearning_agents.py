"""Nonlearning sanity-check agents.

Port of vlnce_tpu/trainers/nonlearning_agents.py, host only (no kernel
runs). Parity with reference vlnce_baselines/nonlearning_agents.py:14-149:
RandomAgent samples actions from the R2R train-set oracle action
distribution; HandcraftedAgent turns a random amount then walks 37 steps
forward. `evaluate_agent` is the de-facto smoke test of the whole stack.
The JAX module's progress bar is left out: tqdm is not a dependency here.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Any, Dict

import numpy as np

from vlnce_torch.registry import registry
from vlnce_torch.envs.env import Env
from vlnce_torch.envs.sim import SimulatorActions
from vlnce_torch.utils.logging import logger
from vlnce_torch.utils.progress import tqdm


class Agent:
    def reset(self) -> None:
        raise NotImplementedError

    def act(self, observations) -> Dict[str, Any]:
        raise NotImplementedError


@registry.register_agent(name="RandomAgent")
class RandomAgent(Agent):
    """Actions sampled from the R2R train-set action distribution
    (reference nonlearning_agents.py:104-125)."""

    def __init__(self, probs=None, seed: int = 0):
        self.actions = [
            SimulatorActions.STOP,
            SimulatorActions.MOVE_FORWARD,
            SimulatorActions.TURN_LEFT,
            SimulatorActions.TURN_RIGHT,
        ]
        self.probs = probs if probs is not None else [0.02, 0.68, 0.15, 0.15]
        self._rng = np.random.RandomState(seed)

    def reset(self) -> None:
        pass

    def act(self, observations) -> Dict[str, Any]:
        return {"action": int(self._rng.choice(self.actions, p=self.probs))}


@registry.register_agent(name="HandcraftedAgent")
class HandcraftedAgent(Agent):
    """Random initial turn, then 37 forward steps (the mean R2R path is
    ~10m; reference nonlearning_agents.py:128-149)."""

    def __init__(self, seed: int = 0, turn_angle_deg: float = 15.0):
        self._rng = np.random.RandomState(seed)
        self.forward_steps = 37
        self.turns_in_circle = int(360 / turn_angle_deg)
        self.reset()

    def reset(self) -> None:
        self.timestep = 0
        self.turns = int(self._rng.randint(0, self.turns_in_circle))

    def act(self, observations) -> Dict[str, Any]:
        if self.timestep < self.turns:
            action = SimulatorActions.TURN_RIGHT
        elif self.timestep <= self.forward_steps + self.turns:
            action = SimulatorActions.MOVE_FORWARD
        else:
            action = SimulatorActions.STOP
        self.timestep += 1
        return {"action": int(action)}


def evaluate_agent(config) -> Dict[str, float]:
    """Single-Env eval of a nonlearning agent (reference
    nonlearning_agents.py:14-59); sensors not needed by the agent are kept
    (they are cheap here)."""
    split = config.EVAL.SPLIT
    config = config.clone().defrost()
    config.TASK_CONFIG.DATASET.SPLIT = split
    config.TASK_CONFIG.TASK.NDTW.SPLIT = split
    config.TASK_CONFIG.ENVIRONMENT.ITERATOR_OPTIONS.SHUFFLE = False
    config.TASK_CONFIG.ENVIRONMENT.ITERATOR_OPTIONS.MAX_SCENE_REPEAT_STEPS = -1
    config.freeze()

    env = Env(config.TASK_CONFIG)
    agent_name = config.EVAL.NONLEARNING.AGENT
    agent = registry.get_agent(agent_name)(
        seed=config.TASK_CONFIG.SEED,
        **({"turn_angle_deg": config.TASK_CONFIG.SIMULATOR.TURN_ANGLE} if agent_name == "HandcraftedAgent" else {}),
    )

    num_episodes = env.number_of_episodes
    if config.EVAL.EPISODE_COUNT > -1:
        num_episodes = min(config.EVAL.EPISODE_COUNT, num_episodes)

    stats = defaultdict(float)
    for _ in tqdm(range(num_episodes), desc=agent_name):
        obs = env.reset()
        agent.reset()
        while not env.episode_over:
            obs = env.step(agent.act(obs))
        for m, v in env.get_metrics().items():
            if np.isscalar(v):
                stats[m] += v
    env.close()

    stats = {k: v / num_episodes for k, v in stats.items()}
    logger.info(f"Averaged benchmark for {agent_name}:")
    for k, v in stats.items():
        logger.info(f"{k}: {v:.3f}")
    os.makedirs(config.RESULTS_DIR, exist_ok=True)
    with open(os.path.join(config.RESULTS_DIR, f"stats_{agent_name}_{split}.json"), "w") as f:
        json.dump(stats, f, indent=4)
    return stats


def nonlearning_inference(config) -> None:
    """Prediction writing for nonlearning agents (reference
    nonlearning_agents.py:62-101)."""
    from vlnce_torch.tasks.geometry import heading_from_quaternion

    split = config.INFERENCE.SPLIT
    config = config.clone().defrost()
    config.TASK_CONFIG.DATASET.SPLIT = split
    config.TASK_CONFIG.TASK.MEASUREMENTS = []
    config.TASK_CONFIG.ENVIRONMENT.ITERATOR_OPTIONS.SHUFFLE = False
    config.TASK_CONFIG.ENVIRONMENT.ITERATOR_OPTIONS.MAX_SCENE_REPEAT_STEPS = -1
    config.freeze()

    env = Env(config.TASK_CONFIG)
    agent = registry.get_agent(config.INFERENCE.NONLEARNING.AGENT)(seed=config.TASK_CONFIG.SEED)

    episode_predictions = defaultdict(list)
    for _ in tqdm(range(env.number_of_episodes), desc="inference"):
        obs = env.reset()
        agent.reset()
        ep_id = env.current_episode.episode_id

        def pose():
            state = env.sim.get_agent_state()
            return {
                "position": [float(x) for x in state.position],
                "heading": heading_from_quaternion(state.rotation),
                "stop": env.task.is_stop_called,
            }

        episode_predictions[ep_id].append(pose())
        while not env.episode_over:
            obs = env.step(agent.act(obs))
            episode_predictions[ep_id].append(pose())
    env.close()

    out_path = config.INFERENCE.PREDICTIONS_FILE
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(episode_predictions, f, indent=2)
    logger.info(f"Predictions saved to: {out_path}")
