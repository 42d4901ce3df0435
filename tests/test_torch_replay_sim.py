"""The port's ReplaySim (`vlnce_torch/envs/replay_sim.py`) held against the
JAX package's on the trajectories of `tests/test_measures.py`: both
simulators drive both packages' VLNTask through the same actions, and every
pose, observation and measure must be equal at every step."""

from __future__ import annotations

import numpy as np
import pytest

import vlnce_tpu.envs  # noqa: F401  (registry)
import vlnce_tpu.tasks  # noqa: F401
import vlnce_torch.config  # noqa: F401  (before the task config: the two import each other)
import vlnce_torch.envs  # noqa: F401
import vlnce_torch.tasks  # noqa: F401
from vlnce_tpu.envs.replay_sim import ReplaySim as JaxReplaySim
from vlnce_tpu.tasks.config.default import get_default_task_config as jax_task_config
from vlnce_tpu.tasks.episodes import InstructionData as JaxInstruction
from vlnce_tpu.tasks.episodes import NavigationGoal as JaxGoal
from vlnce_tpu.tasks.episodes import VLNEpisode as JaxEpisode
from vlnce_tpu.tasks.task import VLNTask as JaxTask
from vlnce_torch.envs.replay_sim import ReplaySim
from vlnce_torch.registry import registry
from vlnce_torch.tasks.config.default import get_default_task_config
from vlnce_torch.tasks.episodes import InstructionData, NavigationGoal, VLNEpisode
from vlnce_torch.tasks.task import VLNTask

MEASURES = ["DISTANCE_TO_GOAL", "SUCCESS", "SPL", "NDTW", "SDTW", "PATH_LENGTH",
            "ORACLE_NAVIGATION_ERROR", "ORACLE_SUCCESS", "ORACLE_SPL", "STEPS_TAKEN"]

# (scene, positions [T, 3], headings [T], reference path, goal, geodesic):
# test_measures.py's straight line, its offset path, and a turning one
CASES = {
    "test_scene": (np.stack([np.zeros(11), np.zeros(11), -0.25 * np.arange(11)], 1), np.zeros(11),
                   [[0, 0, -0.25 * i] for i in range(11)], [0, 0, -2.5], 2.5),
    "offset_scene": (np.stack([np.ones(5), np.zeros(5), -1.0 * np.arange(5)], 1), np.zeros(5),
                     [[0, 0, -1.0 * i] for i in range(5)], [0, 0, -4.0], 4.0),
    "turning_scene": (np.stack([0.3 * np.arange(9), np.zeros(9), -0.2 * np.arange(9) ** 1.2], 1),
                      np.linspace(0.0, 1.4, 9), [[0, 0, 0], [1.2, 0, -1.0], [2.4, 0, -2.8]], [2.4, 0, -2.8], 3.7),
}


def _pair(scene, with_obs):
    positions, headings, ref, goal, geo = CASES[scene]
    obs = [{"rgb": np.full((4, 4, 3), t, np.uint8)} for t in range(len(positions))] if with_obs else None
    out = []
    for sim_cls, task_cls, cfg_fn, ep_cls, ins_cls, goal_cls in (
            (JaxReplaySim, JaxTask, jax_task_config, JaxEpisode, JaxInstruction, JaxGoal),
            (ReplaySim, VLNTask, get_default_task_config, VLNEpisode, InstructionData, NavigationGoal)):
        sim_cls.register_trajectory(scene, positions, headings, obs)
        cfg = cfg_fn().defrost()
        cfg.TASK.SENSORS = []
        cfg.TASK.MEASUREMENTS = list(MEASURES)
        sim = sim_cls(cfg.SIMULATOR)
        sim.reconfigure(scene)
        episode = ep_cls(
            episode_id="0", scene_id=scene, start_position=list(positions[0]), start_rotation=[0.0, 0.0, 0.0, 1.0],
            instruction=ins_cls(instruction_text="go", instruction_tokens=[2, 3]),
            goals=[goal_cls(position=list(goal), radius=3.0)], reference_path=[list(p) for p in ref],
            info={"geodesic_distance": geo},
        )
        out.append((sim, task_cls(cfg.TASK, sim), episode))
    return out


@pytest.mark.parametrize("scene", sorted(CASES))
@pytest.mark.parametrize("with_obs", [False, True], ids=["no_obs", "obs"])
def test_replay_sim_matches_jax(scene, with_obs):
    pair = _pair(scene, with_obs)
    for sim, task, ep in pair:
        task.reset(ep)
    n = len(CASES[scene][0]) + 2  # past the trajectory's end: the pose stays at its last entry
    for t in range(n):
        action = {"action": "STOP"} if t == n - 1 else {"action": "MOVE_FORWARD"}
        (js, jt, je), (ps, pt, pe) = pair
        jo, po = jt.step(action, je), pt.step(action, pe)
        assert sorted(jo) == sorted(po)
        for k in jo:
            np.testing.assert_array_equal(jo[k], po[k])
        a, b = js.get_agent_state(), ps.get_agent_state()
        np.testing.assert_array_equal(a.position, b.position)
        np.testing.assert_array_equal(a.rotation, b.rotation)
        assert jt.measurements.get_metrics() == pt.measurements.get_metrics()
    (js, _, _), (ps, _, _) = pair
    probe = [[1.0, 0.0, 2.0], [0.5, 0.0, -3.0]]
    assert js.geodesic_distance(probe[0], probe[1]) == ps.geodesic_distance(probe[0], probe[1])
    assert js.geodesic_distance(probe[0], probe) == ps.geodesic_distance(probe[0], probe)
    assert js.get_straight_shortest_path_points(*probe) == ps.get_straight_shortest_path_points(*probe)
    for fn in ("snap_point", "is_navigable"):
        np.testing.assert_array_equal(getattr(js, fn)(probe[0]), getattr(ps, fn)(probe[0]))
    np.testing.assert_array_equal(js.step_filter(*probe), ps.step_filter(*probe))
    assert js.sample_navigable_point() == ps.sample_navigable_point()


def test_unregistered_scene_replays_the_default_line():
    sims = [JaxReplaySim(None), ReplaySim(None)]
    for s in sims:
        s.reconfigure("never_registered_scene")
        s.reset()
        for _ in range(3):
            s.step(1)
    np.testing.assert_array_equal(sims[0].get_agent_state().position, sims[1].get_agent_state().position)
    assert sims[1].get_agent_state().position[2] == -0.75


def test_registered_as_in_jax():
    assert registry.get_simulator("ReplaySim-v0") is ReplaySim
