"""The port's waypoint task side against the JAX package's on the synthetic
GridWorld: `add_pano_sensors_to_config`, `DiscretePathPlanner`,
`WaypointRewardMeasure` and the two waypoint envs (`VLNCEWaypointEnv`,
`VLNCEWaypointEnvDiscretized`). The same action sequence through both
packages' envs gives bit-equal observations and equal rewards, dones and
metrics (both are numpy host code: exact equality)."""

import json
import math

import numpy as np
import pytest

import vlnce_torch.tasks  # noqa: F401
import vlnce_tpu.tasks  # noqa: F401
from vlnce_torch.config import get_config
from vlnce_torch.config.default import add_pano_sensors_to_config
from vlnce_torch.envs import ensure_registered, rl_envs
from vlnce_torch.tasks.discrete_planner import DiscretePathPlanner
from vlnce_tpu.config import get_config as jax_get_config
from vlnce_tpu.config.default import add_pano_sensors_to_config as jax_add_pano_sensors_to_config
from vlnce_tpu.envs import ensure_registered as jax_ensure_registered
from vlnce_tpu.envs import rl_envs as jax_rl_envs
from vlnce_tpu.tasks.discrete_planner import DiscretePathPlanner as JaxDiscretePathPlanner

ensure_registered()
jax_ensure_registered()

SMOKE = "config/experiments/synthetic/smoke_waypoint.yaml"
DN = "tasks/config/vlnce_waypoint_DN.yaml"
OPTS = ["TASK_CONFIG.DATASET.NUM_EPISODES", 4, "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", 6,
        "TASK_CONFIG.SIMULATOR.RGB_SENSOR.HEIGHT", 16, "TASK_CONFIG.SIMULATOR.RGB_SENSOR.WIDTH", 16,
        "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.HEIGHT", 16, "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.WIDTH", 16]


def _configs(discretized=False, extra=()):
    """(port config, jax config) of the synthetic waypoint smoke experiment
    (with the discrete-navigator override), pano sensors added."""
    paths = [SMOKE] + ([DN] if discretized else [])
    cfg = get_config(",".join(f"vlnce_torch/{p}" for p in paths), OPTS + list(extra))
    jcfg = jax_get_config(",".join(f"vlnce_tpu/{p}" for p in paths), OPTS + list(extra))
    return add_pano_sensors_to_config(cfg), jax_add_pano_sensors_to_config(jcfg)


def test_add_pano_sensors_matches_jax():
    cfg, jcfg = _configs()
    assert cfg.SENSORS == jcfg.SENSORS == ["RGB_SENSOR", "DEPTH_SENSOR"] + [f"RGB_{i}" for i in range(1, 12)] + [
        f"DEPTH_{i}" for i in range(1, 12)]
    assert cfg.TASK_CONFIG.SIMULATOR.to_dict() == jcfg.TASK_CONFIG.SIMULATOR.to_dict()
    assert cfg.TASK_CONFIG.SIMULATOR.RGB_5.UUID == "rgb_5"
    np.testing.assert_allclose(cfg.TASK_CONFIG.SIMULATOR.DEPTH_3.ORIENTATION, [0.0, math.pi / 2, 0.0])


def test_discrete_planner_matches_jax():
    rng = np.random.RandomState(0)
    for step, turn in ((0.25, 15.0), (0.25, 30.0)):
        kw = dict(forward_distance=step, turn_angle=math.radians(turn), goal_radius=round(step / 2, 2) + 0.01)
        planner, jax_planner = DiscretePathPlanner(**kw), JaxDiscretePathPlanner(**kw)
        for r, theta in zip(rng.uniform(0.0, 3.0, 24), rng.uniform(0.0, 2 * math.pi, 24)):
            assert planner.plan(r, theta) == jax_planner.plan(r, theta), (r, theta)


def _actions(rng, n):
    """GO_TOWARD_POINT waypoints (some inside the goal radius, some long),
    nested as the policy hands them over, with a STOP among them."""
    out = []
    for i in range(n):
        if i == n - 2:
            out.append({"action": "STOP"})
        else:
            r = float(rng.choice([0.05, rng.uniform(0.25, 3.0)]))
            out.append({"action": {"action": "GO_TOWARD_POINT", "action_args": {"r": r, "theta": float(rng.uniform(0, 2 * math.pi))}}})
    return out


def _assert_step_equal(a, b):
    obs, reward, done, info = a
    jobs, jreward, jdone, jinfo = b
    assert sorted(obs) == sorted(jobs)
    for k in obs:
        np.testing.assert_array_equal(obs[k], jobs[k], err_msg=k)
    assert reward == jreward and done == jdone
    assert info.keys() == jinfo.keys()
    for k in info:
        np.testing.assert_array_equal(info[k], jinfo[k], err_msg=k)


@pytest.mark.parametrize("measure_opts", [(), ("TASK_CONFIG.TASK.WAYPOINT_REWARD_MEASURE.scale_slack_on_prediction", False),
                                          ("TASK_CONFIG.TASK.WAYPOINT_REWARD_MEASURE.use_distance_scaled_slack_reward", False)],
                         ids=["scaled_on_prediction", "scaled_on_distance", "flat_slack"])
def test_waypoint_env_and_reward_match_jax(measure_opts):
    """VLNCEWaypointEnv over episodes: reset, waypoint steps and STOP, done on
    stop or success; the WaypointRewardMeasure's reward in each of its
    slack modes."""
    cfg, jcfg = _configs(extra=measure_opts)
    env, jenv = rl_envs.VLNCEWaypointEnv(cfg), jax_rl_envs.VLNCEWaypointEnv(jcfg)
    env.seed(3)
    jenv.seed(3)
    rng = np.random.RandomState(1)
    rewards = []
    for _ in range(3):
        obs, jobs = env.reset(), jenv.reset()
        assert sorted(obs) == sorted(jobs) and "rgb_11" in obs and "depth_11" in obs
        for k in obs:
            np.testing.assert_array_equal(obs[k], jobs[k], err_msg=k)
        for action in _actions(rng, 6):
            step, jstep = env.step(action), jenv.step(action)
            _assert_step_equal(step, jstep)
            rewards.append(step[1])
            if step[2]:
                break
    assert "waypoint_reward_measure" in step[3] and len(set(rewards)) > 2
    env.close()
    jenv.close()


def test_discretized_waypoint_env_matches_jax(tmp_path):
    """VLNCEWaypointEnvDiscretized: each waypoint planned into TURN/FORWARD
    steps, a waypoint within the goal radius re-fetches the observations,
    zero reward, equal metrics. With VIDEO_OPTION [disk] both envs write the
    episode's navigator video under the same name (up to the extension),
    with a frame per discrete step, and step exactly as without video."""
    from tests.torch_port_cases import video_files

    runs = {}
    for video in (False, True):
        extra = ["VIDEO_OPTION", ["disk"], "VIDEO_DIR", str(tmp_path / "videos")] if video else []
        cfg, jcfg = _configs(discretized=True, extra=extra)
        if video:
            cfg.defrost()
            cfg.VIDEO_DIR = str(tmp_path / "videos" / "port")
            jcfg.defrost()
            jcfg.VIDEO_DIR = str(tmp_path / "videos" / "jax")
        assert cfg.ENV_NAME == jcfg.ENV_NAME == "VLNCEWaypointEnvDiscretized"
        env, jenv = rl_envs.VLNCEWaypointEnvDiscretized(cfg), jax_rl_envs.VLNCEWaypointEnvDiscretized(jcfg)
        rng = np.random.RandomState(2)
        runs[video] = steps = []
        for _ in range(2):
            obs, jobs = env.reset(), jenv.reset()
            for k in obs:
                np.testing.assert_array_equal(obs[k], jobs[k], err_msg=k)
            for action in _actions(rng, 5):
                step, jstep = env.step(action), jenv.step(action)
                _assert_step_equal(step, jstep)
                assert step[1] == 0.0
                steps.append(step)
                if video:
                    assert len(env._video_frames) == len(jenv._video_frames)
                if step[2]:
                    break
            if not step[2]:
                step, jstep = env.step({"action": "STOP"}), jenv.step({"action": "STOP"})
                _assert_step_equal(step, jstep)
                steps.append(step)
        env.close()
        jenv.close()
    assert len(runs[True]) == len(runs[False])
    for a, b in zip(runs[True], runs[False]):
        _assert_step_equal(a, b)
    port_videos, jax_videos = video_files(tmp_path / "videos" / "port"), video_files(tmp_path / "videos" / "jax")
    assert sorted(port_videos) == sorted(jax_videos) and all("SPL=" in n for n in port_videos)
    for name, frames in port_videos.items():
        assert frames.shape[0] == jax_videos[name].shape[0] > 1, name


class _NullWriter:
    def add_scalar(self, *args):
        pass


def test_waypoint_eval_with_video_matches_jax(tmp_path, monkeypatch):
    """The ddppo-waypoint eval with VIDEO_OPTION [disk] (the JAX test of
    tests/test_trainers.py's waypoint eval video): both trainers evaluate the
    same weights and write one waypoint debug video per episode under the
    same names (up to the extension), with as many frames; the port's
    episodes and scalar metrics equal its run without video, and JAX's."""
    from vlnce_tpu.trainers.ddppo_waypoint_trainer import DDPPOWaypointTrainer as JaxTrainer
    from vlnce_tpu.utils.checkpoints import save_checkpoint as jax_save_checkpoint
    from vlnce_torch.models.convert import state_dict_from_jax_params
    from vlnce_torch.trainers.ddppo_waypoint_trainer import DDPPOWaypointTrainer
    from vlnce_torch.utils.checkpoints import save_checkpoint

    from tests.torch_port_cases import video_files
    from tests.torch_port_cases import build_waypoint_pair

    monkeypatch.setenv("VLNCE_TPU_THREADED_ENVS", "1")
    monkeypatch.setenv("VLNCE_TORCH_THREADED_ENVS", "1")
    (_, params), _, (jcfg, cfg) = build_waypoint_pair("1-wpn-cc", seed=4)
    jax_path, port_path = str(tmp_path / "ckpt.0.ckpt"), str(tmp_path / "ckpt.0.pth")
    jax_save_checkpoint(jax_path, params, config=jcfg)
    save_checkpoint(port_path, state_dict_from_jax_params(params, "WaypointPolicy"), config=cfg)

    def opts(name, video):
        out = ["ENV_NAME", "VLNCEWaypointEnv", "NUM_ENVIRONMENTS", 2, "EVAL.EPISODE_COUNT", 3, "EVAL.SAMPLE", False,
               "EVAL.SPLIT", "val_unseen", "EVAL.USE_CKPT_CONFIG", False, "TASK_CONFIG.DATASET.NUM_EPISODES", 4,
               "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", 3, "RESULTS_DIR", str(tmp_path / name / "evals"),
               "TASK_CONFIG.TASK.TOP_DOWN_MAP_VLNCE.MAP_RESOLUTION", 256,
               "TASK_CONFIG.TASK.MEASUREMENTS", ["DISTANCE_TO_GOAL", "SUCCESS", "SPL", "NDTW", "PATH_LENGTH", "ORACLE_SUCCESS",
                                                 "STEPS_TAKEN", "WAYPOINT_REWARD_MEASURE", "TOP_DOWN_MAP_VLNCE"]]
        return out + (["VIDEO_OPTION", ["disk"], "VIDEO_DIR", str(tmp_path / name / "videos")] if video else [])

    from tests.torch_port_cases import waypoint_configs

    runs = {}
    for name, video in (("port", True), ("plain", False)):
        trainer = DDPPOWaypointTrainer(waypoint_configs("1-wpn-cc", opts(name, video))[1])
        trainer._eval_checkpoint(port_path, _NullWriter(), 0)
        runs[name] = trainer._last_eval_episode_stats
    jax_trainer = JaxTrainer(waypoint_configs("1-wpn-cc", opts("jax", True))[0])
    jax_trainer._eval_checkpoint(jax_path, _NullWriter(), 0)
    assert runs["port"] == runs["plain"] and len(runs["port"]) >= 3
    # the JAX trainer keeps no per-episode stats: compare the written means
    with open(tmp_path / "port" / "evals" / "stats_ckpt_0_val_unseen.json") as f, \
            open(tmp_path / "jax" / "evals" / "stats_ckpt_0_val_unseen.json") as jf:
        written, jax_written = json.load(f), json.load(jf)
    assert sorted(written) == sorted(jax_written)
    for k, v in written.items():
        np.testing.assert_allclose(v, jax_written[k], rtol=0, atol=1e-5, err_msg=k)
    port_videos, jax_videos = video_files(tmp_path / "port" / "videos"), video_files(tmp_path / "jax" / "videos")
    assert sorted(port_videos) == sorted(jax_videos) and len(port_videos) == len(runs["port"])
    for name, frames in port_videos.items():
        assert frames.shape[0] == jax_videos[name].shape[0] >= 1, name
        assert frames.shape[0] == runs["port"][name.split("-ckpt=")[0][len("episode="):]]["steps_taken"], name
