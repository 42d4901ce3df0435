"""The port's host env layer against the JAX package's: the same actions
through both `Env`s give bit-equal observations and equal metrics; the
vector envs (forked workers and in-process) expose the same API; the
gymnasium-free spaces equal gymnasium's in shape and dtype."""

import numpy as np
import pytest

import vlnce_torch.tasks  # noqa: F401
import vlnce_tpu.tasks  # noqa: F401
from vlnce_torch.config import get_config
from vlnce_torch.envs import Env, ensure_registered, rl_envs  # noqa: F401
from vlnce_torch.envs import spaces
from vlnce_torch.envs.batch import ObsSlots, stack_obs
from vlnce_torch.envs.env_utils import construct_envs, construct_envs_auto_reset_false, get_env_class
from vlnce_torch.envs.spaces import observation_space_from_config
from vlnce_torch.envs.vector_env import ThreadedVectorEnv, VectorEnv
from vlnce_torch.registry import registry
from vlnce_tpu.config import get_config as jax_get_config
from vlnce_tpu.envs import Env as JaxEnv
from vlnce_tpu.envs import ensure_registered as jax_ensure_registered
from vlnce_tpu.envs import rl_envs as jax_rl_envs  # noqa: F401
from vlnce_tpu.envs.env_utils import construct_envs as jax_construct_envs
from vlnce_tpu.envs.env_utils import get_env_class as jax_get_env_class

from tests.torch_port_cases import JAX_RXR_CMA, RXR_CMA

ensure_registered()
jax_ensure_registered()

IMG = ["TASK_CONFIG.SIMULATOR.RGB_SENSOR.HEIGHT", 24, "TASK_CONFIG.SIMULATOR.RGB_SENSOR.WIDTH", 32,
       "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.HEIGHT", 24, "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.WIDTH", 32]
R2R = IMG + ["TASK_CONFIG.DATASET.TYPE", "Synthetic-VLN-v0", "TASK_CONFIG.DATASET.NUM_EPISODES", 8,
             "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", 12, "NUM_ENVIRONMENTS", 2]
RXR = R2R + ["TASK_CONFIG.TASK.RXR_INSTRUCTION_SENSOR.feature_dim", 8, "TASK_CONFIG.TASK.RXR_INSTRUCTION_SENSOR.max_text_len", 16]


def _configs(task: str, extra=()):
    if task == "rxr":
        return get_config(RXR_CMA, RXR + list(extra)), jax_get_config(JAX_RXR_CMA, RXR + list(extra))
    r2r = ["TASK_CONFIG.TASK.SENSORS", ["INSTRUCTION_SENSOR", "SHORTEST_PATH_SENSOR", "VLN_ORACLE_PROGRESS_SENSOR"]]
    return (get_config(opts=["BASE_TASK_CONFIG_PATH", "vlnce_torch/tasks/config/vlnce_task.yaml"] + R2R + r2r + list(extra)),
            jax_get_config(opts=["BASE_TASK_CONFIG_PATH", "vlnce_tpu/tasks/config/vlnce_task.yaml"] + R2R + r2r + list(extra)))


def _assert_obs_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("task,seed", [("r2r", 0), ("r2r", 1), ("rxr", 0), ("rxr", 1)])
def test_env_matches_jax_on_one_action_sequence(task, seed):
    cfg, jcfg = _configs(task)
    env, jenv = Env(cfg.TASK_CONFIG), JaxEnv(jcfg.TASK_CONFIG)
    assert env.number_of_episodes == jenv.number_of_episodes == 8
    rng = np.random.RandomState(seed)
    for _ in range(3):
        _assert_obs_equal(env.reset(), jenv.reset())
        assert env.current_episode.episode_id == jenv.current_episode.episode_id
        while not env.episode_over:
            action = int(rng.choice([1, 1, 1, 2, 3, 0], p=[0.3, 0.2, 0.2, 0.14, 0.14, 0.02]))
            _assert_obs_equal(env.step(action), jenv.step(action))
            assert env.get_metrics() == jenv.get_metrics()
            assert env.episode_over == jenv.episode_over
    assert set(env.get_metrics()) >= {"distance_to_goal", "success", "spl", "ndtw", "path_length", "oracle_success", "steps_taken"}
    env.close(), jenv.close()


@pytest.mark.parametrize("task", ["r2r", "rxr"])
def test_spaces_equal_gymnasium_in_shape_and_dtype(task):
    cfg, jcfg = _configs(task)
    env, jenv = Env(cfg.TASK_CONFIG), JaxEnv(jcfg.TASK_CONFIG)
    ours, theirs = env.observation_space, jenv.observation_space
    assert sorted(ours.spaces) == sorted(theirs.spaces)
    for k, box in ours.spaces.items():
        assert box.shape == theirs[k].shape and box.dtype == theirs[k].dtype
        np.testing.assert_array_equal(box.low, theirs[k].low)
        np.testing.assert_array_equal(box.high, theirs[k].high)
    assert env.action_space.n == jenv.action_space.n == len(cfg.TASK_CONFIG.TASK.POSSIBLE_ACTIONS)
    # the space the policy is built from without an env is the env's own
    built = observation_space_from_config(cfg.TASK_CONFIG)
    for k in ("rgb", "depth"):
        assert built[k].shape == ours[k].shape and built[k].dtype == ours[k].dtype
    env.close(), jenv.close()


def test_box_takes_array_bounds_like_gymnasium():
    from gymnasium import spaces as gym

    ours = spaces.Box(low=np.array([0.0]), high=np.array([2 * np.pi]), dtype=np.float64)
    theirs = gym.Box(low=np.array([0.0]), high=np.array([2 * np.pi]), dtype=np.float64)
    assert ours.shape == theirs.shape == (1,) and ours.dtype == theirs.dtype
    np.testing.assert_array_equal(ours.high, theirs.high)
    teleport = registry.get_task_action("TeleportAction")().action_space
    assert teleport["position"].shape == (3,) and teleport["rotation"].dtype == np.float32
    assert isinstance(teleport, spaces.Space) and isinstance(spaces.Discrete(4), spaces.Space)


@pytest.fixture(params=["threaded", "process"])
def envs(request, monkeypatch):
    if request.param == "threaded":
        monkeypatch.setenv("VLNCE_TORCH_THREADED_ENVS", "1")
    else:
        monkeypatch.delenv("VLNCE_TORCH_THREADED_ENVS", raising=False)
    cfg, _ = _configs("rxr")
    e = construct_envs_auto_reset_false(cfg, get_env_class("VLNCEDaggerEnv"))
    assert isinstance(e, ThreadedVectorEnv if request.param == "threaded" else VectorEnv)
    yield e
    e.close()


def test_vector_env_api(envs):
    obs = envs.reset()
    assert envs.num_envs == 2 and len(obs) == 2 and obs[0]["rgb"].shape == (24, 32, 3)
    episodes = envs.current_episodes()
    assert [type(e).__name__ for e in episodes] == ["VLNEpisode", "VLNEpisode"]
    assert envs.number_of_episodes == [4, 4]  # the 4 scenes go round-robin to the 2 workers, 2 episodes each
    assert envs.observation_spaces[0]["depth"].shape == (24, 32, 1) and envs.action_spaces[1].n == 6

    # step one env only: the other keeps its episode and its step count
    (obs1, reward, done, info), = envs.step_at([1], [1])
    assert reward == 0.0 and not done and info["steps_taken"] == 1.0
    assert envs.call_at(0, "get_metrics")["steps_taken"] == 0.0
    assert envs.call_at(1, "current_episode").episode_id == episodes[1].episode_id

    # STOP ends the episode; without auto-reset the env waits for reset_at
    (_, _, done, info), = envs.step_at([0], [0])
    assert done and envs.episodes_over() == [True, False]
    (fresh,) = envs.reset_at(0)
    assert fresh["rgb"].shape == (24, 32, 3)
    assert envs.call_at(0, "current_episode").episode_id != episodes[0].episode_id
    assert envs.call_at(0, "get_info", [None])["steps_taken"] == 0.0

    out = envs.step([1, 2])
    assert len(out) == 2 and [o[3]["steps_taken"] for o in out] == [1.0, 2.0]


def test_vector_env_matches_jax_vector_env(monkeypatch):
    """Forked workers of both packages, same actions: same episodes, bit-equal
    observations, equal infos, with auto-reset on."""
    monkeypatch.delenv("VLNCE_TORCH_THREADED_ENVS", raising=False)
    monkeypatch.delenv("VLNCE_TPU_THREADED_ENVS", raising=False)
    monkeypatch.setenv("VLNCE_TPU_SHM_OBS", "0")
    cfg, jcfg = _configs("r2r", ["TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", 4])
    ours = construct_envs(cfg, get_env_class("VLNCEDaggerEnv"))
    theirs = jax_construct_envs(jcfg, jax_get_env_class("VLNCEDaggerEnv"))
    try:
        for a, b in zip(ours.reset(), theirs.reset()):
            _assert_obs_equal(a, b)
        rng = np.random.RandomState(0)
        for _ in range(10):
            actions = [int(a) for a in rng.randint(1, 4, size=2)]
            assert [e.episode_id for e in ours.current_episodes()] == [e.episode_id for e in theirs.current_episodes()]
            for (o, r, d, i), (jo, jr, jd, ji) in zip(ours.step(actions), theirs.step(actions)):
                _assert_obs_equal(o, jo)
                assert (r, d, i) == (jr, jd, ji)
    finally:
        ours.close(), theirs.close()


def test_dead_worker_raises_instead_of_hanging(monkeypatch):
    monkeypatch.delenv("VLNCE_TORCH_THREADED_ENVS", raising=False)
    cfg, _ = _configs("r2r")
    envs = construct_envs(cfg, get_env_class("VLNCEDaggerEnv"))
    envs.reset()
    envs._workers[1].kill()
    envs._workers[1].join()
    with pytest.raises((EOFError, ConnectionError)):
        envs.step([1, 1])
    envs.close()


def test_obs_slots_keep_fixed_batch_and_update_one_slot():
    cfg, _ = _configs("rxr")
    env = Env(cfg.TASK_CONFIG)
    first = env.reset()
    second = env.step(1)
    slots = ObsSlots([first, first], "cpu")
    slots.update(1, second)
    batch = slots.to_device()
    want = stack_obs([first, second])
    assert slots.nbytes() == sum(v.nbytes for v in want.values())
    for k, v in want.items():
        assert tuple(batch[k].shape) == v.shape
        np.testing.assert_array_equal(batch[k].numpy(), v)
    env.close()
