"""The port's task layer (geometry, DTW, followers, datasets, vocab) against
the JAX package's, on the same seeded inputs. Both are numpy on the host, so
every comparison is exact."""

import dataclasses
import math
import pickle

import attr
import numpy as np
import pytest

import vlnce_torch.config  # noqa: F401  (before tasks.config: the two import each other)
import vlnce_torch.tasks  # noqa: F401
import vlnce_tpu.tasks  # noqa: F401
from vlnce_torch.envs import Env
from vlnce_torch.tasks import dtw as t_dtw
from vlnce_torch.tasks import geometry as t_geo
from vlnce_torch.tasks.config.default import get_default_task_config
from vlnce_torch.tasks.datasets import make_dataset
from vlnce_torch.tasks.episodes import ExtendedInstructionData, VLNEpisode
from vlnce_torch.tasks.shortest_path_follower import ShortestPathFollower, ShortestPathFollowerCompat
from vlnce_torch.tasks.vocab import VocabDict
from vlnce_tpu.envs import Env as JaxEnv
from vlnce_tpu.tasks import dtw as j_dtw
from vlnce_tpu.tasks import geometry as j_geo
from vlnce_tpu.tasks.config.default import get_default_task_config as jax_default_task_config
from vlnce_tpu.tasks.datasets import make_dataset as jax_make_dataset
from vlnce_tpu.tasks.shortest_path_follower import (
    ShortestPathFollower as JaxFollower,
    ShortestPathFollowerCompat as JaxFollowerCompat,
)
from vlnce_tpu.tasks.vocab import VocabDict as JaxVocabDict

SEEDS = [0, 1, 2]


def _same(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("seed", SEEDS)
def test_geometry_matches_jax(seed):
    rng = np.random.RandomState(seed)
    for _ in range(20):
        phi, r, theta = rng.uniform(0, 2 * math.pi), rng.uniform(0.1, 3.0), rng.uniform(0, 2 * math.pi)
        v, w = rng.randn(3), rng.randn(3)
        q1 = t_geo.quat_from_angle_axis(phi, v / np.linalg.norm(v))
        q2 = t_geo.quat_from_heading(theta)
        calls = [
            ("quat_from_angle_axis", (phi, v / np.linalg.norm(v))),
            ("quat_from_heading", (phi,)),
            ("quat_multiply", (q1, q2)),
            ("quat_inverse", (q1,)),
            ("quat_rotate_vector", (q1, w)),
            ("angle_between_quaternions", (q1, q2)),
            ("quat_from_two_vectors", (v, w)),
            ("heading_from_quaternion", (q2,)),
            ("heading_to_forward_xz", (phi,)),
            ("cartesian_to_polar", (v[0], v[1])),
            ("euclidean_distance", (v, w)),
            ("compute_heading_to", (v, w)),
            ("rtheta_to_global_coordinates", (v, phi, r, theta)),
        ]
        for name, args in calls:
            _same(getattr(t_geo, name)(*args), getattr(j_geo, name)(*args))
    pano, offset, dist = rng.randint(0, 12, 5), rng.uniform(-0.2, 0.2, 5), rng.uniform(0.25, 3.0, 5)
    pos, heading = rng.randn(5, 3), rng.uniform(0, 2 * math.pi, 5)
    _same(t_geo.predictions_to_global_xz(pano, offset, dist, pos, heading),
          j_geo.predictions_to_global_xz(pano, offset, dist, pos, heading))


@pytest.mark.parametrize("seed", SEEDS)
def test_dtw_and_fastdtw_match_jax(seed):
    rng = np.random.RandomState(seed)
    for n, m in [(1, 2), (7, 5), (40, 23), (60, 30)]:
        x, y = rng.randn(n, 3), rng.randn(m, 3)
        assert t_dtw.dtw(x, y) == j_dtw.dtw(x, y)
        for radius in (1, 3):
            assert t_dtw.fastdtw(x, y, radius=radius) == j_dtw.fastdtw(x, y, radius=radius)
    path = np.cumsum(rng.randn(30, 3) * 0.1, axis=0).tolist()
    assert t_dtw.fastdtw(path, path[::2]) == j_dtw.fastdtw(path, path[::2])


def _task_config(default, split="train", n=12):
    cfg = default().defrost()
    cfg.DATASET.TYPE = "Synthetic-VLN-v0"
    cfg.DATASET.SPLIT = split
    cfg.DATASET.NUM_EPISODES = n
    cfg.TASK.SENSORS = ["INSTRUCTION_SENSOR"]
    cfg.TASK.MEASUREMENTS = ["DISTANCE_TO_GOAL", "SUCCESS", "SPL"]
    for s in ("RGB_SENSOR", "DEPTH_SENSOR"):
        cfg.SIMULATOR[s].HEIGHT = 16
        cfg.SIMULATOR[s].WIDTH = 16
    return cfg


@pytest.mark.parametrize("split", ["train", "val_seen", "val_unseen", "test"])
def test_synthetic_episodes_equal_field_by_field(split):
    ours = make_dataset("Synthetic-VLN-v0", _task_config(get_default_task_config, split).DATASET)
    theirs = jax_make_dataset("Synthetic-VLN-v0", _task_config(jax_default_task_config, split).DATASET)
    assert len(ours) == len(theirs) == 12
    for a, b in zip(ours.episodes, theirs.episodes):
        assert dataclasses.asdict(a) == attr.asdict(b)
    assert ours.instruction_vocab.word_list == theirs.instruction_vocab.word_list
    assert type(ours).get_scenes_to_load(ours.config) == type(theirs).get_scenes_to_load(theirs.config)


def test_episode_records_pickle_and_drop_unknown_keys():
    ep = VLNEpisode.from_dict({
        "episode_id": "7", "scene_id": "s.glb", "start_position": [0.0, 0.0, 0.0], "start_rotation": [0.0, 0.0, 0.0, 1.0],
        "not_a_field": 1,
    })
    ep.instruction = ExtendedInstructionData.from_dict({"instruction_text": "go", "instruction_id": "12", "extra": 2})
    back = pickle.loads(pickle.dumps(ep))
    assert back == ep and back.instruction.instruction_id == "12"
    with pytest.raises(TypeError):
        VLNEpisode("7", "s.glb", [0.0] * 3, [0.0] * 4)  # keyword-only, as the attrs record is


def test_vocab_matches_jax():
    words = ["<pad>", "<unk>", "walk", "left", "door"]
    ours, theirs = VocabDict(words), JaxVocabDict(words)
    text = "Walk LEFT, past the door; walk."
    assert ours.tokenize_and_index(text) == theirs.tokenize_and_index(text) == [2, 3, 1, 1, 4, 2]
    assert len(ours) == len(theirs) and ours.idx2word(3) == theirs.idx2word(3)


@pytest.mark.parametrize("follower", ["geodesic", "compat", "compat_greedy"])
def test_followers_take_the_same_actions(follower):
    """Both packages' followers, each on its own env at the same episode,
    give the same action at every step and stop at the same place."""
    env, jenv = Env(_task_config(get_default_task_config)), JaxEnv(_task_config(jax_default_task_config))
    for _ in range(3):
        env.reset(), jenv.reset()
        assert env.current_episode.episode_id == jenv.current_episode.episode_id
        goal = env.current_episode.goals[0].position
        if follower == "geodesic":
            ours, theirs = ShortestPathFollower(env.sim, 0.5, False), JaxFollower(jenv.sim, 0.5, False)
        else:
            ours, theirs = ShortestPathFollowerCompat(env.sim, 0.5, False), JaxFollowerCompat(jenv.sim, 0.5, False)
            if follower == "compat_greedy":
                ours.mode = theirs.mode = "greedy"
        steps = 0
        while steps < 200:
            a, b = ours.get_next_action(goal), theirs.get_next_action(goal)
            assert a == b
            if a is None or int(a) == 0:
                break
            env.sim.step(int(a)), jenv.sim.step(int(b))
            steps += 1
        assert steps > 0
        _same(env.sim.get_agent_state().position, jenv.sim.get_agent_state().position)
        assert env.sim.geodesic_distance(list(env.sim.get_agent_state().position), list(goal)) <= 0.5
    env.close(), jenv.close()
