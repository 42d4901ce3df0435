"""The port's shared-memory observation ring (vlnce_torch/envs/shm_transport.py
over vlnce_torch/native/obs_ring.cpp) against the JAX package's, and the
port's forked pool with the ring against the same pool over pipes.

g++ is on this host, so the ring is built and run here (the JAX package's
library is built by tests/conftest.py)."""

import functools
import os

import numpy as np
import pytest

import vlnce_torch.tasks  # noqa: F401
import vlnce_tpu.tasks  # noqa: F401
from vlnce_torch import native
from vlnce_torch.config import get_config
from vlnce_torch.envs import ensure_registered, rl_envs  # noqa: F401
from vlnce_torch.envs import env_utils, shm_transport
from vlnce_torch.envs.env_utils import construct_envs, get_env_class
from vlnce_torch.envs.vector_env import VectorEnv
from vlnce_tpu.config import get_config as jax_get_config
from vlnce_tpu.envs import ensure_registered as jax_ensure_registered
from vlnce_tpu.envs import rl_envs as jax_rl_envs  # noqa: F401
from vlnce_tpu.envs import shm_transport as jax_shm_transport
from vlnce_tpu.envs.env_utils import construct_envs as jax_construct_envs
from vlnce_tpu.envs.env_utils import get_env_class as jax_get_env_class

ensure_registered()
jax_ensure_registered()

# 48x64 frames: u8 RGB 9216 bytes and f32 depth 12288 bytes, both above the
# schema's 4096-byte threshold, so both ride the ring; the small sensors and
# the infos stay on the pipes
OPTS = [
    "TASK_CONFIG.SIMULATOR.RGB_SENSOR.HEIGHT", 48, "TASK_CONFIG.SIMULATOR.RGB_SENSOR.WIDTH", 64,
    "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.HEIGHT", 48, "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.WIDTH", 64,
    "TASK_CONFIG.DATASET.TYPE", "Synthetic-VLN-v0", "TASK_CONFIG.DATASET.NUM_EPISODES", 9,
    "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", 5, "NUM_ENVIRONMENTS", 3,
    "TASK_CONFIG.TASK.SENSORS", ["INSTRUCTION_SENSOR", "SHORTEST_PATH_SENSOR", "VLN_ORACLE_PROGRESS_SENSOR"],
]


def _ring_name(tag):
    return f"{shm_transport.NAME_PREFIX}test_{tag}_{os.getpid()}"


# ------------------------------------------------- the cases of test_shm_transport.py
def test_schema_layout():
    template = {
        "rgb": np.zeros((32, 32, 3), np.uint8),
        "depth": np.zeros((32, 32, 1), np.float32),
        "tiny": np.zeros((2,), np.float32),  # below threshold -> pipe
    }
    schema = shm_transport.ObsSchema(template, min_bytes=1024)
    assert set(schema.fields) == {"rgb", "depth"}
    offsets = [v[0] for v in schema.fields.values()]
    assert all(o % 64 == 0 for o in offsets)
    assert schema.slot_bytes >= 32 * 32 * 3 + 32 * 32 * 4


def test_write_gather_roundtrip():
    rng = np.random.RandomState(0)
    template = {"rgb": np.zeros((16, 16, 3), np.uint8), "depth": np.zeros((16, 16, 1), np.float32)}
    schema = shm_transport.ObsSchema(template, min_bytes=16)
    ring = shm_transport.ObsRing(_ring_name("roundtrip"), 3, schema, create=True)
    try:
        frames = []
        for slot in range(3):
            obs = {
                "rgb": rng.randint(0, 255, (16, 16, 3), dtype=np.uint8),
                "depth": rng.rand(16, 16, 1).astype(np.float32),
                "small": np.array([slot], np.int32),
            }
            rest = ring.write_obs(slot, obs, sequence=1)
            assert "small" in rest and "rgb" not in rest
            frames.append(obs)
        ring.wait([0, 1, 2], 1)
        batch = ring.gather([0, 1, 2])
        for slot in range(3):
            np.testing.assert_array_equal(batch["rgb"][slot], frames[slot]["rgb"])
            np.testing.assert_array_equal(batch["depth"][slot], frames[slot]["depth"])
        # subset gather in arbitrary order
        batch2 = ring.gather([2, 0])
        np.testing.assert_array_equal(batch2["rgb"][0], frames[2]["rgb"])
        np.testing.assert_array_equal(batch2["rgb"][1], frames[0]["rgb"])
    finally:
        ring.close()


def test_sequence_publish_visibility():
    template = {"x": np.zeros((64,), np.float32)}
    schema = shm_transport.ObsSchema(template, min_bytes=16)
    ring = shm_transport.ObsRing(_ring_name("seq"), 1, schema, create=True)
    try:
        assert ring.lib.obs_ring_seq(ring.handle, 0) == 0
        ring.write_obs(0, {"x": np.arange(64, dtype=np.float32)}, sequence=7)
        assert ring.lib.obs_ring_seq(ring.handle, 0) == 7
        with pytest.raises(TimeoutError):
            ring.wait([0], 8, max_spins=1000)
    finally:
        ring.close()


# ------------------------------------------------------------- against JAX's
def test_schema_layout_equals_jax():
    rng = np.random.RandomState(3)
    template = {
        "rgb": np.zeros((48, 64, 3), np.uint8), "depth": np.zeros((48, 64, 1), np.float32),
        "rxr_instruction": np.zeros((37, 29), np.float32), "instruction": np.zeros((200,), np.int64),
        "progress": np.zeros((1,), np.float32), "odd": rng.rand(1001).astype(np.float32),
    }
    for min_bytes in (16, 1024, 4096):
        ours = shm_transport.ObsSchema(template, min_bytes=min_bytes)
        theirs = jax_shm_transport.ObsSchema(template, min_bytes=min_bytes)
        assert ours.fields == theirs.fields and list(ours.fields) == list(theirs.fields)
        assert ours.slot_bytes == theirs.slot_bytes


def test_ring_interoperates_with_jax_ring():
    """Same C ABI and layout: a slot the port writes is what the JAX ring
    gathers from the same segment."""
    assert jax_shm_transport.native_available()
    rng = np.random.RandomState(4)
    template = {"rgb": np.zeros((16, 16, 3), np.uint8), "depth": np.zeros((16, 16, 1), np.float32)}
    name = _ring_name("interop")
    ours = shm_transport.ObsRing(name, 2, shm_transport.ObsSchema(template, min_bytes=16), create=True)
    theirs = jax_shm_transport.ObsRing(name, 2, jax_shm_transport.ObsSchema(template, min_bytes=16), create=False)
    try:
        obs = {"rgb": rng.randint(0, 255, (16, 16, 3), dtype=np.uint8), "depth": rng.rand(16, 16, 1).astype(np.float32)}
        ours.write_obs(1, obs, sequence=3)
        theirs.wait([1], 3)
        got = theirs.gather([1])
        for k in obs:
            np.testing.assert_array_equal(got[k][0], obs[k])
    finally:
        theirs.close()
        ours.close()


# ------------------------------------------------------------------ failures
def test_oversized_arena_raises():
    """An arena larger than /dev/shm fails at the open (posix_fallocate
    after ftruncate), not with SIGBUS in a later memcpy."""
    st = os.statvfs("/dev/shm")
    total = st.f_blocks * st.f_frsize
    assert total > 0, "/dev/shm has no size limit here"
    schema = shm_transport.ObsSchema({"x": np.zeros(64, np.float32)}, min_bytes=16)
    schema.slot_bytes = 4 * total  # one slot four times the whole of /dev/shm
    with pytest.raises(OSError, match="/dev/shm may be too small"):
        shm_transport.ObsRing(_ring_name("huge"), 1, schema, create=True)


def test_build_failure_raises_with_the_compilers_output(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    bad = tmp_path / "obs_ring.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    assert not shm_transport.native_available()
    with pytest.raises(RuntimeError, match="obs_ring.cpp failed"):
        native.load()
    with pytest.raises(RuntimeError, match="obs_ring.cpp failed"):
        shm_transport.ObsRing(_ring_name("nobuild"), 1, shm_transport.ObsSchema({"x": np.zeros(64, np.float32)}, 16),
                              create=True)


# ------------------------------------------------------------------- the pool
def _pool(use_shm=None):
    """The forked pool of `construct_envs`, built with `VectorEnv(...,
    use_shm=use_shm)` where `use_shm` is given."""
    cfg = get_config(opts=["BASE_TASK_CONFIG_PATH", "vlnce_torch/tasks/config/vlnce_task.yaml"] + OPTS)
    with pytest.MonkeyPatch.context() as mp:
        if use_shm is not None:
            mp.setattr(env_utils, "VectorEnv", functools.partial(VectorEnv, use_shm=use_shm))
        envs = construct_envs(cfg, get_env_class("VLNCEDaggerEnv"))
    assert isinstance(envs, VectorEnv)
    return envs


def _assert_obs_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
        np.testing.assert_array_equal(a[k], b[k])


def _assert_steps_equal(ours, theirs):
    assert len(ours) == len(theirs)
    for (o, r, d, i), (jo, jr, jd, ji) in zip(ours, theirs):
        _assert_obs_equal(o, jo)
        assert (r, d) == (jr, jd)
        assert sorted(i) == sorted(ji)
        for k in i:
            np.testing.assert_array_equal(i[k], ji[k])


def test_pool_with_ring_equals_pipes_on_every_receive_path(monkeypatch):
    """Forked pools, one with the ring and one over pipes, same actions:
    bit-equal observations through reset, step, step_at, step_at_async +
    recv_at, reset_at, and step after pause_at and after resume_all."""
    monkeypatch.delenv("VLNCE_TORCH_THREADED_ENVS", raising=False)
    ring, pipes = _pool(True), _pool(False)
    try:
        _assert_steps_equal([(o, 0, False, {}) for o in ring.reset()], [(o, 0, False, {}) for o in pipes.reset()])
        assert ring.uses_shm and not pipes.uses_shm
        assert set(ring._ring.schema.fields) == {"rgb", "depth"}
        rng = np.random.RandomState(0)

        def acts(n):
            return [int(a) for a in rng.randint(1, 4, size=n)]

        for _ in range(3):
            a = acts(3)
            _assert_steps_equal(ring.step(a), pipes.step(a))
        a = acts(2)
        _assert_steps_equal(ring.step_at([2, 0], a), pipes.step_at([2, 0], a))
        a = acts(2)
        ring.step_at_async([0], a[:1]), pipes.step_at_async([0], a[:1])
        ring.step_at_async([1, 2], a[1:] + [3]), pipes.step_at_async([1, 2], a[1:] + [3])
        _assert_steps_equal(ring.recv_at([1, 2]), pipes.recv_at([1, 2]))
        _assert_steps_equal(ring.recv_at([0]), pipes.recv_at([0]))
        _assert_obs_equal(ring.reset_at(1)[0], pipes.reset_at(1)[0])
        # pause env 0: env 1 and 2 move to positions 0 and 1, their slots with them
        ring.pause_at(0), pipes.pause_at(0)
        assert ring._slot_of_conn == [1, 2]
        for _ in range(3):
            a = acts(2)
            _assert_steps_equal(ring.step(a), pipes.step(a))
        a = acts(1)
        _assert_steps_equal(ring.step_at([1], a), pipes.step_at([1], a))
        _assert_obs_equal(ring.reset_at(0)[0], pipes.reset_at(0)[0])
        ring.resume_all(), pipes.resume_all()
        assert ring._slot_of_conn == [0, 1, 2]
        for _ in range(4):
            a = acts(3)
            _assert_steps_equal(ring.step(a), pipes.step(a))
        assert [e.episode_id for e in ring.current_episodes()] == [e.episode_id for e in pipes.current_episodes()]
        name = ring._ring.name.decode()
    finally:
        ring.close(), pipes.close()
    assert not os.path.exists(f"/dev/shm/{name.lstrip('/')}")  # close unlinked the segment


def test_pool_with_ring_equals_jax_pool_with_ring(monkeypatch):
    monkeypatch.delenv("VLNCE_TORCH_THREADED_ENVS", raising=False)
    monkeypatch.delenv("VLNCE_TPU_THREADED_ENVS", raising=False)
    monkeypatch.delenv("VLNCE_TORCH_SHM_OBS", raising=False)
    monkeypatch.delenv("VLNCE_TPU_SHM_OBS", raising=False)
    assert jax_shm_transport.native_available()
    ours = _pool()
    theirs = jax_construct_envs(
        jax_get_config(opts=["BASE_TASK_CONFIG_PATH", "vlnce_tpu/tasks/config/vlnce_task.yaml"] + OPTS),
        jax_get_env_class("VLNCEDaggerEnv"),
    )
    try:
        for a, b in zip(ours.reset(), theirs.reset()):
            _assert_obs_equal(a, b)
        assert ours.uses_shm and theirs._ring is not None
        assert ours._ring.schema.fields == theirs._ring.schema.fields
        rng = np.random.RandomState(1)
        for _ in range(8):
            a = [int(x) for x in rng.randint(1, 4, size=3)]
            _assert_steps_equal(ours.step(a), theirs.step(a))
    finally:
        ours.close(), theirs.close()


@pytest.mark.parametrize("value,want", [(None, True), ("1", True), ("0", False)])
def test_env_variable_chooses_the_transport(monkeypatch, value, want):
    monkeypatch.delenv("VLNCE_TORCH_THREADED_ENVS", raising=False)
    if value is None:
        monkeypatch.delenv("VLNCE_TORCH_SHM_OBS", raising=False)
    else:
        monkeypatch.setenv("VLNCE_TORCH_SHM_OBS", value)
    envs = _pool()
    try:
        obs = envs.reset()
        assert envs.uses_shm is want
        (o, _, _, _), = envs.step_at([0], [1])
        assert o["rgb"].shape == obs[0]["rgb"].shape == (48, 64, 3)
    finally:
        envs.close()


@pytest.mark.parametrize("use_shm,variable", [(True, "0"), (False, "1")])
def test_constructor_argument_overrides_the_env_variable(monkeypatch, use_shm, variable):
    """`VectorEnv(use_shm=...)`, the JAX constructor's argument, wins over
    VLNCE_TORCH_SHM_OBS."""
    monkeypatch.delenv("VLNCE_TORCH_THREADED_ENVS", raising=False)
    monkeypatch.setenv("VLNCE_TORCH_SHM_OBS", variable)
    envs = _pool(use_shm)
    try:
        obs = envs.reset()
        assert envs.uses_shm is use_shm
        (o, _, _, _), = envs.step_at([1], [2])
        assert o["depth"].shape == obs[1]["depth"].shape
    finally:
        envs.close()


def test_small_sensors_keep_the_pipes(monkeypatch):
    """No sensor reaches min_bytes (24x32 frames): the JAX rule keeps the
    pipes, with no error."""
    monkeypatch.delenv("VLNCE_TORCH_THREADED_ENVS", raising=False)
    monkeypatch.delenv("VLNCE_TORCH_SHM_OBS", raising=False)
    cfg = get_config(opts=["BASE_TASK_CONFIG_PATH", "vlnce_torch/tasks/config/vlnce_task.yaml"] + OPTS + [
        "TASK_CONFIG.SIMULATOR.RGB_SENSOR.HEIGHT", 24, "TASK_CONFIG.SIMULATOR.RGB_SENSOR.WIDTH", 32,
        "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.HEIGHT", 24, "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.WIDTH", 32,
        "NUM_ENVIRONMENTS", 1])
    envs = construct_envs(cfg, get_env_class("VLNCEDaggerEnv"))
    try:
        envs.reset()
        assert not envs.uses_shm
        envs.step([1])
    finally:
        envs.close()
