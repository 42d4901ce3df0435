"""The goal fields of the closed loops on the card (ops/goal_field and
envs/device_sim.scene_batch) against the JAX package's host Dijkstra
(vlnce_tpu.envs.gridworld, `BaseScene.distance_field`), on the CPU.

- The plain relaxation equals the JAX package's field bit for bit, in f64
  and in its f32 cast, +inf cells included: on 24 procedural scenes, goals
  on blocked cells (snapped), an enclosed pocket, imported grids whose side
  is not 64 (one above the kernel's shared-memory limit).
- `build_scene_batch` and the on-card DAgger's expert field equal the
  route they replace, a host Dijkstra per goal (`_host_route` below, on the
  JAX package's fields): chunks that mix grid sizes (+inf padding), episodes
  with several goals (their minimum), a chunk of 64 episodes that repeat
  goals, d0 with and without the annotation.
- The host fields that the card tests in tests/test_torch_kernels.py hold
  the kernel to (the port's `BaseScene._dijkstra`, since the card has no
  JAX) equal the JAX package's, case by case.
- The wrapper's counters: a call per chunk on the CPU, and no launch; a
  chunk's distinct goals, one field each.

The kernel itself runs only on the card: tests/test_torch_kernels.py holds
it against the plain version and the host there.
"""

import math

import numpy as np
import pytest
import torch

from tests.test_torch_kernels import GOAL_FIELD_CARD_CASES, _field_batch
from tests.torch_port_cases import SceneRegistrySnapshot
from vlnce_tpu.envs import gridworld as jax_gridworld, scene_import as jax_scene_import
from vlnce_torch.envs import device_sim as ds
from vlnce_torch.envs.device_sim import chunk_tensors
from vlnce_torch.envs.gridworld import _RES, GridWorldScene, get_scene, register_scene
from vlnce_torch.envs.scene_import import ImportedScene, scene_from_graph
from vlnce_torch.ops.goal_field import goal_distance_fields, goal_distance_fields_plain, shared_bytes
from vlnce_torch.trainers import device_dagger
from vlnce_torch.utils.nav_graph import synthetic_lattice_graph

SCENES = [f"goal_field_scene_{k}" for k in range(24)]


def _jax_scene(scene):
    """The JAX package's scene of the port's `scene`: its own procedural
    scene of the same id (the same grid), else an imported scene over the
    grid, with an empty field cache."""
    if isinstance(scene, GridWorldScene):
        jax_scene = jax_gridworld.get_scene(scene.scene_id)
        assert np.array_equal(jax_scene.occupancy, scene.occupancy)
        return jax_scene
    return jax_scene_import.ImportedScene(scene.scene_id, scene.occupancy, scene.origin)


def _jax_field(scene, cell):
    """The JAX package's host Dijkstra field of the goal `cell` on `scene`."""
    return _jax_scene(scene).distance_field(tuple(int(v) for v in cell))


def _host_fields(scene, cells):
    """The JAX package's host fields of `cells` on `scene`."""
    return np.stack([_jax_field(scene, c) for c in cells])


def _plain_fields(scenes, cells):
    """The plain relaxation of each (scene, cell), its grid a row of one batch."""
    occ = torch.from_numpy(np.stack([s.occupancy for s in scenes]))
    rows = [(k, *s.snap_goal_cell(*c)) for k, (s, c) in enumerate(zip(scenes, cells))]
    return goal_distance_fields_plain(occ, torch.tensor(rows, dtype=torch.int32), _RES).numpy()


def _assert_bitwise(got, want):
    assert got.dtype == np.float64 and got.shape == want.shape
    assert np.array_equal(got, want)
    assert np.array_equal(got.astype(np.float32), want.astype(np.float32))
    assert np.array_equal(np.isinf(got), np.isinf(want))


@pytest.mark.parametrize("scene_id", SCENES)
def test_plain_fields_equal_host_dijkstra(scene_id):
    """Three goals a scene, one of them on a blocked cell (the host snaps it
    to the nearest free cell, with its tie-break)."""
    scene = get_scene(scene_id)
    rng = np.random.RandomState(SCENES.index(scene_id))
    free, blocked = np.argwhere(~scene.occupancy), np.argwhere(scene.occupancy)
    cells = [tuple(int(v) for v in free[rng.randint(len(free))]) for _ in range(2)]
    cells.append(tuple(int(v) for v in blocked[rng.randint(len(blocked))]))
    assert not scene.navigable_cell(*cells[2])
    _assert_bitwise(_plain_fields([scene] * 3, cells), _host_fields(scene, cells))


def _pocket_scene(scene_id):
    """A 64 x 64 grid with a free room walled off from the rest."""
    occ = get_scene("goal_field_scene_0").occupancy.copy()
    occ[20:30, 20:30] = True
    occ[22:28, 22:28] = False
    return ImportedScene(scene_id, occ, (2.5, -4.0))


def test_enclosed_pocket_is_unreachable():
    scene = _pocket_scene("goal_field_pocket")
    outside, inside = (4, 4), (24, 25)
    got = _plain_fields([scene, scene], [outside, inside])
    _assert_bitwise(got, _host_fields(scene, [outside, inside]))
    assert np.isinf(got[0, 22:28, 22:28]).all() and np.isfinite(got[0, 4, 5])
    assert np.isfinite(got[1, 22:28, 22:28]).all() and np.isinf(got[1, 4, 4])


@pytest.mark.parametrize("world", [20.0, 44.0])
def test_imported_grids_equal_host_dijkstra(world):
    """Rasterised lattice graphs (envs/scene_import): 80 x 80, and 176 x 176,
    above the kernel's shared-memory limit (the same relaxation there)."""
    scene = scene_from_graph(f"goal_field_lattice_{int(world)}", synthetic_lattice_graph(world_size=world))
    assert scene.n != 64 and (shared_bytes(scene.n) == 0) == (world > 40)
    free = np.argwhere(~scene.occupancy)
    cells = [tuple(int(v) for v in free[k]) for k in (0, len(free) // 2, len(free) - 1)] + [(0, 0)]
    _assert_bitwise(_plain_fields([scene] * 4, cells), _host_fields(scene, cells))


class _Goal:
    def __init__(self, position):
        self.position = position


class _Episode:
    def __init__(self, scene_id, start, goals, d0=None):
        self.scene_id, self.start_position = scene_id, list(start)
        self.start_rotation = [0.0, 0.0, 0.0, 1.0]
        self.goals = [_Goal(list(g)) for g in goals]
        self.info = {"geodesic_distance": d0} if d0 else {}


def _host_route(episodes):
    """SceneBatch's arrays as the host built them: each goal's Dijkstra
    field (the JAX package's), their minimum per episode, padded to the largest grid with +inf;
    d0 annotated, else the field at the start cell (at least 1e-6); and each
    episode's first goal's field, the on-card DAgger's expert field."""
    fields, firsts, d0s = [], [], []
    for ep in episodes:
        scene = get_scene(ep.scene_id)
        per_goal = [_jax_field(scene, scene.world_to_cell(float(g.position[0]), float(g.position[-1])))
                    for g in ep.goals]
        field = np.minimum.reduce(per_goal)
        fields.append(field.astype(np.float32))
        firsts.append(per_goal[0].astype(np.float32))
        si, sj = scene.world_to_cell(float(ep.start_position[0]), float(ep.start_position[-1]))
        d0 = float(ep.info.get("geodesic_distance") or 0.0)
        d0s.append(d0 if d0 > 0.0 else max(float(field[si, sj]), 1e-6))
    n = max(f.shape[0] for f in fields)
    return {
        "goal_field": np.stack([ds._pad_grid(f, n, np.inf) for f in fields]),
        "first_goal_field": np.stack([ds._pad_grid(f, n, np.inf) for f in firsts]),
        "d0": np.array(d0s, np.float32),
        "occupancy": np.stack([ds._pad_grid(get_scene(ep.scene_id).occupancy, n, True) for ep in episodes]),
    }


def _free_point(scene, rng):
    i, j = np.argwhere(~scene.occupancy)[rng.randint(int((~scene.occupancy).sum()))]
    x, z = scene.cell_to_world(int(i), int(j))
    return [x, 0.0, z]


def _blocked_point(scene, rng):
    i, j = np.argwhere(scene.occupancy)[rng.randint(int(scene.occupancy.sum()))]
    x, z = scene.cell_to_world(int(i), int(j))
    return [x, 0.0, z]


def _check_batch(episodes):
    want = _host_route(episodes)
    got = ds.build_scene_batch(episodes)
    for name in ("goal_field", "d0", "occupancy"):
        g = getattr(got, name).numpy()
        assert g.dtype == want[name].dtype and np.array_equal(g, want[name]), name
    return got, want


def test_scene_batch_mixes_grid_sizes_and_several_goals():
    """A procedural 64 x 64 scene, an imported 80 x 80 one away from the
    origin and the walled pocket, padded to 80 with +inf; episodes of one to
    three goals (one on a blocked cell, one in the pocket out of reach), d0
    from the field and annotated."""
    rng = np.random.RandomState(3)
    with SceneRegistrySnapshot():
        lattice = scene_from_graph("goal_field_lattice_offset", synthetic_lattice_graph(world_size=20.0))
        imported = ImportedScene("goal_field_lattice_offset", lattice.occupancy, (3.5, -2.25))
        pocket = _pocket_scene("goal_field_pocket")
        for scene in (imported, pocket):
            register_scene(scene)
        proc = get_scene(SCENES[1])
        episodes = [
            _Episode(SCENES[1], _free_point(proc, rng), [_free_point(proc, rng)]),
            _Episode(SCENES[1], _free_point(proc, rng), [_free_point(proc, rng), _blocked_point(proc, rng),
                                                          _free_point(proc, rng)]),
            _Episode(imported.scene_id, _free_point(imported, rng), [_free_point(imported, rng)], d0=7.25),
            _Episode(imported.scene_id, _free_point(imported, rng), [_free_point(imported, rng),
                                                                     _free_point(imported, rng)]),
            _Episode(pocket.scene_id, [5.0, 0.0, -2.5], [[8.75, 0.0, 2.5]]),  # a goal in the pocket, the start outside
            _Episode(pocket.scene_id, [5.0, 0.0, -2.5], [[8.75, 0.0, 2.5], [3.75, 0.0, -1.5]]),
        ]
        got, want = _check_batch(episodes)
    assert got.goal_field.shape == (6, 80, 80) and np.isinf(want["goal_field"][0, 64:, :]).all()
    assert np.isinf(want["d0"][4]) and np.isfinite(want["d0"][5]) and want["d0"][2] == np.float32(7.25)


def test_scene_batch_of_64_episodes_repeating_goals():
    """A chunk of 64 episodes on 8 scenes whose goals repeat: one field per
    distinct (scene, snapped cell), each episode's the host's."""
    rng = np.random.RandomState(9)
    goals = {s: [_free_point(get_scene(s), rng) for _ in range(3)] + [_blocked_point(get_scene(s), rng)]
             for s in SCENES[:8]}
    episodes = []
    for k in range(64):
        s = SCENES[k % 8]
        picks = rng.choice(4, size=1 + k % 3, replace=False)
        episodes.append(_Episode(s, _free_point(get_scene(s), rng), [goals[s][p] for p in picks],
                                 d0=None if k % 4 else 3.5))
    inputs = ds.scene_inputs(episodes)
    distinct = {(ep.scene_id, get_scene(ep.scene_id).snap_goal_cell(
        *get_scene(ep.scene_id).world_to_cell(g.position[0], g.position[-1]))) for ep in episodes for g in ep.goals}
    assert len(inputs["field_cells"]) == len(distinct) <= 32
    assert inputs["goal_index"].shape == (64, 3) and (inputs["goal_index"][0::3, 1:] == len(distinct)).all()
    _check_batch(episodes)


def _loop_task_config():
    from vlnce_torch.config import get_config

    return get_config("vlnce_torch/config/experiments/r2r_baselines/cma_pm_da_aug_tune.yaml").TASK_CONFIG


def test_chunk_tensors_and_the_dagger_expert_field_equal_the_host_route():
    """`chunk_tensors` (the scan loop's and the on-card DAgger's set-up) and
    the DAgger expert's first-goal field, against the host route."""
    rng = np.random.RandomState(5)
    episodes = []
    for k in range(6):
        scene = get_scene(SCENES[k % 3])
        goals = [_free_point(scene, rng) for _ in range(1 + k % 2)]
        episodes.append(_Episode(scene.scene_id, _free_point(scene, rng), goals, d0=None if k % 2 else 2.0))
    for ep in episodes:
        ep.instruction = type("Instruction", (), {"instruction_tokens": [3, 4, 5]})()
    want = _host_route(episodes)
    scenes, tensors = chunk_tensors(episodes, "instruction", _loop_task_config(), "cpu",
                                    {"goal_xz": device_dagger._goal_xz(episodes)})
    assert np.array_equal(scenes.goal_field.numpy(), want["goal_field"])
    assert np.array_equal(scenes.d0.numpy(), want["d0"])
    assert np.array_equal(device_dagger._expert_field(tensors).numpy(), want["first_goal_field"])
    xz = np.array([[ep.goals[0].position[0], ep.goals[0].position[-1]] for ep in episodes], np.float32)
    assert np.array_equal(tensors["goal_xz"].numpy(), xz)


def test_counters_count_a_call_per_chunk_and_a_field_per_distinct_goal():
    """On the CPU a chunk's set-up calls the wrapper once and launches
    nothing (the kernel's `launches` and `fields` count on the card, in
    tests/test_torch_kernels.py); the call builds one field per distinct goal."""
    rng = np.random.RandomState(2)
    chunks = []
    for c in range(2):
        scene = get_scene(SCENES[c])
        shared = _free_point(scene, rng)
        chunks.append([_Episode(scene.scene_id, _free_point(scene, rng), [shared, _free_point(scene, rng)])
                       for _ in range(3)])
    before = goal_distance_fields.calls, goal_distance_fields.launches, goal_distance_fields.fields
    for chunk in chunks:
        inputs = ds.scene_inputs(chunk)
        assert len(inputs["field_cells"]) == 4  # the shared goal once, and three others a chunk
        _, fields = ds.scene_batch(ds.upload(inputs, "cpu"))
        assert fields.shape[0] == 4 + 1  # and the +inf row of "no goal"
    after = goal_distance_fields.calls, goal_distance_fields.launches, goal_distance_fields.fields
    assert tuple(a - b for a, b in zip(after, before)) == (2, 0, 0)


@pytest.mark.parametrize("case", sorted(GOAL_FIELD_CARD_CASES))
def test_card_cases_host_fields_equal_jax(case):
    """The card tests hold the kernel to the port's host Dijkstra, as the
    card has no JAX; here those fields equal the JAX package's, bit for bit."""
    scenes, per_scene, seed = GOAL_FIELD_CARD_CASES[case]()
    occ, cells, port = _field_batch(scenes, per_scene, seed)
    _, cells_jax, jax_fields = _field_batch(scenes, per_scene, seed, host=_jax_field)
    assert torch.equal(cells, cells_jax)
    _assert_bitwise(port, jax_fields)
    _assert_bitwise(goal_distance_fields_plain(occ, cells, _RES).numpy(), jax_fields)


def test_wrapper_rejects_bad_inputs():
    occ = torch.zeros(2, 8, 8, dtype=torch.bool)
    cells = torch.tensor([[0, 1, 1]], dtype=torch.int32)
    with pytest.raises(ValueError, match="occupancy must be bool"):
        goal_distance_fields(occ.to(torch.uint8), cells, _RES)
    with pytest.raises(ValueError, match="occupancy must be bool"):
        goal_distance_fields(torch.zeros(2, 8, 9, dtype=torch.bool), cells, _RES)
    with pytest.raises(ValueError, match="cells must be int32"):
        goal_distance_fields(occ, cells.long(), _RES)
    field = goal_distance_fields(occ, cells, _RES)
    assert field[0, 1, 1] == 0.0 and field[0, 1, 2] == _RES and field[0, 2, 2] == math.sqrt(2.0) * _RES
