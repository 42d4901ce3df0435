"""The plain reference against the program at small sizes on the CPU: the
weights' names and shapes, the renderer, the dynamics, the resize, and
whole runs of both cells, which must come out correct (and the rollout's
STOP-suppressed head must never stop)."""

import math

import numpy as np
import pytest
import torch

from benchmark import harness, program
from benchmark.reference import cma, grid
from benchmark.tests import small


@pytest.mark.parametrize("workload", ["rxr_cma.scan_rollout", "r2r_cma.dagger_train"])
def test_spec_is_the_programs_state_dict(workload):
    from vlnce_torch.registry import registry

    c = harness.load_cell(workload, seed=1, seconds=0.0, trace=False)
    config = harness.program_config(c, {"CUDA.DEVICE": "cpu"})
    program._registries()
    trainer = registry.get_trainer(config.TRAINER_NAME)(config)
    from vlnce_torch.ops.obs_transforms import get_active_obs_transforms

    trainer.obs_transforms = get_active_obs_transforms(config)
    obs, act = trainer._get_spaces(config)
    with torch.device("meta"):
        policy = registry.get_policy(config.MODEL.policy_name)(config, obs, int(act.n))
    theirs = {k: tuple(v.shape) for k, v in policy.state_dict().items()}
    ours = {name: tuple(shape) for name, shape, _, _ in cma.param_spec(program.arch(config))}
    assert ours == theirs


def _poses(n, seed=0):
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.choice([1.0, 3.0, 5.25, 7.0], n), np.zeros(n), rng.choice([1.0, 9.0, 11.25, 15.0], n)], 1)
    return torch.tensor(pos, dtype=torch.float32), torch.tensor(rng.uniform(0, 2 * math.pi, n), dtype=torch.float32)


def test_render_and_step_equal_the_programs():
    from vlnce_torch.envs import device_sim

    ids = [f"bench_scene_{i}" for i in range(3)]
    sc = grid.scene_batch(ids, "cpu")
    theirs = device_sim.SceneBatch(**device_sim.upload(device_sim.scene_arrays([_Ep(i) for i in ids]), "cpu"))
    assert torch.equal(sc["occupancy"], theirs.occupancy) and torch.equal(sc["wall_colors"], theirs.wall_colors)
    pos, heading = _poses(3)
    tilt = torch.tensor([0.0, 0.5, -0.3])
    for kind, hw in (("rgb", (30, 40)), ("depth", (24, 32))):
        cam = {"uuid": kind, "height": hw[0], "width": hw[1], "hfov": 79.0, "kind": kind, "min_depth": 0.5,
               "max_depth": 5.0, "normalize": True}
        spec = device_sim.CameraSpec(kind, hw[0], hw[1], 79.0, 0.0, kind, 0.5, 5.0, True)
        ours = grid.render(sc, pos, heading, tilt, cam)
        assert torch.equal(ours, device_sim.render_batch(theirs, pos, heading, [spec], tilt=tilt)[kind])
    for sliding in (False, True):
        for a in range(6):
            action = torch.full((3,), a)
            p, h, t = grid.step(sc["occupancy"], pos, heading, tilt, action, 0.25, math.radians(30), math.radians(30), sliding)
            p2, h2 = device_sim.step_batch(theirs, pos, heading, action.to(torch.int32), 0.25, math.radians(30), sliding)
            assert torch.equal(p, p2) and torch.equal(h, h2)
            assert torch.equal(t, device_sim.step_tilt(tilt, action.to(torch.int32), math.radians(30)))


class _Ep:
    def __init__(self, scene):
        self.scene_id, self.goals, self.start_position, self.info = scene, [_Goal()], [1.0, 0.0, 1.0], {"geodesic_distance": 1.0}


class _Goal:
    position = [3.0, 0.0, 3.0]


def test_resize_and_heading_equal_the_programs():
    from vlnce_torch.ops.obs_transforms import ResizeShortestEdge
    from vlnce_torch.tasks.geometry import heading_from_quaternion

    g = torch.Generator().manual_seed(3)
    rgb = torch.randint(0, 256, (2, 48, 64, 3), generator=g, dtype=torch.uint8)
    depth = torch.rand(2, 48, 64, 1, generator=g)
    theirs = ResizeShortestEdge(20)({"rgb": rgb, "depth": depth})
    # u8 rounds half to even on either side: a sum in another order may land a
    # value of .5 on the other side
    diff = (grid.resize_shortest_edge(rgb, 20).int() - theirs["rgb"].int()).abs()
    assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) < 0.01
    assert torch.allclose(grid.resize_shortest_edge(depth, 20), theirs["depth"], rtol=0, atol=1e-5)
    for h in (0.0, 0.3, 2.0, 4.5, 6.2):
        q = [0.0, math.sin(h / 2), 0.0, math.cos(h / 2)]
        assert grid.heading_from_quaternion(q) == heading_from_quaternion(np.asarray(q))


def test_small_rollout_is_correct_and_never_stops():
    out, compared, correct = small.run("rxr_cma.scan_rollout")
    assert correct, compared
    assert compared["stopped_early"]["value"] == 0 and out["failed"] == 0
    assert out["attempted"] == small.SCAN_OPTS["EVAL.SCAN_BATCH"]
    assert out["ctx"]["env_steps"] == out["attempted"] * small.SCAN_OPTS["TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS"]


def test_small_training_is_correct():
    out, compared, correct = small.run("r2r_cma.dagger_train")
    assert correct, compared
    assert out["ctx"]["frames"] == 3 * 10 + 5 * 10 + 17 * 5  # one whole epoch of the small bank

