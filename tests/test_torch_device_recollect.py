"""The port's recollection rendered on the device (data/device_recollect.py
and the dataset's and trainer's device modes) against the JAX package's, at
the small RxR CMA size on the CPU (tests/test_torch_recollection.py's cases:
48x64 frames resized to 32 and cropped to 32x32, 16 x 32-d instruction
features), where the port's captured render step runs eagerly and the
resize kernel's wrapper runs its plain version (the JAX side's Pallas
kernel in interpret mode).

- The wire path (CUDA.ON_DEVICE_RECOLLECT): the same episodes' frames with
  RGB equal, depth equal after the f16 round trip, progress within 1e-6,
  and prev / oracle / weights equal.
- The resident path (CUDA.RECOLLECT_RESIDENT): the batch on the device
  with its transforms, against JAX's unflattened one at the resize tests'
  tolerance: f32 atol 1e-5; u8 off by at most 1, and only where the
  summation order flips a rounding tie (the exact resize of the raw frame,
  computed in f32, lies within 1e-3 of x.5). Rendered frames have flat
  colours, so ties are denser than in the random images of
  tests/test_torch_ops_preprocess.py.
- The recollect trainer trains to a checkpoint in each mode without an env
  pool, and the resident losses equal the wire losses at f16 tolerance
  (rtol 2e-3, atol 1e-4), as tests/test_trainers.py holds the JAX package's.
"""

import gzip
import json

import numpy as np
import pytest
import torch

import vlnce_tpu.models  # noqa: F401
import vlnce_tpu.tasks  # noqa: F401
import vlnce_torch.models.cma_policy  # noqa: F401
import vlnce_torch.tasks  # noqa: F401
import vlnce_torch.trainers  # noqa: F401
from vlnce_tpu.data.recollection import TeacherRecollectionDataset as JaxDataset
from vlnce_tpu.ops.obs_transforms import get_active_obs_transforms as jax_get_transforms
from vlnce_tpu.tasks.datasets import make_dataset as jax_make_dataset
from vlnce_tpu.trainers import device_recollect as jax_recollect
from vlnce_torch.data import device_recollect, recollection
from vlnce_torch.ops.obs_transforms import apply_obs_transforms_batch, get_active_obs_transforms
from vlnce_torch.registry import registry
from vlnce_torch.tasks.datasets import make_dataset
from vlnce_torch.utils.checkpoints import load_checkpoint

from tests.test_torch_recollection import EPISODES, _collector, _config, _jax_config

INSTR = "rxr_instruction"


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """Both packages' configs (no checkpoint to load), the GT trajectories
    of the shortest-path oracle, and the same episodes of each package."""
    tmp = tmp_path_factory.mktemp("device_recollect")
    jcfg, cfg = _jax_config(tmp / "jax", "none"), _config(tmp / "torch", "none")
    trajectories = _collector(JaxDataset, jcfg).collect_dataset()
    trajectories = json.loads(json.dumps(trajectories))
    jeps = list(jax_make_dataset(jcfg.TASK_CONFIG.DATASET.TYPE, jcfg.TASK_CONFIG.DATASET).episodes)
    eps = list(make_dataset(cfg.TASK_CONFIG.DATASET.TYPE, cfg.TASK_CONFIG.DATASET).episodes)
    assert [e.episode_id for e in eps] == [e.episode_id for e in jeps] and len(eps) == EPISODES
    return {"tmp": tmp, "jcfg": jcfg, "cfg": cfg, "trajectories": trajectories, "jeps": jeps, "eps": eps}


def test_wire_render_matches_jax(case):
    """Four episodes in one chunk (T_pad a multiple of 8, the tails STOP):
    the frames and the IL columns of every episode, then the chunk's graph
    reused by a second chunk of the same shape."""
    coef = 3.2
    cache = {}
    for lo in (0, 2):
        jeps, eps = case["jeps"][lo : lo + 4], case["eps"][lo : lo + 4]
        ref = jax_recollect.render_gt_episodes_on_device(case["jcfg"], jeps, case["trajectories"], coef, instr_uuid=INSTR)
        got = device_recollect.render_gt_episodes_on_device(case["cfg"], eps, case["trajectories"], coef, instr_uuid=INSTR,
                                                            cache=cache)
        assert len(got) == len(ref) == 4 and len(cache) == 1
        for (obs, prev, oracle, weights), (r_obs, r_prev, r_oracle, r_weights), ep in zip(got, ref, eps):
            T_ep = len(case["trajectories"][ep.episode_id])
            assert sorted(obs) == sorted(r_obs) == ["depth", "progress", "rgb", INSTR]
            assert obs["rgb"].shape == (T_ep, 48, 64, 3) and obs["rgb"].dtype == np.uint8
            assert obs["depth"].shape == (T_ep, 48, 64, 1) and obs["depth"].dtype == np.float32
            np.testing.assert_array_equal(obs["rgb"], r_obs["rgb"])
            np.testing.assert_array_equal(obs["depth"], r_obs["depth"])  # both went through f16
            np.testing.assert_array_equal(obs[INSTR], r_obs[INSTR])
            np.testing.assert_allclose(obs["progress"], r_obs["progress"], atol=1e-6)
            for a, b in ((prev, r_prev), (oracle, r_oracle), (weights, r_weights)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def test_resident_batch_matches_jax(case):
    """One training batch of 3 episodes rendered with the RxR transforms
    inside the step, time-major, T_pad a multiple of 16."""
    coef = 3.2
    jeps, eps = case["jeps"][1:4], case["eps"][1:4]
    *ref, shapes = jax_recollect.render_gt_batch_resident(case["jcfg"], jeps, case["trajectories"], coef, instr_uuid=INSTR,
                                                          transforms=jax_get_transforms(case["jcfg"]))
    obs, *rest = device_recollect.render_gt_batch_resident(case["cfg"], eps, case["trajectories"], coef, instr_uuid=INSTR,
                                                           transforms=get_active_obs_transforms(case["cfg"]))
    r_obs = {k: np.asarray(v) for k, v in ref[0].items()}
    T_pad = rest[0].shape[0]
    # the exact (unrounded) resized RGB: the raw frames of the same batch, transformed in f32
    raw = device_recollect.render_gt_batch_resident(case["cfg"], eps, case["trajectories"], coef, instr_uuid=INSTR)[0]
    exact = apply_obs_transforms_batch({"rgb": raw["rgb"].reshape((-1,) + tuple(raw["rgb"].shape[2:])).float()},
                                       get_active_obs_transforms(case["cfg"]))["rgb"].reshape(obs["rgb"].shape).numpy()
    assert T_pad % 16 == 0 and T_pad >= max(len(case["trajectories"][e.episode_id]) for e in eps)
    assert sorted(obs) == sorted(r_obs) == ["depth", "progress", "rgb", INSTR]
    for k, v in obs.items():
        v = v.numpy()
        want = r_obs[k].reshape((T_pad, 3) + tuple(shapes.get(k, r_obs[k].shape[2:])))
        assert v.shape == want.shape and v.dtype == want.dtype, k
        if v.dtype == np.uint8:
            diff = np.abs(v.astype(np.int32) - want.astype(np.int32))
            tie = np.abs(exact - np.floor(exact) - 0.5) < 1e-3
            assert diff.max() <= 1 and not (diff > 0)[~tie].any(), k
            assert (diff == 0).mean() > 0.99, k
        else:
            np.testing.assert_allclose(v, want, atol=1e-5, err_msg=k)
    assert obs["rgb"].shape[2:] == (32, 32, 3) and obs["depth"].shape[2:] == (32, 32, 1)
    for a, b in zip(rest, ref[1:]):  # prev, masks, corrected, weights
        np.testing.assert_array_equal(a, np.asarray(b))


def _trainer_run(case, mode, monkeypatch):
    """One epoch of the recollect trainer from the seeded weights in `mode`,
    recording every accumulation step's losses."""
    def no_pool(*args, **kwargs):
        raise AssertionError("the env pool was constructed")

    monkeypatch.setattr(recollection, "construct_envs", no_pool)
    extra = ["CUDA.ON_DEVICE_RECOLLECT", True] + (["CUDA.RECOLLECT_RESIDENT", True] if mode == "resident" else [])
    tmp = case["tmp"] / mode
    trajectories = tmp / "trajectories.json.gz"
    tmp.mkdir()
    with gzip.open(trajectories, "wt") as f:
        json.dump(case["trajectories"], f)
    cfg = _config(tmp, "none", extra + ["IL.load_from_ckpt", False, "IL.RECOLLECT_TRAINER.preload_trajectories_file", True,
                                        "IL.RECOLLECT_TRAINER.trajectories_file", str(trajectories)])
    trainer = registry.get_trainer("recollect_trainer")(cfg)
    trainer.train()
    return trainer, tmp


@pytest.fixture(scope="module")
def runs(case):
    patch = pytest.MonkeyPatch()
    try:
        return {mode: _trainer_run(case, mode, patch) for mode in ("wire", "resident")}
    finally:
        patch.undo()


@pytest.mark.parametrize("mode", ["wire", "resident"])
def test_recollect_trainer_trains_on_device(runs, mode):
    """No env pool; three batches of two (two accumulated per Adam step);
    the epoch's checkpoint with its step count and optimizer state."""
    trainer, tmp = runs[mode]
    assert trainer._resident == (mode == "resident")
    assert len(trainer.loss_history) == 3 and np.isfinite(np.array([h[1:] for h in trainer.loss_history])).all()
    assert trainer.resimulation["episodes"] >= EPISODES and trainer.resimulation["env_steps"] > 0
    ckpt = load_checkpoint(str(tmp / "checkpoints" / "ckpt.0.ckpt"))
    assert ckpt["extra_state"] == {"epoch": 0, "step_id": 3} and len(ckpt["optim_state"]["state"]) > 0
    assert all(torch.equal(ckpt["state_dict"][k], v) for k, v in trainer.policy.state_dict().items())


def test_resident_losses_match_wire_losses(runs):
    """The same batches rendered resident or through the wire: the wire
    quantizes depth through f16 and the resident path keeps it exact, so the
    losses agree at that tolerance."""
    wire, resident = (np.array([h[1:] for h in runs[m][0].loss_history]) for m in ("wire", "resident"))
    np.testing.assert_allclose(resident, wire, rtol=2e-3, atol=1e-4)
    assert runs["wire"][0].train_lengths == runs["resident"][0].train_lengths  # the same padded T per batch
