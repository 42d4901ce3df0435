"""The JAX package's checkpoints read by the port: its msgpack reader against
flax, the params and optax's Adam state of a JAX `save_checkpoint` file
through `load_checkpoint`, an IL requeue that resumes Adam from such a file,
and the port's `ckpt_to_interrupted_state` on it. (The eval of a directory of
JAX checkpoints is in tests/test_torch_eval.py.)"""

import jax
import numpy as np
import pytest
import torch
from flax import serialization

import vlnce_torch.models.cma_policy  # noqa: F401
import vlnce_torch.tasks  # noqa: F401
import vlnce_torch.trainers  # noqa: F401
from vlnce_torch.envs import ensure_registered
from vlnce_torch.envs import rl_envs  # noqa: F401
from vlnce_torch.models.convert import load_policy_state_dict, state_dict_from_jax_params
from vlnce_torch.registry import registry
from vlnce_torch.utils.checkpoints import CHECKPOINT_SUFFIXES, config_from_checkpoint, load_checkpoint, save_checkpoint
from vlnce_torch.utils.msgpack_reader import unpackb
from vlnce_tpu.parallel.optim import masked_adam as jax_masked_adam
from vlnce_tpu.parallel.optim import trainable_mask as jax_trainable_mask
from vlnce_tpu.utils.checkpoints import save_checkpoint as jax_save_checkpoint

from tests.torch_port_cases import build_pair, configs

ensure_registered()

NO_TABLE = ["MODEL.INSTRUCTION_ENCODER.use_pretrained_embeddings", False]
LR = 1e-3


def _same_tree(ref, got, path=""):
    """flax's restore and the port's reader give the same tree: the same keys
    in the same order, the same Python types and values, arrays equal in
    shape, dtype and value (a bfloat16 array comes back as float32)."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and list(got) == list(ref), path
        for k in ref:
            _same_tree(ref[k], got[k], f"{path}/{k}")
    elif isinstance(ref, list):
        assert isinstance(got, list) and len(got) == len(ref), path
        for i, (r, g) in enumerate(zip(ref, got)):
            _same_tree(r, g, f"{path}[{i}]")
    elif isinstance(ref, np.ndarray):
        assert isinstance(got, np.ndarray) and got.shape == ref.shape, path
        if ref.dtype.name == "bfloat16":
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, ref.astype(np.float32), err_msg=path)
        else:
            assert got.dtype == ref.dtype and got.flags.writeable, path
            np.testing.assert_array_equal(got, ref, err_msg=path)
    else:
        assert type(got) is type(ref) and got == ref, (path, ref, got)


def test_msgpack_reader_matches_flax(monkeypatch):
    import jax.numpy as jnp

    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 256)  # arrays over 256 bytes are written in chunks
    rng = np.random.RandomState(0)
    tree = {
        "nil": None, "yes": True, "no": False, "float": -2.75, "complex": 1.5 - 2j,
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, 2**63 - 1, 2**64 - 1,
                 -1, -32, -33, -128, -129, -2**15 - 1, -2**31 - 1, -2**63],
        "str": ["", "x" * 31, "y" * 32, "z" * 300, "été" * 30000],
        "bin": [b"", b"\x00\xff" * 200, bytes(70000)],
        "scalars": {"f32": np.float32(3.5), "i64": np.int64(-7), "u8": np.uint8(200), "b": np.bool_(True)},
        "arrays": {
            "f32": rng.randn(3, 4).astype(np.float32), "f64": rng.randn(2).astype(np.float64),
            "i8": rng.randint(-128, 127, (5, 2)).astype(np.int8), "bool": rng.rand(7) > 0.5,
            "empty": np.zeros((2, 0), np.float32), "scalar": np.array(1.25, np.float16),
            "bf16": np.asarray(jnp.asarray(rng.randn(6), jnp.bfloat16)),
        },
        "chunked": {"f32": rng.randn(10, 9).astype(np.float32), "u16": np.arange(500, dtype=np.uint16)},
        "deep": {str(i): {"leaf": np.full((i + 1,), i, np.int32)} for i in range(20)},
        "list": list(range(40)), "empty": {},
    }
    blob = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in blob
    _same_tree(serialization.msgpack_restore(blob), unpackb(blob))
    with pytest.raises(ValueError, match="trailing"):
        unpackb(blob + b"\xc0")


@pytest.fixture(scope="module")
def jax_file(tmp_path_factory):
    """RxR CMA params and masked Adam's state after two steps of seeded
    gradients, written by the JAX package's `save_checkpoint`; and the
    gradient of a third step, for both packages to take. The frozen leaves'
    gradients are zeros, as the JAX trainer's are (optax.masked passes a
    masked leaf's update through as it is)."""
    (_, _, params), _, _ = build_pair(seed=5, extra=NO_TABLE)
    jcfg, _ = configs(NO_TABLE)
    tx = jax_masked_adam(LR, params, jcfg.MODEL)
    mask = jax_trainable_mask(params, jcfg.MODEL)
    state = tx.init(params)
    rng = np.random.RandomState(6)

    def grads():
        return jax.tree_util.tree_map(
            lambda p, m: rng.randn(*np.shape(p)).astype(np.float32) * np.float32(m), params, mask)

    for _ in range(2):
        updates, state = tx.update(grads(), state, params)
        params = jax.tree_util.tree_map(lambda p, u: np.asarray(p + u), params, updates)
    g3 = grads()
    updates, _ = tx.update(g3, state, params)
    after = jax.tree_util.tree_map(lambda p, u: np.asarray(p + u), params, updates)
    path = str(tmp_path_factory.mktemp("jax") / "ckpt.2.ckpt")
    jax_save_checkpoint(path, params, config=jcfg, optim_state=state, extra_state={"epoch": 2, "step_id": 9})
    return {"path": path, "params": params, "grad": g3, "after": after, "config": jcfg}


def test_jax_checkpoint_loads_strict(jax_file):
    """Told apart by its bytes: a JAX `.ckpt` is msgpack, and it comes back
    in the port's dict shape, with the params loaded `strict=True` and the
    file's own config."""
    assert ".msgpack" in CHECKPOINT_SUFFIXES
    with open(jax_file["path"], "rb") as f:
        assert f.read(4) != b"PK\x03\x04"
    ckpt = load_checkpoint(jax_file["path"])
    assert sorted(ckpt) == ["config_yaml", "extra_state", "optim_state", "state_dict"]
    assert ckpt["extra_state"] == {"epoch": 2, "step_id": 9}
    assert config_from_checkpoint(ckpt).MODEL.to_dict() == jax_file["config"].MODEL.to_dict()
    _, (policy, _), _ = build_pair(seed=0, extra=NO_TABLE)
    load_policy_state_dict(policy, ckpt["state_dict"])
    want = state_dict_from_jax_params(jax_file["params"])
    for k, v in policy.state_dict().items():
        if k in want:
            assert torch.equal(v, want[k]), k
    adam = ckpt["optim_state"]["optax_adam"]
    assert adam["step"] == 2 and "net.state_encoder.rnn.weight_hh_l0" in adam["moment_keys"]
    assert not any(k.startswith(("net.rgb_encoder.cnn.", "net.depth_encoder.visual_encoder.")) for k in adam["moment_keys"])


def _requeue_trainer(tmp_path, ckpt_path, extra=()):
    _, cfg = configs(NO_TABLE + [
        "TASK_CONFIG.DATASET.TYPE", "Synthetic-VLN-v0", "IL.lr", LR, "IL.is_requeue", True,
        "IL.ckpt_to_load", ckpt_path, "CHECKPOINT_FOLDER", str(tmp_path / "ckpts"), *extra])
    trainer = registry.get_trainer("recollect_trainer")(cfg)
    obs_space, act_space = trainer._get_spaces(cfg)
    trainer._initialize_policy(cfg, True, obs_space, act_space)
    return trainer


def _assert_resumes_adam(trainer, jax_file):
    """The restored moments equal JAX's, and one more Adam step on the same
    gradient gives JAX's next params, within 1e-6."""
    policy, optimizer = trainer.policy, trainer.optimizer
    mu = state_dict_from_jax_params(jax_file["params"])  # only for its keys
    names = dict(policy.named_parameters())
    grad = state_dict_from_jax_params(jax_file["grad"])
    trained = [n for n, p in names.items() if p.requires_grad]
    assert trained and len(trained) < len(names)
    for name in trained:
        state = optimizer.state[names[name]]
        assert float(state["step"]) == 2.0 and name in mu
        assert state["exp_avg"].abs().max() > 0
        names[name].grad = grad[name].clone()
    assert trainer.start_epoch == 3 and trainer.step_id == 9
    optimizer.step()
    after = state_dict_from_jax_params(jax_file["after"])
    for name, p in names.items():
        np.testing.assert_allclose(p.detach().numpy(), after[name].numpy(), rtol=0, atol=1e-6, err_msg=name)


def test_requeue_from_a_jax_checkpoint_resumes_adam(tmp_path, jax_file):
    _assert_resumes_adam(_requeue_trainer(tmp_path, jax_file["path"]), jax_file)


def test_requeue_raises_where_adam_cannot_resume(tmp_path, jax_file):
    """A port run that trains the RGB ResNet, which the JAX run froze, finds
    no moments for it in the file, and says so instead of starting from
    zero."""
    with pytest.raises(ValueError, match="no Adam moments for net.rgb_encoder.cnn"):
        _requeue_trainer(tmp_path, jax_file["path"], ["MODEL.RGB_ENCODER.trainable", True])


def test_ckpt_to_interrupted_state_from_a_jax_file(tmp_path, jax_file):
    """The port's script turns a JAX checkpoint into a port interrupted state
    (a torch.save file) that resumes Adam as the JAX file does."""
    from vlnce_torch.scripts.ckpt_to_interrupted_state import main

    out = str(tmp_path / "interrupted_state.ckpt")
    main(["--ckpt", jax_file["path"], "--out", out, "--update", "7"])
    with open(out, "rb") as f:
        assert f.read(4) == b"PK\x03\x04"
    state = load_checkpoint(out)
    assert state["extra_state"] == {"epoch": 2, "step_id": 9, "update": 7, "count_steps": 0}
    _assert_resumes_adam(_requeue_trainer(tmp_path, out), jax_file)

    # a port file passes through with its torch optimizer state as it is
    again = str(tmp_path / "again.ckpt")
    save_checkpoint(str(tmp_path / "port.pth"), state["state_dict"], optim_state={"state": {}, "param_groups": []})
    main(["--ckpt", str(tmp_path / "port.pth"), "--out", again])
    assert load_checkpoint(again)["optim_state"] == {"state": {}, "param_groups": []}
    assert load_checkpoint(again)["extra_state"] == {"update": 0, "count_steps": 0}
