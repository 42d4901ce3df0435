"""The port's checkpoint I/O and weight loading: round trip, atomic write,
poll order, strict loading, and the DDPPO depth-encoder key remap against
the JAX package's converter."""

import os

import numpy as np
import pytest
import torch

from vlnce_torch.models.convert import (
    ddppo_depth_state_dict,
    load_ddppo_depth_checkpoint,
    load_policy_state_dict,
    load_pretrained_embeddings,
    state_dict_from_jax_params,
)
from vlnce_torch.utils.checkpoints import (
    config_from_checkpoint,
    load_checkpoint,
    poll_checkpoint_folder,
    save_checkpoint,
)
from vlnce_tpu.models.convert import convert_ddppo_depth_checkpoint
from vlnce_tpu.models.convert import load_pretrained_embeddings as jax_load_pretrained_embeddings

from tests.torch_port_cases import build_pair


@pytest.fixture(scope="module")
def pair():
    (_, _, params), (policy, _), cfg = build_pair(seed=0)
    return params, policy, cfg


def test_checkpoint_round_trip(tmp_path, pair):
    _, policy, cfg = pair
    path = str(tmp_path / "sub" / "ckpt.3.pth")
    save_checkpoint(path, policy.state_dict(), config=cfg, extra_state={"epoch": 3, "step_id": 17})
    ckpt = load_checkpoint(path)
    assert sorted(ckpt) == ["config_yaml", "extra_state", "state_dict"]
    assert ckpt["extra_state"] == {"epoch": 3, "step_id": 17}
    want = policy.state_dict()
    assert sorted(ckpt["state_dict"]) == sorted(want)
    for k, v in want.items():
        assert ckpt["state_dict"][k].device.type == "cpu"
        assert torch.equal(ckpt["state_dict"][k], v)
    restored = config_from_checkpoint(ckpt)
    assert restored.dump() == cfg.dump()  # equal up to YAML turning tuples into lists
    assert restored.MODEL.to_dict() == cfg.MODEL.to_dict()
    assert config_from_checkpoint({"state_dict": {}}) is None


def test_save_is_atomic_and_leaves_no_temp_file(tmp_path, monkeypatch):
    path = str(tmp_path / "ckpt.0.pth")
    save_checkpoint(path, {"w": torch.ones(2)})
    seen = {}
    real_replace = os.replace

    def replace(src, dst):
        # at rename time the old file is still whole and the new one is complete
        seen["old"] = load_checkpoint(dst)["state_dict"]["w"].clone()
        seen["new"] = load_checkpoint(src)["state_dict"]["w"].clone()
        seen["tmp"] = os.path.basename(src)
        real_replace(src, dst)

    monkeypatch.setattr(os, "replace", replace)
    save_checkpoint(path, {"w": torch.zeros(2)})
    assert torch.equal(seen["old"], torch.ones(2)) and torch.equal(seen["new"], torch.zeros(2))
    assert seen["tmp"].startswith("ckpt.0.pth.tmp.") and os.listdir(tmp_path) == ["ckpt.0.pth"]
    assert torch.equal(load_checkpoint(path)["state_dict"]["w"], torch.zeros(2))


def test_poll_order_is_by_mtime(tmp_path):
    names = ["ckpt.b.pth", "ckpt.a.ckpt", "ckpt.c.pth"]
    for age, name in enumerate(names):
        save_checkpoint(str(tmp_path / name), {"w": torch.zeros(1)})
        os.utime(tmp_path / name, (1000 + age, 1000 + age))
    (tmp_path / "notes.txt").write_text("not a checkpoint")
    (tmp_path / "ckpt.d.pth.tmp.1-2").write_text("half written")
    polled = [poll_checkpoint_folder(str(tmp_path), i) for i in range(-1, 3)]
    assert [p and os.path.basename(p) for p in polled] == names + [None]
    single = str(tmp_path / names[0])
    assert poll_checkpoint_folder(single, -1) == single and poll_checkpoint_folder(single, 0) is None


def test_strict_load_fails_on_unused_and_on_missing_key(pair):
    params, policy, _ = pair
    sd = state_dict_from_jax_params(params)
    load_policy_state_dict(policy, sd)  # the whole dict loads
    with pytest.raises(RuntimeError, match="Unexpected key.*net.not_in_the_port.weight"):
        load_policy_state_dict(policy, {**sd, "net.not_in_the_port.weight": torch.zeros(1)})
    short = {k: v for k, v in sd.items() if k != "net.state_q.bias"}
    with pytest.raises(RuntimeError, match="Missing key.*net.state_q.bias"):
        load_policy_state_dict(policy, short)
    # the one exemption: counters a frozen BatchNorm has no use for
    load_policy_state_dict(policy, {**sd, "net.rgb_encoder.cnn.1.num_batches_tracked": torch.tensor(5)})


def test_ddppo_remap_matches_jax_converter(pair):
    """A seeded synthetic DDPPO state dict goes through the JAX package's
    converter into JAX params and back through `state_dict_from_jax_params`;
    the port loads the same file directly. Equal, atol 0."""
    params, policy, _ = pair
    encoder = policy.net.depth_encoder.visual_encoder
    rng = np.random.RandomState(5)
    ddppo = {"state_dict": {
        f"actor_critic.net.visual_encoder.{k}": torch.from_numpy(rng.randn(*v.shape).astype(np.float32))
        for k, v in encoder.state_dict().items()
    }}
    ddppo["state_dict"]["actor_critic.net.state_encoder.rnn.weight_ih_l0"] = torch.zeros(3)  # not the encoder's: dropped
    ddppo["state_dict"]["actor_critic.critic.fc.weight"] = torch.zeros(3)

    via_jax = state_dict_from_jax_params(convert_ddppo_depth_checkpoint(ddppo, params))
    load_ddppo_depth_checkpoint(policy, ddppo)
    prefix = "net.depth_encoder.visual_encoder."
    ours = policy.state_dict()
    checked = 0
    for k, v in via_jax.items():
        if k.startswith(prefix):
            np.testing.assert_array_equal(ours[k].numpy(), v.numpy(), err_msg=k)
            assert torch.equal(ours[k], ddppo["state_dict"]["actor_critic.net.visual_encoder." + k[len(prefix):]])
            checked += 1
    assert checked == len(encoder.state_dict()) > 50
    assert sorted(ddppo_depth_state_dict(ddppo)) == sorted(encoder.state_dict())
    # strict: an encoder key the file lacks, or one the encoder does not have, raises
    del ddppo["state_dict"]["actor_critic.net.visual_encoder.compression.0.weight"]
    with pytest.raises(RuntimeError, match="Missing key"):
        load_ddppo_depth_checkpoint(policy, ddppo)
    ddppo["state_dict"]["actor_critic.net.visual_encoder.running_mean_and_var._mean"] = torch.zeros(1)
    with pytest.raises(RuntimeError, match="Unexpected key|Missing key"):
        load_ddppo_depth_checkpoint(policy, ddppo)


def test_pretrained_embeddings_match_jax_loader(tmp_path):
    import gzip
    import json
    from types import SimpleNamespace

    table = np.random.RandomState(2).randn(7, 5).round(4).tolist()
    path = str(tmp_path / "embeddings.json.gz")
    with gzip.open(path, "wt") as f:
        json.dump(table, f)
    layer = torch.nn.Embedding(7, 5)
    policy = SimpleNamespace(net=SimpleNamespace(instruction_encoder=SimpleNamespace(embedding_layer=layer)))
    before = layer.weight.detach().clone()
    assert not load_pretrained_embeddings(policy, str(tmp_path / "absent.json.gz"))
    assert torch.equal(layer.weight, before)
    assert load_pretrained_embeddings(policy, path)
    np.testing.assert_array_equal(layer.weight.detach().numpy(), jax_load_pretrained_embeddings(path))
