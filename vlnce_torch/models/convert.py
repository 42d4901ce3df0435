"""Weights into the port's modules: from the JAX package, and from
reference-keyed torch files.

`state_dict_from_jax_params` turns the JAX package's parameter tree (nested
dicts of numpy arrays, as flax holds them) of the CMA or the Seq2Seq policy
into this package's state_dict,
which uses the reference's key names. It is the inverse of
vlnce_tpu/models/convert.py:convert_policy_state_dict:

    Dense   kernel[in, out]        -> Linear W[out, in]
    Conv    kernel[kh, kw, in, out] -> Conv2d W[out, in, kh, kw]
    Dense used as a 1x1 Conv1d     -> Conv1d W[out, in, 1]
    GroupNorm scale/bias           -> weight/bias
    FrozenBatchNorm                -> weight/bias/running_mean/running_var
    GRU/LSTM cell params           -> copied (already in torch layout)

Every JAX parameter must land somewhere: a leftover raises, so nothing is
dropped silently. Load the result with `load_state_dict(sd, strict=True)`.

`load_policy_state_dict` is the strict load of a reference-keyed state dict
that the trainer uses for checkpoints, and `load_ddppo_depth_checkpoint` the
DDPPO PointGoal key remap into the depth encoder.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch


class _Tree:
    """Reads leaves of the nested param dict by '/'-path, recording use."""

    def __init__(self, params: Mapping):
        self.params = params
        self.used = set()

    def has(self, path: str) -> bool:
        node = self.params
        for p in path.split("/"):
            if not isinstance(node, Mapping) or p not in node:
                return False
            node = node[p]
        return True

    def get(self, path: str) -> np.ndarray:
        node = self.params
        for p in path.split("/"):
            node = node[p]
        self.used.add(path)
        return np.asarray(node, dtype=np.float32)

    def children(self, path: str):
        node = self.params
        for p in path.split("/"):
            node = node[p]
        return list(node.keys())

    def leaves(self, node=None, prefix=""):
        node = self.params if node is None else node
        for k, v in node.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, Mapping):
                yield from self.leaves(v, path)
            else:
                yield path


def _dense(tree, sd, src: str, dst: str) -> None:
    sd[f"{dst}.weight"] = tree.get(f"{src}/kernel").T
    if tree.has(f"{src}/bias"):
        sd[f"{dst}.bias"] = tree.get(f"{src}/bias")


def _conv1d(tree, sd, src: str, dst: str) -> None:
    sd[f"{dst}.weight"] = tree.get(f"{src}/kernel").T[:, :, None]
    sd[f"{dst}.bias"] = tree.get(f"{src}/bias")


def _conv2d(tree, sd, src: str, dst: str) -> None:
    sd[f"{dst}.weight"] = tree.get(f"{src}/kernel").transpose(3, 2, 0, 1)


def _gn(tree, sd, src: str, dst: str) -> None:
    sd[f"{dst}.weight"] = tree.get(f"{src}/scale")
    sd[f"{dst}.bias"] = tree.get(f"{src}/bias")


def _bn(tree, sd, src: str, dst: str) -> None:
    for name in ("weight", "bias", "running_mean", "running_var"):
        sd[f"{dst}.{name}"] = tree.get(f"{src}/{name}")


def _rnn(tree, sd, src: str, dst: str, suffix: str = "") -> None:
    for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
        sd[f"{dst}.{name}_l0{suffix}"] = tree.get(f"{src}/{name}")


def _blocks(tree, path: str):
    """(layer, block) indices of the `layer{i}_{b}` children of path."""
    found = []
    for name in tree.children(path):
        m = re.fullmatch(r"layer(\d)_(\d+)", name)
        if m:
            found.append((int(m.group(1)), int(m.group(2))))
    return sorted(found)


def _gn_resnet_encoder(tree, sd, src: str, dst: str) -> None:
    _conv2d(tree, sd, f"{src}/backbone/stem_conv", f"{dst}.backbone.conv1.0")
    _gn(tree, sd, f"{src}/backbone/stem_gn", f"{dst}.backbone.conv1.1")
    for layer, block in _blocks(tree, f"{src}/backbone"):
        s = f"{src}/backbone/layer{layer}_{block}"
        d = f"{dst}.backbone.layer{layer}.{block}"
        convs = 3 if tree.has(f"{s}/conv3") else 2
        for j in range(1, convs + 1):
            _conv2d(tree, sd, f"{s}/conv{j}", f"{d}.convs.{3 * (j - 1)}")
            _gn(tree, sd, f"{s}/gn{j}", f"{d}.convs.{3 * (j - 1) + 1}")
        if tree.has(f"{s}/ds_conv"):
            _conv2d(tree, sd, f"{s}/ds_conv", f"{d}.downsample.0")
            _gn(tree, sd, f"{s}/ds_gn", f"{d}.downsample.1")
    _conv2d(tree, sd, f"{src}/compression_conv", f"{dst}.compression.0")
    _gn(tree, sd, f"{src}/compression_gn", f"{dst}.compression.1")


def _tv_resnet(tree, sd, src: str, dst: str) -> None:
    _conv2d(tree, sd, f"{src}/conv1", f"{dst}.0")
    _bn(tree, sd, f"{src}/bn1", f"{dst}.1")
    for layer, block in _blocks(tree, src):
        s = f"{src}/layer{layer}_{block}"
        d = f"{dst}.{3 + layer}.{block}"
        j = 1
        while tree.has(f"{s}/conv{j}"):
            _conv2d(tree, sd, f"{s}/conv{j}", f"{d}.conv{j}")
            _bn(tree, sd, f"{s}/bn{j}", f"{d}.bn{j}")
            j += 1
        if tree.has(f"{s}/ds_conv"):
            _conv2d(tree, sd, f"{s}/ds_conv", f"{d}.downsample.0")
            _bn(tree, sd, f"{s}/ds_bn", f"{d}.downsample.1")


def _instruction_encoder(tree, sd, src: str, dst: str) -> None:
    _rnn(tree, sd, f"{src}/rnn_fwd/cell", f"{dst}.encoder_rnn")
    if tree.has(f"{src}/rnn_bwd"):
        _rnn(tree, sd, f"{src}/rnn_bwd/cell", f"{dst}.encoder_rnn", "_reverse")
    if tree.has(f"{src}/embedding"):  # the token path's table
        sd[f"{dst}.embedding_layer.weight"] = tree.get(f"{src}/embedding")


def _encoders(tree, sd, src: str, dst: str) -> None:
    """The instruction, depth and RGB encoders, each with its spatial
    embedding (CMA) or its non-spatial head (Seq2Seq)."""
    _instruction_encoder(tree, sd, f"{src}/instruction_encoder", f"{dst}.instruction_encoder")

    de = f"{src}/depth_encoder"
    _gn_resnet_encoder(tree, sd, f"{de}/visual_encoder", f"{dst}.depth_encoder.visual_encoder")
    if tree.has(f"{de}/visual_fc"):
        _dense(tree, sd, f"{de}/visual_fc", f"{dst}.depth_encoder.visual_fc.1")
    else:
        sd[f"{dst}.depth_encoder.spatial_embeddings.weight"] = tree.get(f"{de}/spatial_embeddings")

    re_ = f"{src}/rgb_encoder"
    _tv_resnet(tree, sd, f"{re_}/cnn", f"{dst}.rgb_encoder.cnn")
    if tree.has(f"{re_}/fc"):
        _dense(tree, sd, f"{re_}/fc", f"{dst}.rgb_encoder.fc.1")
    else:
        sd[f"{dst}.rgb_encoder.spatial_embeddings.weight"] = tree.get(f"{re_}/spatial_embeddings")


def _cma(tree, sd) -> None:
    _rnn(tree, sd, "net/state_encoder/cell", "net.state_encoder.rnn")
    _rnn(tree, sd, "net/second_state_encoder/cell", "net.second_state_encoder.rnn")
    sd["net.prev_action_embedding.weight"] = tree.get("net/prev_action_embedding")
    _dense(tree, sd, "net/rgb_linear", "net.rgb_linear.2")
    _dense(tree, sd, "net/depth_linear", "net.depth_linear.1")
    _conv1d(tree, sd, "net/rgb_kv", "net.rgb_kv")
    _conv1d(tree, sd, "net/depth_kv", "net.depth_kv")
    _dense(tree, sd, "net/state_q", "net.state_q")
    _conv1d(tree, sd, "net/text_k", "net.text_k")
    _dense(tree, sd, "net/text_q", "net.text_q")
    _dense(tree, sd, "net/second_state_compress", "net.second_state_compress.0")


def _seq2seq(tree, sd) -> None:
    _rnn(tree, sd, "net/state_encoder/cell", "net.state_encoder.rnn")
    if tree.has("net/prev_action_embedding"):
        sd["net.prev_action_embedding.weight"] = tree.get("net/prev_action_embedding")


_POLICIES = {"CMAPolicy": _cma, "Seq2SeqPolicy": _seq2seq}


def state_dict_from_jax_params(params: Mapping, policy_name: str = "CMAPolicy") -> Dict[str, torch.Tensor]:
    """JAX params (nested dicts of arrays) -> this package's state_dict, for
    the CMA or the Seq2Seq policy."""
    if policy_name not in _POLICIES:
        raise ValueError(f"state_dict_from_jax_params: {policy_name} is not ported yet")
    tree = _Tree(params)
    sd: Dict[str, np.ndarray] = {}
    _encoders(tree, sd, "net", "net")
    _dense(tree, sd, "action_distribution", "action_distribution.linear")
    _POLICIES[policy_name](tree, sd)
    if tree.has("net/progress_monitor"):
        _dense(tree, sd, "net/progress_monitor", "net.progress_monitor")

    unused = sorted(set(tree.leaves()) - tree.used)
    if unused:
        raise KeyError(f"state_dict_from_jax_params: JAX params with no place in the port: {unused}")
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def load_policy_state_dict(policy, state_dict: Mapping[str, torch.Tensor]) -> None:
    """Load a reference-keyed state dict into a port policy, strictly: a key
    of the file that the policy does not use, or a key of the policy that the
    file does not fill, raises. The one exemption is BatchNorm's
    `num_batches_tracked` counters, which a frozen BatchNorm has no use for."""
    policy.load_state_dict(
        {k: v for k, v in state_dict.items() if not k.endswith(".num_batches_tracked")}, strict=True
    )


def ddppo_depth_state_dict(ckpt: Mapping) -> Dict[str, torch.Tensor]:
    """The visual-encoder weights of a DDPPO PointGoal checkpoint under the
    depth encoder's own key names: `actor_critic.net.visual_encoder.<key>`
    becomes `<key>` and every other entry is left out, as the reference does
    (resnet_encoders.py:48-61)."""
    weights = {}
    for k, v in ckpt["state_dict"].items():
        parts = k.split(".")[2:]
        if not parts or parts[0] != "visual_encoder":
            continue
        weights[".".join(parts[1:])] = v
    return weights


def load_ddppo_depth_checkpoint(policy, ckpt: Mapping) -> None:
    """Load DDPPO PointGoal weights into `policy.net.depth_encoder
    .visual_encoder`, strictly."""
    policy.net.depth_encoder.visual_encoder.load_state_dict(ddppo_depth_state_dict(ckpt), strict=True)


def load_pretrained_embeddings(policy, embedding_file: str) -> bool:
    """Overwrite the instruction embedding table from a GloVe-style
    embeddings.json.gz (JSON [vocab, dim] floats) if the file exists; returns
    whether it did."""
    import gzip
    import json
    import os

    if not os.path.exists(embedding_file):
        return False
    with gzip.open(embedding_file, "rt") as f:
        table = torch.tensor(json.load(f), dtype=torch.float32)
    weight = policy.net.instruction_encoder.embedding_layer.weight
    with torch.no_grad():
        weight.copy_(table.to(weight.device))
    return True
