"""The port's encoders, attention and action distribution against the JAX
package, in f32 on the CPU, on the same carried-across weights.

Tolerances: the ResNet18 encoders at 64x64 atol 1e-4 (f32 convolutions in
another summation order); the instruction encoder atol 1e-5, with outputs
past each row's length exactly zero; attention and the distribution 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vlnce_tpu.models.attention import scaled_dot_attn as jax_attn
from vlnce_tpu.models.distributions import Categorical as JaxCategorical
from vlnce_tpu.models.encoders.instruction_encoder import InstructionEncoder as JaxInstructionEncoder
from vlnce_tpu.models.encoders.visual_wrappers import (
    TorchVisionResNetEncoder as JaxRGBEncoder,
    VlnResnetDepthEncoder as JaxDepthEncoder,
)
from vlnce_torch.models import convert
from vlnce_torch.models.attention import scaled_dot_attn
from vlnce_torch.models.distributions import Categorical
from vlnce_torch.models.encoders.instruction_encoder import InstructionEncoder

from tests.torch_port_cases import build_pair, observations, to_torch

CROPS_64 = [
    "RL.POLICY.OBS_TRANSFORMS.RESIZE_SHORTEST_EDGE.SIZE", 64,
    "RL.POLICY.OBS_TRANSFORMS.CENTER_CROPPER_PER_SENSOR.SENSOR_CROPS", [["rgb", [64, 64]], ["depth", [64, 64]]],
]


@pytest.fixture(scope="module")
def pair64():
    return build_pair(seed=3, extra=CROPS_64)


@pytest.mark.parametrize("which", ["depth", "rgb"])
def test_visual_encoder_spatial_output_matches_jax(pair64, which):
    (_, _, params), (policy, _), _ = pair64
    rng = np.random.RandomState(4)
    obs = {
        "rgb": rng.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8),
        "depth": rng.rand(2, 64, 64, 1).astype(np.float32),
    }
    if which == "depth":
        jax_enc = JaxDepthEncoder(input_hw=(64, 64), backbone="resnet18", spatial_output=True)
        enc = policy.net.depth_encoder
    else:
        jax_enc = JaxRGBEncoder(version="resnet18", spatial_output=True)
        enc = policy.net.rgb_encoder
    ref = jax_enc.apply({"params": params["net"][f"{which}_encoder"]}, {k: jnp.asarray(v) for k, v in obs.items()})
    with torch.no_grad():
        out = enc(to_torch(obs))
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


@pytest.mark.parametrize("final_state_only", [False, True], ids=["outputs", "final_state"])
def test_bert_feature_bilstm_matches_jax(pair64, final_state_only):
    (_, _, params), (policy, _), cfg = pair64
    mc = cfg.MODEL.INSTRUCTION_ENCODER
    jax_enc = JaxInstructionEncoder.from_config(mc, final_state_only=final_state_only)
    enc = InstructionEncoder.from_config(mc, input_size=32, final_state_only=final_state_only)
    prefix = "net.instruction_encoder."
    enc.load_state_dict({k[len(prefix):]: v for k, v in policy.state_dict().items() if k.startswith(prefix)}, strict=True)

    obs = observations(np.random.RandomState(6), 5, cfg.TASK_CONFIG)
    obs["rxr_instruction"][0] = 0.0  # an empty instruction
    ref = jax_enc.apply({"params": params["net"]["instruction_encoder"]}, {"rxr_instruction": jnp.asarray(obs["rxr_instruction"])})
    with torch.no_grad():
        out = enc({"rxr_instruction": torch.from_numpy(obs["rxr_instruction"])})
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    if not final_state_only:
        lengths = (np.abs(obs["rxr_instruction"]).sum(-1) != 0).sum(-1)
        for b, n in enumerate(lengths):
            assert np.all(out[b, :, n:].numpy() == 0.0)
            assert np.all(np.abs(out[b, :, :n].numpy()).sum(0) > 0)


@pytest.mark.parametrize("case", ["r2r_cma_bilstm_outputs", "r2r_seq2seq_lstm_final_state", "gru_final_state"])
def test_token_embedding_path_matches_jax(case):
    """The R2R path: token ids [B, T], zero-padded past ragged lengths,
    through the embedding table and the masked RNN, on the JAX encoder's
    weights carried across by the converter (atol 1e-5, f32)."""
    bidirectional, final_state_only, rnn_type = {
        "r2r_cma_bilstm_outputs": (True, False, "LSTM"),
        "r2r_seq2seq_lstm_final_state": (False, True, "LSTM"),
        "gru_final_state": (True, True, "GRU"),
    }[case]
    kw = dict(vocab_size=60, embedding_size=12, hidden_size=16, rnn_type=rnn_type,
              final_state_only=final_state_only, bidirectional=bidirectional, sensor_uuid="instruction")
    rng = np.random.RandomState(9)
    B, T = 5, 11
    tokens = np.zeros((B, T), np.int64)
    for b, n in enumerate([T, 0, 1, 7, 4]):  # a full, an empty and a one-token instruction among them
        tokens[b, :n] = rng.randint(1, kw["vocab_size"], n)

    jax_enc = JaxInstructionEncoder(**kw)
    params = jax_enc.init(jax.random.PRNGKey(2), {"instruction": jnp.asarray(tokens)})["params"]
    params = jax.tree_util.tree_map(lambda v: np.asarray(v) + 0.05 * rng.randn(*v.shape).astype(np.float32), params)
    tree, sd = convert._Tree({"enc": params}), {}
    convert._instruction_encoder(tree, sd, "enc", "enc")
    assert set(tree.leaves()) == tree.used  # every JAX leaf was carried across
    enc = InstructionEncoder(**kw)
    enc.load_state_dict({k[len("enc."):]: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, strict=True)

    ref = jax_enc.apply({"params": params}, {"instruction": jnp.asarray(tokens)})
    with torch.no_grad():
        out = enc({"instruction": torch.from_numpy(tokens)})
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    if not final_state_only:
        for b, n in enumerate((tokens != 0).sum(1)):
            assert np.all(out[b, :, n:].numpy() == 0.0)  # exactly zero past each length


def test_scaled_dot_attn_with_padding_mask():
    rng = np.random.RandomState(7)
    q, k, v = rng.randn(3, 8), rng.randn(3, 8, 10), rng.randn(3, 5, 10)
    mask = np.zeros((3, 10), bool)
    mask[0, 6:] = True
    mask[2, 1:] = True
    q, k, v = (a.astype(np.float32) for a in (q, k, v))
    ref = jax_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.35, jnp.asarray(mask))
    out = scaled_dot_attn(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 0.35, torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
    np.testing.assert_allclose(out[2].numpy(), v[2, :, 0], atol=1e-6)  # all mass on the one unmasked key


def test_categorical_mode_and_log_prob():
    logits = np.random.RandomState(8).randn(4, 6).astype(np.float32)
    actions = np.array([[0], [5], [2], [3]])
    ref = JaxCategorical(jnp.asarray(logits))
    dist = Categorical(torch.from_numpy(logits))
    np.testing.assert_array_equal(dist.mode().numpy(), np.asarray(ref.mode()))
    np.testing.assert_allclose(dist.log_prob(torch.from_numpy(actions)).numpy(),
                               np.asarray(ref.log_prob(jnp.asarray(actions))), atol=1e-6)
    np.testing.assert_allclose(dist.entropy().numpy(), np.asarray(ref.entropy()), atol=1e-6)
