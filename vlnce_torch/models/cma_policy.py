"""Cross-Modal Attention (CMA) policy (ECCV'20), port of
vlnce_tpu/models/cma_policy.py (reference vlnce_baselines/models/
cma_policy.py:52-309).

Two recurrent layers with text/visual cross-attention between them: GRU#1
over [rgb256, depth128, prev_a32]; state-query -> instruction K/V attention
with a padding mask; text-query -> rgb/depth K/V attention via 1x1 convs;
GRU#2 over the compressed concat; optional progress-monitor head. The visual
encoders run in the compute dtype; everything after them runs in f32.

The JAX package splits the network (CMANet), the network plus action head
(CMAModule) and the policy handle that owns the params (CMAPolicy). A torch
module owns its parameters, so here CMAPolicy is CMAModule and the handle at
once.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from vlnce_torch.models.attention import scaled_dot_attn
from vlnce_torch.models.encoders.instruction_encoder import InstructionEncoder
from vlnce_torch.models.encoders.visual_wrappers import TorchVisionResNetEncoder, VlnResnetDepthEncoder
from vlnce_torch.models.initializers import init_default, variance_scaling_
from vlnce_torch.models.policy import CategoricalNet, ILPolicy, config_dtype
from vlnce_torch.models.rnn_state_encoder import RNNStateEncoder
from vlnce_torch.registry import registry


class CMANet(nn.Module):
    def __init__(self, model_config, num_actions: int, depth_input_hw: Tuple[int, int] = (256, 256),
                 instruction_input_size: int = None, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        mc = self.model_config = model_config
        H = mc.STATE_ENCODER.hidden_size

        self.instruction_encoder = InstructionEncoder.from_config(
            mc.INSTRUCTION_ENCODER, input_size=instruction_input_size, final_state_only=False
        )
        self.depth_encoder = VlnResnetDepthEncoder(
            input_hw=depth_input_hw, backbone=mc.DEPTH_ENCODER.backbone, compute_dtype=compute_dtype,
            trainable=mc.DEPTH_ENCODER.trainable,
        )
        self.rgb_encoder = TorchVisionResNetEncoder(
            version="resnet50" if mc.RGB_ENCODER.cnn_type == "TorchVisionResNet50" else "resnet18",
            normalize_visual_inputs=mc.normalize_rgb, compute_dtype=compute_dtype,
            trainable=mc.RGB_ENCODER.trainable,
        )
        self.prev_action_embedding = nn.Embedding(num_actions + 1, 32)

        rgb_c = self.rgb_encoder.output_shape[0]
        depth_c, dh, dw = self.depth_encoder.output_shape
        instr_c = self.instruction_encoder.output_size
        rgb_out, depth_out = mc.RGB_ENCODER.output_size, mc.DEPTH_ENCODER.output_size
        self.rgb_linear = nn.Sequential(nn.AdaptiveAvgPool1d(1), nn.Flatten(), nn.Linear(rgb_c, rgb_out), nn.ReLU(True))
        self.depth_linear = nn.Sequential(nn.Flatten(), nn.Linear(depth_c * dh * dw, depth_out), nn.ReLU(True))

        self.state_encoder = RNNStateEncoder(rgb_out + depth_out + 32, H, mc.STATE_ENCODER.rnn_type)
        self.second_state_encoder = RNNStateEncoder(H, H, mc.STATE_ENCODER.rnn_type)

        self.state_q = nn.Linear(H, H // 2)
        self.text_k = nn.Conv1d(instr_c, H // 2, 1)
        self.text_q = nn.Linear(instr_c, H // 2)
        self.rgb_kv = nn.Conv1d(rgb_c, H // 2 + rgb_out, 1)
        self.depth_kv = nn.Conv1d(depth_c, H // 2 + depth_out, 1)
        self.second_state_compress = nn.Sequential(
            nn.Linear(H + instr_c + rgb_out + depth_out + 32, H), nn.ReLU(True)
        )
        if mc.PROGRESS_MONITOR.use:
            self.progress_monitor = nn.Linear(H, 1)

    @property
    def output_size(self) -> int:
        return self.model_config.STATE_ENCODER.hidden_size

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        init_default(self, generator)
        self.instruction_encoder.reset_parameters(generator)
        self.state_encoder.rnn.reset_parameters(generator)
        self.second_state_encoder.rnn.reset_parameters(generator)
        if self.model_config.PROGRESS_MONITOR.use:
            variance_scaling_(self.progress_monitor.weight, 2.0, self.output_size, generator)

    def forward(self, observations, rnn_states, prev_actions, masks, seq_len: Optional[int] = None):
        """Single-step mode (seq_len None): every tensor has leading dim B.
        Sequence mode (seq_len = T): observations, prev_actions and masks are
        time-major flattened [T*N, ...], rnn_states is [N, L, H]; the
        encoders and attention run per flattened sample and the two
        recurrent encoders over [T, N, D]."""
        mc = self.model_config
        H = mc.STATE_ENCODER.hidden_size

        def run_rnn(rnn, x, states, m):
            if seq_len is None:
                return rnn(x, states, m)
            N = x.shape[0] // seq_len
            out, s = rnn(x.reshape(seq_len, N, -1), states, m.reshape(seq_len, N, 1))
            return out.reshape(seq_len * N, -1), s

        instruction_embedding = self.instruction_encoder(observations)  # [B, C_t, T_text]
        depth_embedding = self.depth_encoder(observations).flatten(2)  # [B, C_d, P]
        rgb_embedding = self.rgb_encoder(observations).flatten(2)  # [B, C_r, 16]

        idx = ((prev_actions.reshape(-1).float() + 1.0) * masks.reshape(-1)).long()
        prev_actions_emb = self.prev_action_embedding(idx)  # [B, 32]

        if mc.ablate_instruction:
            instruction_embedding = instruction_embedding * 0
        if mc.ablate_depth:
            depth_embedding = depth_embedding * 0
        if mc.ablate_rgb:
            rgb_embedding = rgb_embedding * 0

        rgb_embedding = rgb_embedding.float()
        depth_embedding = depth_embedding.float()
        rgb_in = self.rgb_linear(rgb_embedding)
        depth_in = self.depth_linear(depth_embedding)
        state_in = torch.cat([rgb_in, depth_in, prev_actions_emb], dim=1)

        L1 = self.state_encoder.num_recurrent_layers
        state, rnn1_out = run_rnn(self.state_encoder, state_in, rnn_states[:, :L1], masks)

        scale = 1.0 / ((H // 2) ** 0.5)
        text_state_q = self.state_q(state)
        text_state_k = self.text_k(instruction_embedding)
        text_mask = (instruction_embedding == 0.0).all(dim=1)  # [B, T_text]
        text_embedding = scaled_dot_attn(text_state_q, text_state_k, instruction_embedding, scale, text_mask)

        rgb_kv = self.rgb_kv(rgb_embedding)
        rgb_k, rgb_v = rgb_kv[:, : H // 2], rgb_kv[:, H // 2 :]
        depth_kv = self.depth_kv(depth_embedding)
        depth_k, depth_v = depth_kv[:, : H // 2], depth_kv[:, H // 2 :]

        text_q = self.text_q(text_embedding)
        rgb_attended = scaled_dot_attn(text_q, rgb_k, rgb_v, scale)
        depth_attended = scaled_dot_attn(text_q, depth_k, depth_v, scale)

        x = torch.cat([state, text_embedding, rgb_attended, depth_attended, prev_actions_emb], dim=1)
        x = self.second_state_compress(x)
        x, rnn2_out = run_rnn(self.second_state_encoder, x, rnn_states[:, L1:], masks)

        rnn_states_out = torch.cat([rnn1_out, rnn2_out], dim=1)

        aux: Dict[str, Tuple[torch.Tensor, float]] = {}
        if mc.PROGRESS_MONITOR.use:
            progress_hat = torch.tanh(self.progress_monitor(x))
            progress_loss = (progress_hat.squeeze(-1) - observations["progress"].reshape(-1)) ** 2
            aux["progress_monitor"] = (progress_loss, mc.PROGRESS_MONITOR.alpha)
        return x, rnn_states_out, aux


@registry.register_policy(name="CMAPolicy")
class CMAPolicy(ILPolicy):
    def __init__(self, config, observation_space, num_actions: int):
        super().__init__(config, observation_space, num_actions)
        mc = config.MODEL
        depth_hw = observation_space["depth"].shape[:2] if "depth" in observation_space else (256, 256)
        uuid = mc.INSTRUCTION_ENCODER.sensor_uuid
        instr_in = observation_space[uuid].shape[-1] if uuid != "instruction" else None
        self.net = CMANet(
            mc, num_actions, depth_input_hw=tuple(depth_hw), instruction_input_size=instr_in,
            compute_dtype=config_dtype(config.CUDA.PRECISION.compute_dtype),
        )
        self.action_distribution = CategoricalNet(self.net.output_size, num_actions)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.net.reset_parameters(generator)
        self.action_distribution.reset_parameters(generator)

    def forward(self, observations, rnn_states, prev_actions, masks, seq_len: Optional[int] = None):
        features, rnn_states_out, aux = self.net(observations, rnn_states, prev_actions, masks, seq_len)
        return self.action_distribution(features), rnn_states_out, aux

    @classmethod
    def num_recurrent_layers_from_config(cls, config) -> int:
        per = 2 if config.MODEL.STATE_ENCODER.rnn_type == "LSTM" else 1
        return 2 * per  # two recurrent encoders
