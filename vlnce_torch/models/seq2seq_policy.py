"""Seq2Seq policy (ECCV'20 baseline), port of
vlnce_tpu/models/seq2seq_policy.py (reference vlnce_baselines/models/
seq2seq_policy.py:20-179).

concat(instruction final state, depth 128-d, rgb 256-d [, prev-action 32-d])
-> one recurrent state encoder (H=512; its GRU is the `gru_sequence` kernel)
-> categorical head; optionally the progress monitor as an aux loss. The
visual encoders run in the compute dtype, their heads and everything after
them in f32. As in the CMA port, the policy is the module and the handle at
once.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from vlnce_torch.models.encoders.instruction_encoder import InstructionEncoder
from vlnce_torch.models.encoders.visual_wrappers import TorchVisionResNetEncoder, VlnResnetDepthEncoder
from vlnce_torch.models.initializers import init_default
from vlnce_torch.models.policy import CategoricalNet, ILPolicy, config_dtype
from vlnce_torch.models.rnn_state_encoder import RNNStateEncoder
from vlnce_torch.registry import registry


class Seq2SeqNet(nn.Module):
    def __init__(self, model_config, num_actions: int, depth_input_hw: Tuple[int, int] = (256, 256),
                 instruction_input_size: int = None, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        mc = self.model_config = model_config
        self.instruction_encoder = InstructionEncoder.from_config(mc.INSTRUCTION_ENCODER, input_size=instruction_input_size)
        self.depth_encoder = VlnResnetDepthEncoder(
            input_hw=depth_input_hw, backbone=mc.DEPTH_ENCODER.backbone, compute_dtype=compute_dtype,
            trainable=mc.DEPTH_ENCODER.trainable, spatial_output=False, output_size=mc.DEPTH_ENCODER.output_size,
        )
        self.rgb_encoder = TorchVisionResNetEncoder(
            version="resnet50" if mc.RGB_ENCODER.cnn_type == "TorchVisionResNet50" else "resnet18",
            normalize_visual_inputs=mc.normalize_rgb, compute_dtype=compute_dtype,
            trainable=mc.RGB_ENCODER.trainable, spatial_output=False, output_size=mc.RGB_ENCODER.output_size,
        )
        rnn_input = self.instruction_encoder.output_size + mc.DEPTH_ENCODER.output_size + mc.RGB_ENCODER.output_size
        if mc.SEQ2SEQ.use_prev_action:
            self.prev_action_embedding = nn.Embedding(num_actions + 1, 32)
            rnn_input += 32
        self.state_encoder = RNNStateEncoder(rnn_input, mc.STATE_ENCODER.hidden_size, mc.STATE_ENCODER.rnn_type)
        if mc.PROGRESS_MONITOR.use:
            self.progress_monitor = nn.Linear(mc.STATE_ENCODER.hidden_size, 1)

    @property
    def output_size(self) -> int:
        return self.model_config.STATE_ENCODER.hidden_size

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        init_default(self, generator)
        self.instruction_encoder.reset_parameters(generator)
        self.state_encoder.rnn.reset_parameters(generator)

    def forward(self, observations, rnn_states, prev_actions, masks, seq_len: Optional[int] = None):
        """Single-step mode (seq_len None): every tensor has leading dim B.
        Sequence mode (seq_len = T): observations, prev_actions and masks are
        time-major flattened [T*N, ...], rnn_states is [N, L, H]; the
        encoders run per flattened sample and the state encoder over [T, N, D]."""
        mc = self.model_config
        instruction_embedding = self.instruction_encoder(observations)  # [B, C_t]
        depth_embedding = self.depth_encoder(observations)  # [B, 128] f32
        rgb_embedding = self.rgb_encoder(observations)  # [B, 256] f32

        if mc.ablate_instruction:
            instruction_embedding = instruction_embedding * 0
        if mc.ablate_depth:
            depth_embedding = depth_embedding * 0
        if mc.ablate_rgb:
            rgb_embedding = rgb_embedding * 0

        x = torch.cat([instruction_embedding, depth_embedding, rgb_embedding], dim=1)
        if mc.SEQ2SEQ.use_prev_action:
            idx = ((prev_actions.reshape(-1).float() + 1.0) * masks.reshape(-1)).long()
            x = torch.cat([x, self.prev_action_embedding(idx)], dim=1)

        if seq_len is None:
            x, rnn_states_out = self.state_encoder(x, rnn_states, masks)
        else:
            N = x.shape[0] // seq_len
            out, rnn_states_out = self.state_encoder(x.reshape(seq_len, N, -1), rnn_states, masks.reshape(seq_len, N, 1))
            x = out.reshape(seq_len * N, -1)

        aux: Dict[str, Tuple[torch.Tensor, float]] = {}
        if mc.PROGRESS_MONITOR.use:
            progress_hat = torch.tanh(self.progress_monitor(x))
            progress_loss = (progress_hat.squeeze(-1) - observations["progress"].reshape(-1)) ** 2
            aux["progress_monitor"] = (progress_loss, mc.PROGRESS_MONITOR.alpha)
        return x, rnn_states_out, aux


@registry.register_policy(name="Seq2SeqPolicy")
class Seq2SeqPolicy(ILPolicy):
    def __init__(self, config, observation_space, num_actions: int):
        super().__init__(config, observation_space, num_actions)
        mc = config.MODEL
        depth_hw = observation_space["depth"].shape[:2] if "depth" in observation_space else (256, 256)
        uuid = mc.INSTRUCTION_ENCODER.sensor_uuid
        instr_in = observation_space[uuid].shape[-1] if uuid != "instruction" else None
        self.net = Seq2SeqNet(
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
        return 2 if config.MODEL.STATE_ENCODER.rnn_type == "LSTM" else 1
