"""Waypoint prediction network (ICCV'21 WPN/HPN), port of
vlnce_tpu/models/waypoint_predictors.py (reference
vlnce_baselines/models/waypoint_predictors.py:29-625).

Pano-batched RGB/depth encoding with the history frame concatenated as a
13th frame, 4-d prev-action featurization (sin/cos pano + offset +
distance), the visual-history GRU, instruction attention, per-frame spatial
attention, pano multi-head attention, the main GRU, pano-stop logits from
dotted features plus a stop head, and distance/offset heads with bounded
variances. All 13 frames x B go through each frozen CNN as one
[13B, H, W, C] batch in the compute dtype; everything after the encoders
runs in f32. The on-card PPO update hands over the rollout's stored
backbone outputs in place of the frames (`backbone_features`), so there
the frozen CNNs run once per frame. Both GRUs are `RNNStateEncoder`s, so
on the card each runs the `gru_sequence` kernel (B1), in the single step
and in the sequence mode (`seq_len=T`, time-major flattened [T*n, ...]
inputs, as PPO's minibatch update hands them over).

Module names are the reference's, so state_dict keys read
`net.visual_rnn.rnn.*`, `net.rgb_hist_linear.2.*`, `net.pano_attn.*`, ...
(the critic head is the policy's, `critic.fc.*`).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from vlnce_torch.models.attention import MultiHeadDotProductAttention, scaled_dot_attn
from vlnce_torch.models.distributions import temperature_tanh
from vlnce_torch.models.encoders.instruction_encoder import InstructionEncoder
from vlnce_torch.models.encoders.visual_wrappers import TorchVisionResNetEncoder, VlnResnetDepthEncoder
from vlnce_torch.models.initializers import init_default
from vlnce_torch.models.rnn_state_encoder import RNNStateEncoder

PREV_ACTION_DIM = 4
PANO_ATTN_KEY_DIM = 128
ANGLE_FEATURE_SIZE = 4
FRAME_KEYS = ("rgb", "depth", "rgb_history", "depth_history")  # what `rgb_features` and `depth_features` stand in for


def distance_to_continuous(distance: torch.Tensor, wypt_cfg) -> torch.Tensor:
    """Discrete distance index -> meters (reference waypoint_predictors.py:
    184-198)."""
    if wypt_cfg.continuous_distance:
        return distance
    range_dist = wypt_cfg.max_distance_prediction - wypt_cfg.min_distance_prediction
    meters_per = range_dist / (wypt_cfg.discrete_distances - 1)
    return wypt_cfg.min_distance_prediction + distance * meters_per


def offset_to_continuous(offset: torch.Tensor, wypt_cfg, num_panos: int) -> torch.Tensor:
    """Discrete offset index -> radians (reference waypoint_predictors.py:
    200-209)."""
    if wypt_cfg.continuous_offset:
        return offset
    radians_per_pano = 2 * math.pi / num_panos
    rad_per_offset = radians_per_pano / (wypt_cfg.discrete_offsets - 1)
    return (-radians_per_pano / 2) + offset * rad_per_offset


class TemperatureTanh(nn.Module):
    """`temperature_tanh` as a module: the continuous offset head's
    activation (reference models/utils.py:12-21)."""

    def __init__(self, temperature: float):
        super().__init__()
        self.temperature = temperature

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return temperature_tanh(x, self.temperature)


class WaypointPredictionNet(nn.Module):
    def __init__(self, model_config, num_panos: int = 12, depth_hw: Tuple[int, int] = (256, 256),
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        mc = self.model_config = model_config
        wc = mc.WAYPOINT
        H = mc.STATE_ENCODER.hidden_size
        self.num_panos = num_panos
        rgb_out, depth_out = mc.RGB_ENCODER.output_size, mc.DEPTH_ENCODER.output_size

        self.instruction_encoder = InstructionEncoder.from_config(mc.INSTRUCTION_ENCODER, final_state_only=False)
        # both backbones frozen, as the JAX module builds them (no `trainable`)
        self.rgb_encoder = TorchVisionResNetEncoder(
            version="resnet50" if mc.RGB_ENCODER.cnn_type == "TorchVisionResNet50" else "resnet18",
            normalize_visual_inputs=mc.normalize_rgb, single_spatial_filter=False, compute_dtype=compute_dtype,
        )
        self.depth_encoder = VlnResnetDepthEncoder(
            input_hw=depth_hw, backbone=mc.DEPTH_ENCODER.backbone, compute_dtype=compute_dtype,
        )
        rgb_c = self.rgb_encoder.output_shape[0]
        depth_c, dh, dw = self.depth_encoder.output_shape
        instr_c = self.instruction_encoder.output_size
        self.resnet_layer_size = self.rgb_encoder.resnet_layer_size
        dk = H // 2
        d_kv = rgb_out + depth_out + ANGLE_FEATURE_SIZE  # the pano attention's keys and values

        self.rgb_pool_linear = nn.Linear(self.resnet_layer_size, rgb_out)
        self.rgb_hist_linear = nn.Sequential(nn.AdaptiveAvgPool1d(1), nn.Flatten(), nn.Linear(rgb_c, rgb_out), nn.ReLU())
        self.depth_hist_linear = nn.Sequential(nn.Flatten(), nn.Linear(depth_c * dh * dw, depth_out), nn.ReLU())
        self.visual_rnn = RNNStateEncoder(rgb_out + PREV_ACTION_DIM + rgb_out + depth_out, H, mc.STATE_ENCODER.rnn_type)

        self.inst_attn_q = nn.Sequential(nn.Linear(H, dk), nn.ReLU())
        self.inst_attn_k = nn.Conv1d(instr_c, dk, 1)
        self.text_q_linear = nn.Linear(instr_c, dk)
        self.rgb_kv_spatial = nn.Conv1d(rgb_c, dk + rgb_out, 1)
        self.depth_kv_spatial = nn.Conv1d(depth_c, dk + depth_out, 1)
        self.pano_attn = MultiHeadDotProductAttention(
            instr_c, d_kv, d_kv, d_qk=PANO_ATTN_KEY_DIM, d_v=PANO_ATTN_KEY_DIM, num_heads=1, d_out=d_kv,
        )

        self.main_state_compress = nn.Sequential(nn.Linear(instr_c + d_kv + H + PREV_ACTION_DIM, H), nn.ReLU())
        self.main_state_encoder = RNNStateEncoder(H, H, mc.STATE_ENCODER.rnn_type)

        self.compress_x_linear = nn.Sequential(nn.Linear(H, d_kv), nn.ReLU())
        self.stop_linear = nn.Linear(H, 1)
        head_in = d_kv + H
        if wc.continuous_distance:
            self.distance_linear = nn.Sequential(nn.Linear(head_in, 1), nn.Sigmoid())
            self.distance_var_linear = nn.Sequential(nn.Linear(head_in, 1), nn.Sigmoid())
        else:
            self.distance_linear = nn.Linear(head_in, wc.discrete_distances)
        if wc.continuous_offset:
            self.offset_linear = nn.Sequential(nn.Linear(head_in, 1), TemperatureTanh(wc.offset_temperature))
            self.offset_var_linear = nn.Sequential(nn.Linear(head_in, 1), nn.Sigmoid())
        else:
            self.offset_linear = nn.Linear(head_in, wc.discrete_offsets)

    @property
    def hidden_size(self) -> int:
        return self.model_config.STATE_ENCODER.hidden_size

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        init_default(self, generator)
        self.instruction_encoder.reset_parameters(generator)
        self.visual_rnn.rnn.reset_parameters(generator)
        self.main_state_encoder.rnn.reset_parameters(generator)

    def backbone_features(self) -> Dict[str, torch.Tensor]:
        """The frozen backbones' outputs of the last forward that ran them,
        {"rgb", "depth"} each [B, 13, C, h, w] in the compute dtype (the 12
        pano views, then the masked history frame): what `forward` takes as
        `rgb_features` and `depth_features` in place of the frames."""
        P1 = self.num_panos + 1
        return {k: enc.cached_features.reshape((-1, P1) + tuple(enc.cached_features.shape[1:]))
                for k, enc in (("rgb", self.rgb_encoder), ("depth", self.depth_encoder))}

    def forward(self, observations, rnn_states, prev_actions: Dict[str, torch.Tensor], masks,
                seq_len: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Single-step mode (seq_len None): every tensor has leading dim B,
        rnn_states [B, L, H]. Sequence mode (seq_len = T): observations,
        prev_actions and masks are time-major flattened [T*n, ...],
        rnn_states [n, L, H]. With `rgb_features` and `depth_features` in
        the observations (`backbone_features` of earlier forwards over the
        same frames) the frozen backbones are not run and the frames are not
        read. Returns the heads' outputs, the features `x` the critic reads
        and the new [B, L, H] states."""
        mc = self.model_config
        wc = mc.WAYPOINT
        P = self.num_panos
        B = observations["angle_features"].shape[0]
        masks = masks.reshape(B, 1).float()

        instruction_embedding = self.instruction_encoder(observations)  # [B, C_t, T_text]

        # -- pano + history frames through the frozen CNNs, or their stored outputs
        if "rgb_features" in observations:
            rgb_in = {"rgb_features": observations["rgb_features"].flatten(0, 1)}
            depth_in = {"depth_features": observations["depth_features"].flatten(0, 1)}
        else:
            m = masks.reshape(B, 1, 1, 1)
            rgb = torch.cat([observations["rgb"], (observations["rgb_history"] * m.to(observations["rgb_history"].dtype))[:, None]], dim=1)
            depth = torch.cat([observations["depth"], (observations["depth_history"] * m)[:, None]], dim=1)
            rgb_in, depth_in = {"rgb": rgb.flatten(0, 1)}, {"depth": depth.flatten(0, 1)}
        rgb_embedding = self.rgb_encoder(rgb_in).float()
        rgb_embedding = rgb_embedding.reshape(B, P + 1, rgb_embedding.shape[1], -1)  # [B, 13, C_r, 16]
        depth_embedding = self.depth_encoder(depth_in).float()
        depth_embedding = depth_embedding.reshape(B, P + 1, depth_embedding.shape[1], -1)  # [B, 13, C_d, h*w]

        rgb_history, rgb_embedding = rgb_embedding[:, P], rgb_embedding[:, :P]
        depth_history, depth_embedding = depth_embedding[:, P], depth_embedding[:, :P]

        # -- prev action featurization: [sin, cos, offset, distance] * mask -
        pano_prev = prev_actions["pano"].reshape(B, 1).float()
        delta_rot = 2 * math.pi / P
        prev_action_feats = torch.cat([
            torch.sin(pano_prev * delta_rot), torch.cos(pano_prev * delta_rot),
            offset_to_continuous(prev_actions["offset"].reshape(B, 1).float(), wc, P),
            distance_to_continuous(prev_actions["distance"].reshape(B, 1).float(), wc),
        ], dim=1) * masks

        if mc.ablate_instruction:
            instruction_embedding = instruction_embedding * 0
        if mc.ablate_rgb:
            rgb_embedding = rgb_embedding * 0
            rgb_history = rgb_history * 0
        if mc.ablate_depth:
            depth_embedding = depth_embedding * 0
            depth_history = depth_history * 0

        # -- visual history GRU ---------------------------------------------
        # mean-pool each pano frame's backbone channels (not the spatial ones)
        pooled = self.rgb_pool_linear(rgb_embedding[:, :, : self.resnet_layer_size].mean(dim=3))  # [B, 12, out]
        rgb_pooled = pooled.mean(dim=1)
        rnn_in = torch.cat([rgb_pooled, prev_action_feats, self.rgb_hist_linear(rgb_history),
                            self.depth_hist_linear(depth_history)], dim=1)

        def run_rnn(rnn, x, states):
            if seq_len is None:
                return rnn(x, states, masks)
            n = x.shape[0] // seq_len
            out, s = rnn(x.reshape(seq_len, n, -1), states, masks.reshape(seq_len, n, 1))
            return out.reshape(seq_len * n, -1), s

        L1 = self.visual_rnn.num_recurrent_layers
        visual_hist_feats, rnn1_out = run_rnn(self.visual_rnn, rnn_in, rnn_states[:, :L1])

        # -- instruction attention ------------------------------------------
        dk = self.hidden_size // 2
        scale = 1.0 / math.sqrt(dk)
        text_mask = torch.logical_not((instruction_embedding == 0.0).all(dim=1))
        text_embedding = scaled_dot_attn(
            self.inst_attn_q(visual_hist_feats), self.inst_attn_k(instruction_embedding), instruction_embedding,
            scale, text_mask, mask_mode="multiplicative",
        )

        # -- spatial attention per pano frame -------------------------------
        text_q_rep = self.text_q_linear(text_embedding).repeat_interleave(P, dim=0)  # [B*12, dk]
        rgb_kv = self.rgb_kv_spatial(rgb_embedding.reshape(B * P, rgb_embedding.shape[2], -1))
        depth_kv = self.depth_kv_spatial(depth_embedding.reshape(B * P, depth_embedding.shape[2], -1))
        spatial_rgb = scaled_dot_attn(text_q_rep, rgb_kv[:, :dk], rgb_kv[:, dk:], scale).reshape(B, P, -1)
        spatial_depth = scaled_dot_attn(text_q_rep, depth_kv[:, :dk], depth_kv[:, dk:], scale).reshape(B, P, -1)

        # -- pano attention (MHA over the 12 frames) ------------------------
        shared = torch.cat([spatial_rgb, spatial_depth, observations["angle_features"].float()], dim=2)  # [B, 12, d_kv]
        shared_cf = shared.transpose(1, 2)
        attended_pano = self.pano_attn(text_embedding, shared_cf, shared_cf)

        # -- main GRU --------------------------------------------------------
        x = self.main_state_compress(torch.cat([text_embedding, attended_pano, visual_hist_feats, prev_action_feats], dim=1))
        x, rnn2_out = run_rnn(self.main_state_encoder, x, rnn_states[:, L1:])
        rnn_states_out = torch.cat([rnn1_out, rnn2_out], dim=1)

        # -- output heads ----------------------------------------------------
        dotted = (shared * self.compress_x_linear(x)[:, None, :]).sum(dim=2)  # [B, 12]
        pano_stop_logits = torch.cat([dotted, self.stop_linear(x)], dim=1)  # [B, 13]
        catted = torch.cat([shared, x[:, None, :].expand(B, P, x.shape[-1])], dim=2)  # [B, 12, d_kv + H]

        if wc.continuous_distance:
            d1 = self.distance_linear(catted).squeeze(2)
            d1 = (wc.max_distance_prediction - wc.min_distance_prediction) * d1 + wc.min_distance_prediction
            d2 = (wc.max_distance_var - wc.min_distance_var) * self.distance_var_linear(catted).squeeze(2) + wc.min_distance_var
        else:
            d1, d2 = self.distance_linear(catted), None
        if wc.continuous_offset:
            o1 = (math.pi / P) * self.offset_linear(catted).squeeze(2)
            o2 = (wc.max_offset_var - wc.min_offset_var) * self.offset_var_linear(catted).squeeze(2) + wc.min_offset_var
        else:
            o1, o2 = self.offset_linear(catted), None

        return {
            "pano_stop_logits": pano_stop_logits,
            "offset_var1": o1,
            "offset_var2": o2,
            "distance_var1": d1,
            "distance_var2": d2,
            "features": x,
            "rnn_states": rnn_states_out,
        }
