"""Instruction encoder: token-embedding or BERT-feature path + masked RNN
(port of vlnce_tpu/models/encoders/instruction_encoder.py; reference
vlnce_baselines/models/encoders/instruction_encoder.py:11-94).

Packed-sequence semantics without a host round trip for the lengths: each
direction runs torch's fused RNN over the padded batch, and only steps
t < length count. The forward direction's outputs before a row's length do
not depend on what follows, and its final state is its output at
length - 1. The backward direction runs over each row reversed *within its
length*, exactly like pack_padded_sequence, and is reversed back. Outputs
past the length are exactly zero, which CMANet's text mask relies on.

Output:
- final_state_only=True  -> [B, H * num_directions] (final hidden)
- final_state_only=False -> [B, H * num_directions, T] (full outputs,
  channel-first to match the reference's .permute(0, 2, 1))

Parameters are the reference's: embedding_layer.weight and a torch RNN's
encoder_rnn.{weight_ih,weight_hh,bias_ih,bias_hh}_l0[_reverse].
"""

from __future__ import annotations

import torch
from torch import nn

from vlnce_torch.models.initializers import lecun_normal_


def reverse_within_length(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """x: [B, T, E] -> x' with x'[b, t] = x[b, len_b - 1 - t] for t < len_b
    (and x'[b, t] = x[b, t] past the length)."""
    T = x.shape[1]
    t_idx = torch.arange(T, device=x.device)[None, :]
    idx = torch.where(t_idx < lengths[:, None], lengths[:, None] - 1 - t_idx, t_idx)
    return torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))


class InstructionEncoder(nn.Module):
    """Fields mirror MODEL.INSTRUCTION_ENCODER (reference
    vlnce_baselines/config/default.py:222-237). `input_size` is the BERT
    feature width for the feature path (the token path uses
    embedding_size)."""

    def __init__(self, vocab_size: int = 2504, embedding_size: int = 50, hidden_size: int = 128,
                 rnn_type: str = "LSTM", final_state_only: bool = True, bidirectional: bool = False,
                 sensor_uuid: str = "instruction", input_size: int = None,
                 use_pretrained_embeddings: bool = True, fine_tune_embeddings: bool = False):
        super().__init__()
        self.hidden_size = hidden_size
        self.rnn_type = rnn_type
        self.final_state_only = final_state_only
        self.bidirectional = bidirectional
        self.sensor_uuid = sensor_uuid
        if sensor_uuid == "instruction":
            self.embedding_layer = nn.Embedding(vocab_size, embedding_size, padding_idx=0)
            # reference semantics (instruction_encoder.py:35-45): only a
            # pretrained table is frozen (unless fine-tuned); a fresh
            # Gaussian-initialized table always trains
            if use_pretrained_embeddings and not fine_tune_embeddings:
                self.embedding_layer.weight.requires_grad_(False)
            input_size = embedding_size
        rnn_cls = {"LSTM": nn.LSTM, "GRU": nn.GRU}[rnn_type]
        self.encoder_rnn = rnn_cls(input_size, hidden_size, batch_first=True, bidirectional=bidirectional)

    @property
    def output_size(self) -> int:
        return self.hidden_size * (2 if self.bidirectional else 1)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.sensor_uuid == "instruction":
            nn.init.normal_(self.embedding_layer.weight, 0.0, 1.0, generator=generator)
        for suffix in ("", "_reverse") if self.bidirectional else ("",):
            w_ih = getattr(self.encoder_rnn, f"weight_ih_l0{suffix}")
            lecun_normal_(w_ih, generator, fan_in=w_ih.shape[0])  # flax counts gates*H
            nn.init.orthogonal_(getattr(self.encoder_rnn, f"weight_hh_l0{suffix}"), generator=generator)
            getattr(self.encoder_rnn, f"bias_ih_l0{suffix}").zero_()
            getattr(self.encoder_rnn, f"bias_hh_l0{suffix}").zero_()

    def _direction(self, x: torch.Tensor, lengths: torch.Tensor, suffix: str):
        """Outputs [B, T, H] (zero past each length) and final state [B, H]."""
        B, T, _ = x.shape
        params = [getattr(self.encoder_rnn, f"{n}_l0{suffix}") for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
        h0 = x.new_zeros(1, B, self.hidden_size)
        # the `train` flag changes no value (dropout is 0): cuDNN keeps what its
        # backward needs only when it is set
        train = torch.is_grad_enabled()
        if self.rnn_type == "LSTM":
            outs = torch.lstm(x, (h0, h0), params, True, 1, 0.0, train, False, True)[0]
        else:
            outs = torch.gru(x, h0, params, True, 1, 0.0, train, False, True)[0]
        valid = (torch.arange(T, device=x.device)[None, :] < lengths[:, None]).to(outs.dtype)
        last = (lengths - 1).clamp(min=0)
        final = outs[torch.arange(B, device=x.device), last] * (lengths > 0).to(outs.dtype)[:, None]
        return outs * valid[:, :, None], final

    def forward(self, observations) -> torch.Tensor:
        if self.sensor_uuid == "instruction":
            tokens = observations["instruction"].long()  # [B, T]
            lengths = (tokens != 0).sum(dim=1)
            x = self.embedding_layer(tokens)
        else:
            x = observations[self.sensor_uuid].float()  # [B, T, 768] BERT features
            lengths = ((x != 0.0).sum(dim=2) != 0).sum(dim=1)

        out, final = self._direction(x, lengths, "")
        if self.bidirectional:
            bwd_rev, bwd_final = self._direction(reverse_within_length(x, lengths), lengths, "_reverse")
            out = torch.cat([out, reverse_within_length(bwd_rev, lengths)], dim=2)
            final = torch.cat([final, bwd_final], dim=1)

        if self.final_state_only:
            return final  # [B, H*dirs]
        return out.permute(0, 2, 1)  # [B, H*dirs, T]

    @classmethod
    def from_config(cls, config, input_size: int = None, **overrides) -> "InstructionEncoder":
        kw = dict(
            vocab_size=config.vocab_size,
            embedding_size=config.embedding_size,
            hidden_size=config.hidden_size,
            rnn_type=config.rnn_type,
            final_state_only=config.final_state_only,
            bidirectional=config.bidirectional,
            sensor_uuid=config.sensor_uuid,
            input_size=input_size,
            use_pretrained_embeddings=config.use_pretrained_embeddings,
            fine_tune_embeddings=config.fine_tune_embeddings,
        )
        kw.update(overrides)
        return cls(**kw)
