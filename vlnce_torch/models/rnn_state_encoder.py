"""Masked recurrent state encoders (port of
vlnce_tpu/models/rnn_state_encoder.py; habitat's build_rnn_state_encoder as
used at reference vlnce_baselines/models/cma_policy.py:10-12,126-131).

Two call modes:
- single step: x [B, D], masks [B, 1]; the hidden state is zeroed where
  mask == 0, then one cell update. Used by act() in eval/rollout loops.
- sequence: x [T, B, D], masks [T, B, 1]; per-step resets `h *= mask`.

The input projection for all timesteps is one matmul; the recurrence of a
GRU runs as the `gru_sequence` kernel in both modes (the single step is the
kernel at T=1) and is differentiable: on the card its gradient is the
kernel's own backward kernel, on the CPU autograd through the plain loop. The
LSTM, which no kernel covers, runs as a plain loop.

Hidden-state layout is habitat's [B, L, H] with L = num_recurrent_layers
(2 for LSTM: h then c). Parameters use torch's names and layout under
`.rnn` (weight_ih_l0 [gates*H, D], weight_hh_l0, bias_ih_l0, bias_hh_l0), so
reference state_dicts load by name.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vlnce_torch.models.initializers import lecun_normal_
from vlnce_torch.ops.rnn import gru_sequence


class RNNParams(nn.Module):
    """A single-layer torch RNN's parameters, by torch's names."""

    def __init__(self, input_size: int, hidden_size: int, gates: int):
        super().__init__()
        self.weight_ih_l0 = nn.Parameter(torch.empty(gates * hidden_size, input_size))
        self.weight_hh_l0 = nn.Parameter(torch.empty(gates * hidden_size, hidden_size))
        self.bias_ih_l0 = nn.Parameter(torch.zeros(gates * hidden_size))
        self.bias_hh_l0 = nn.Parameter(torch.zeros(gates * hidden_size))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        # flax lecun_normal on the [gates*H, D] kernel counts fan_in = gates*H
        lecun_normal_(self.weight_ih_l0, generator, fan_in=self.weight_ih_l0.shape[0])
        nn.init.orthogonal_(self.weight_hh_l0, generator=generator)
        self.bias_ih_l0.zero_()
        self.bias_hh_l0.zero_()


def lstm_step(xi, h, c, w_hh, b_hh):
    """One LSTM cell update in torch gate order (i, f, g, o)."""
    i, f, g, o = (xi + F.linear(h, w_hh, b_hh)).chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


class RNNStateEncoder(nn.Module):
    def __init__(self, input_size: int, hidden_size: int, rnn_type: str = "GRU"):
        super().__init__()
        if rnn_type not in ("GRU", "LSTM"):
            raise ValueError(f"unsupported rnn_type {rnn_type}")
        self.rnn_type = rnn_type
        self.hidden_size = hidden_size
        self.rnn = RNNParams(input_size, hidden_size, 3 if rnn_type == "GRU" else 4)

    @property
    def num_recurrent_layers(self) -> int:
        """Slots in the packed [B, L, H] state (habitat convention: LSTM
        counts h and c)."""
        return 2 if self.rnn_type == "LSTM" else 1

    def project_inputs(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.rnn.weight_ih_l0, self.rnn.bias_ih_l0)

    def _gru(self, xi, states, masks):
        # every tensor here is f32 (`.float()` is then a no-op) and contiguous
        # but the state: gru_sequence takes the strided states[:, 0] as it is
        return gru_sequence(
            xi.float(), masks.float(), states[:, 0].float(), self.rnn.weight_hh_l0.float(), self.rnn.bias_hh_l0.float()
        )

    def _lstm(self, xi, states, masks):
        h, c = states[:, 0], states[:, 1]
        outs = []
        for t in range(xi.shape[0]):
            h, c = h * masks[t], c * masks[t]
            h, c = lstm_step(xi[t], h, c, self.rnn.weight_hh_l0, self.rnn.bias_hh_l0)
            outs.append(h)
        return torch.stack(outs), torch.stack([h, c], dim=1)

    def forward(self, x: torch.Tensor, states: torch.Tensor, masks: torch.Tensor):
        """x: [B, D] (step) or [T, B, D] (sequence); states: [B, L, H];
        masks: [B, 1] or [T, B, 1]. Returns (output, new_states) with output
        [B, H] or [T, B, H]."""
        single = x.dim() == 2
        if single:
            x = x[None]
        T, B, _ = x.shape
        xi = self.project_inputs(x.reshape(T * B, -1)).reshape(T, B, -1)
        masks = masks.reshape(T, B, 1).to(xi.dtype)
        if self.rnn_type == "GRU":
            outs = self._gru(xi, states, masks)
            new_states = outs[-1][:, None, :]
        else:
            outs, new_states = self._lstm(xi, states, masks)
        return (outs[0] if single else outs), new_states

