"""Discrete-action imitation policy base (port of vlnce_tpu/models/policy.py;
reference vlnce_baselines/models/policy.py:10-58).

The policy is an `nn.Module`: `forward(observations, rnn_states,
prev_actions, masks)` returns (logits, new rnn_states, aux), and `act` draws
the action from those logits. It runs eagerly; a CUDA graph of the act step
is later work. With `seq_len=T` the forward takes time-major flattened
[T*N, ...] inputs (`build_distribution_logits`, the IL train step).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vlnce_torch.models.distributions import Categorical


def config_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}[name]


class CategoricalNet(nn.Module):
    """Linear action head (the JAX package's `categorical_head`) with
    habitat CategoricalNet init (orthogonal gain 0.01, zero bias); key names
    action_distribution.linear.*."""

    def __init__(self, num_inputs: int, num_outputs: int):
        super().__init__()
        self.linear = nn.Linear(num_inputs, num_outputs)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.orthogonal_(self.linear.weight, gain=0.01, generator=generator)
        self.linear.bias.zero_()

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        return self.linear(features.float())


class ILPolicy(nn.Module):
    """Discrete-action imitation policy (Seq2Seq / CMA)."""

    def __init__(self, config, observation_space, num_actions: int):
        super().__init__()
        self.config = config
        self.observation_space = observation_space
        self.num_actions = num_actions

    @classmethod
    def num_recurrent_layers_from_config(cls, config) -> int:
        raise NotImplementedError

    @classmethod
    def from_config(cls, config, observation_space, action_space):
        """Build on `config.CUDA.DEVICE`, with weights drawn from a generator
        seeded with `config.TASK_CONFIG.SEED`."""
        policy = cls(config, observation_space, int(action_space.n))
        policy.reset_parameters(torch.Generator().manual_seed(int(config.TASK_CONFIG.SEED)))
        device = torch.device(config.CUDA.DEVICE)
        policy = policy.to(device)
        if device.type == "cuda":
            policy = policy.to(memory_format=torch.channels_last)
        # the policy stays in eval() while it trains as well: no module of it
        # has a training mode (BatchNorm is frozen to its running statistics,
        # GroupNorm has none, dropout is absent), so train() would change
        # nothing, and eval() says so
        return policy.eval()

    def reset_parameters(self, generator: torch.Generator) -> None:
        raise NotImplementedError

    @property
    def num_recurrent_layers(self) -> int:
        return self.num_recurrent_layers_from_config(self.config)

    @property
    def hidden_size(self) -> int:
        return int(self.config.MODEL.STATE_ENCODER.hidden_size)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def initial_rnn_states(self, batch_size: int) -> torch.Tensor:
        return torch.zeros(batch_size, self.num_recurrent_layers, self.hidden_size, device=self.device)

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters()) + sum(b.numel() for b in self.buffers())

    @torch.no_grad()
    def act(self, observations, rnn_states, prev_actions, masks, deterministic: bool = False,
            generator: Optional[torch.Generator] = None):
        """Returns (action [B, 1], new rnn_states, logits [B, A]): the JAX
        package's (action, rnn_states) and the logits the action came from."""
        logits, rnn_states_out, _ = self(observations, rnn_states, prev_actions, masks)
        dist = Categorical(logits)
        action = dist.mode() if deterministic else dist.sample(generator)
        return action, rnn_states_out, logits

    @torch.no_grad()
    def act_with_features(self, observations, rnn_states, prev_actions, masks, deterministic: bool = False,
                          generator: Optional[torch.Generator] = None):
        """`act` that also hands back the visual backbones' outputs of this
        forward as {"rgb_features", "depth_features"} (each [B, C, h, w]; a
        key is absent where the observations bypassed that backbone): what
        DAgger collection stores in place of the frames. Returns (action,
        new rnn_states, features)."""
        action, rnn_states_out, _ = self.act(observations, rnn_states, prev_actions, masks, deterministic, generator)
        return action, rnn_states_out, self.visual_features()

    def visual_features(self):
        """The visual backbones' outputs of the last forward, as
        `act_with_features` hands them back."""
        feats = {}
        for encoder, key in ((self.net.rgb_encoder, "rgb_features"), (self.net.depth_encoder, "depth_features")):
            if encoder.cached_features is not None:
                feats[key] = encoder.cached_features
        return feats

    def build_distribution_logits(self, observations_flat, rnn_states, prev_actions, masks, T: int):
        """observations_flat: [T*N, ...] time-major flattened; returns
        (logits [T*N, A], rnn_states_out, aux). Eager PyTorch needs no cache
        of compiled programs per T."""
        return self(observations_flat, rnn_states, prev_actions, masks, seq_len=T)
