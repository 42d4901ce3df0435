"""Waypoint policy (ICCV'21 actor-critic agent), port of
vlnce_tpu/models/waypoint_policy.py (reference
vlnce_baselines/models/waypoint_policy.py:19-347).

A categorical over the 12 panos + STOP; per-pano distance and offset heads as
TruncatedNormal (continuous) or categorical (discrete); the joint log-prob is
the pano's plus the distance's and offset's where the action is no STOP (and
the head is not ablated); per-component entropies for WDDPPO. `act` returns
fixed-shape tensors (stop flag, r, theta, log-probs, value, ...) on the
policy's device; `actions_to_env` decodes them on the host into the env's
dict actions {"action": "GO_TOWARD_POINT", "action_args": {r, theta}}.

As in the IL policies, the policy is the module and the handle at once:
`net` is the WaypointPredictionNet and `critic.fc` the value head.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from vlnce_torch.models.distributions import Categorical, TruncatedNormal, batched_index_select
from vlnce_torch.models.policy import config_dtype
from vlnce_torch.models.waypoint_predictors import (
    WaypointPredictionNet,
    distance_to_continuous,
    offset_to_continuous,
)
from vlnce_torch.registry import registry


def _gather_pano(x: torch.Tensor, pano: torch.Tensor) -> torch.Tensor:
    """x: [B, P] (or [B, P, K]); pano: [B, 1] -> the row's pano column
    ([B, 1], or [B, K])."""
    if x.dim() == 2:
        return torch.gather(x, 1, pano.long())
    return batched_index_select(x, 1, pano.squeeze(-1))


class CriticHead(nn.Module):
    """The value head, by the reference's name `critic.fc`."""

    def __init__(self, input_size: int):
        super().__init__()
        self.fc = nn.Linear(input_size, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(x)


@registry.register_policy(name="WaypointPolicy")
class WaypointPolicy(nn.Module):
    def __init__(self, config, observation_space, num_panos: int):
        super().__init__()
        self.config = config
        self.wypt_cfg = config.MODEL.WAYPOINT
        self.observation_space = observation_space
        self.num_panos = num_panos
        self._offset_limit = math.pi / num_panos
        self.net = WaypointPredictionNet(
            config.MODEL, num_panos=num_panos, depth_hw=tuple(observation_space["depth"].shape[1:3]),
            compute_dtype=config_dtype(config.CUDA.PRECISION.compute_dtype),
        )
        self.critic = CriticHead(config.MODEL.STATE_ENCODER.hidden_size)

    # -- construction --------------------------------------------------------
    @classmethod
    def from_config(cls, config, observation_space, action_space=None):
        """Build on `config.CUDA.DEVICE`, with weights drawn from a generator
        seeded with `config.TASK_CONFIG.SEED`."""
        policy = cls(config, observation_space, int(config.TASK_CONFIG.TASK.PANO_ROTATIONS))
        policy.reset_parameters(torch.Generator().manual_seed(int(config.TASK_CONFIG.SEED)))
        device = torch.device(config.CUDA.DEVICE)
        policy = policy.to(device)
        if device.type == "cuda":
            policy = policy.to(memory_format=torch.channels_last)
        # no module of the policy has a training mode (frozen BatchNorm, no
        # dropout), so it stays in eval() while it trains as well
        return policy.eval()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.net.reset_parameters(generator)
        nn.init.orthogonal_(self.critic.fc.weight, gain=1.0, generator=generator)
        self.critic.fc.bias.zero_()

    @property
    def num_recurrent_layers(self) -> int:
        return 2 if self.config.MODEL.STATE_ENCODER.rnn_type == "GRU" else 4

    @property
    def hidden_size(self) -> int:
        return int(self.config.MODEL.STATE_ENCODER.hidden_size)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def initial_rnn_states(self, batch_size: int) -> torch.Tensor:
        return torch.zeros(batch_size, self.num_recurrent_layers, self.hidden_size, device=self.device)

    def initial_prev_actions(self, batch_size: int) -> Dict[str, torch.Tensor]:
        return {k: torch.zeros(batch_size, 1, device=self.device) for k in ("pano", "offset", "distance")}

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters()) + sum(b.numel() for b in self.buffers())

    def forward(self, observations, rnn_states, prev_actions, masks, seq_len: Optional[int] = None):
        """The network's outputs (see WaypointPredictionNet.forward) with the
        critic's `value` [B, 1]."""
        out = self.net(observations, rnn_states, prev_actions, masks, seq_len)
        out["value"] = self.critic(out["features"])
        return out

    # -- distribution builders ----------------------------------------------
    def _distance_distribution(self, d1, d2, pano):
        if self.wypt_cfg.continuous_distance:
            return TruncatedNormal(
                _gather_pano(d1, pano), torch.sqrt(_gather_pano(d2, pano)),
                self.wypt_cfg.min_distance_prediction, self.wypt_cfg.max_distance_prediction,
            )
        return Categorical(_gather_pano(d1, pano))

    def _offset_distribution(self, o1, o2, pano):
        if self.wypt_cfg.continuous_offset:
            return TruncatedNormal(
                _gather_pano(o1, pano), torch.sqrt(_gather_pano(o2, pano)), -self._offset_limit, self._offset_limit,
            )
        return Categorical(_gather_pano(o1, pano))

    # -- act -----------------------------------------------------------------
    @torch.no_grad()
    def act(self, observations, rnn_states, prev_actions, masks, deterministic: bool = False,
            generator: Optional[torch.Generator] = None, uniforms: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """One step: the pano/STOP choice, then the distance and the offset at
        that pano (modes, or draws from `generator` in that order). With
        `uniforms` [3, B] in [0, 1), a sampled step draws nothing: the pano,
        the distance and the offset are each distribution's inverse CDF at
        rows 0, 1 and 2 (no host synchronisation, so the step can be captured
        in a CUDA graph). Returns the JAX package's act dict: value, stop, r,
        theta, action_elements {pano, offset, distance}, modes, variances,
        action_log_probs, rnn_states, pano_stop_logits."""
        wc = self.wypt_cfg
        out = self(observations, rnn_states, prev_actions, masks)

        def draw(dist, row):
            if deterministic:
                return dist.mode()
            if uniforms is None:
                return dist.sample(generator)
            if isinstance(dist, TruncatedNormal):
                return dist.draw(uniforms[row].reshape(-1, 1))
            return dist.icdf(uniforms[row])

        pano_dist = Categorical(out["pano_stop_logits"])
        pano_stop = draw(pano_dist, 0)  # [B, 1]
        stop = (pano_stop == self.num_panos).int()
        pano = pano_stop % self.num_panos

        d_dist = self._distance_distribution(out["distance_var1"], out["distance_var2"], pano)
        o_dist = self._offset_distribution(out["offset_var1"], out["offset_var2"], pano)

        distance = draw(d_dist, 1).float()
        distance_log_prob = d_dist.log_prob(distance)
        action_distance = distance_to_continuous(distance, wc)
        d_var = d_dist.variance if wc.continuous_distance else torch.zeros_like(action_distance)
        d_mode = d_dist.mode()

        offset = draw(o_dist, 2).float()
        offset_log_prob = o_dist.log_prob(offset)
        action_offset = offset_to_continuous(offset, wc, self.num_panos)
        o_var = o_dist.variance if wc.continuous_offset else torch.zeros_like(action_offset)
        o_mode = o_dist.mode()

        if not wc.predict_offset:  # ablation (reference:96-103)
            action_offset = torch.zeros_like(action_offset)
            offset = torch.zeros_like(offset)
            o_var = torch.zeros_like(o_var)
        if not wc.predict_distance:  # ablation (reference:119-125)
            action_distance = torch.zeros_like(action_distance) + 0.25
            distance = torch.zeros_like(distance) + (0.25 if wc.continuous_distance else 0.0)
            d_var = torch.zeros_like(d_var)

        action_log_probs = pano_dist.log_prob(pano_stop)
        pano_mask = (pano_stop != self.num_panos).to(action_log_probs.dtype)
        if wc.predict_distance:
            action_log_probs = action_log_probs + pano_mask * distance_log_prob
        if wc.predict_offset:
            action_log_probs = action_log_probs + pano_mask * offset_log_prob

        radians_per_pano = 2 * math.pi / self.num_panos
        theta = torch.remainder(pano.float() * radians_per_pano + action_offset, 2 * math.pi)
        return {
            "value": out["value"],
            "stop": stop,
            "r": action_distance,
            "theta": theta,
            "action_elements": {"pano": pano_stop.float(), "offset": offset, "distance": distance},
            "modes": {"offset": o_mode, "distance": d_mode},
            "variances": {"offset": o_var, "distance": d_var},
            "action_log_probs": action_log_probs,
            "rnn_states": out["rnn_states"],
            "pano_stop_logits": out["pano_stop_logits"],
        }

    @staticmethod
    def actions_to_env(act_out) -> List[Dict[str, Any]]:
        """Decode the act step's fixed-shape outputs into env action dicts
        (reference waypoint_policy.py:191-208). Downloads stop, r and theta."""
        stop, r, theta = (np.asarray(act_out[k].detach().cpu()).reshape(-1) for k in ("stop", "r", "theta"))
        actions = []
        for i in range(len(stop)):
            if stop[i]:
                actions.append({"action": "STOP"})
            else:
                actions.append(
                    {"action": {"action": "GO_TOWARD_POINT", "action_args": {"r": float(r[i]), "theta": float(theta[i])}}}
                )
        return actions

    # -- value / evaluate ----------------------------------------------------
    @torch.no_grad()
    def get_value(self, observations, rnn_states, prev_actions, masks) -> torch.Tensor:
        return self(observations, rnn_states, prev_actions, masks)["value"]

    def evaluate_actions(self, observations, rnn_states, prev_actions, masks, action_components,
                         seq_len: Optional[int] = None):
        """(value [B, 1], action_log_probs [B, 1], entropy {pano, offset,
        distance} each [B], new rnn_states) of the stored actions, under the
        caller's grad mode; with `seq_len`, inputs as the sequence mode
        takes them."""
        wc = self.wypt_cfg
        out = self(observations, rnn_states, prev_actions, masks, seq_len)
        pano_dist = Categorical(out["pano_stop_logits"])
        pano_stop = action_components["pano"]
        pano_log_probs = pano_dist.log_prob(pano_stop)

        idx = pano_stop.long() % self.num_panos
        d_dist = self._distance_distribution(out["distance_var1"], out["distance_var2"], idx)
        o_dist = self._offset_distribution(out["offset_var1"], out["offset_var2"], idx)

        pano_mask = (pano_stop != self.num_panos).to(pano_log_probs.dtype)
        d_mask = pano_mask * float(bool(wc.predict_distance))
        o_mask = pano_mask * float(bool(wc.predict_offset))
        action_log_probs = (pano_log_probs + d_mask * d_dist.log_prob(action_components["distance"])
                            + o_mask * o_dist.log_prob(action_components["offset"]))

        def _ent2d(e):
            return e if e.dim() == 2 else e[:, None]

        entropy = {
            "pano": pano_dist.entropy(),
            "offset": (o_mask * _ent2d(o_dist.entropy())).squeeze(-1),
            "distance": (d_mask * _ent2d(d_dist.entropy())).squeeze(-1),
        }
        return out["value"], action_log_probs, entropy, out["rnn_states"]
