"""The plain reference of the waypoint policy (Krantz et al., ICCV 2021,
"Waypoint Models for Instruction-guided Navigation in Continuous
Environments": WPN, the reference repo's `waypoint_predictors.py` and
`waypoint_policy.py`), and of the world it acts in, in plain PyTorch and
f32.

- `param_spec`: every parameter and buffer by the published model's
  state_dict names and shapes, with the distribution the benchmark draws
  it from (`benchmark/weights.make`).
- `encode`: the frozen backbones over a step's 13 frames (12 pano views
  and the history frame): the torchvision ResNet18 (frozen BatchNorm)
  over RGB, globally average pooled and broadcast to the 4x4 grid (the
  reference's `single_spatial_filter=False`), the DD-PPO GN-ResNet50 over
  depth (`reference/cma.gn_resnet50`), each with its learned spatial
  embedding appended as 64 channels.
- `step`: everything after them for one step of every row: the
  previous action featurised (sin, cos of the pano angle, offset,
  distance), the visual-history GRU, the instruction attention, spatial
  attention per pano frame, single-head attention over the panorama (with
  LayerNorm), the main GRU, the pano-stop logits (the panorama's features
  dotted with the state, and a stop logit), the distance and offset heads
  with bounded variances, and the critic.
- `evaluate`: the joint log-probability of taken actions (the pano's, plus
  the distance's and offset's unless STOP) and each component's entropy,
  with a categorical over 12 panos and STOP and two-sided truncated
  normals (`tn_log_prob`, `tn_entropy`: the textbook formulas).
- `cdf_gap`: how far a uniform lies outside the interval of the pano
  drawn from it by inverse CDF.
- `scene_field`, `waypoint_step`, `waypoint_reward`: the plain world of
  the waypoint task on `reference/grid.py`'s scenes: a goal's geodesic
  field by Dijkstra, GO_TOWARD_POINT (a straight, collision-filtered move
  toward (r, theta), sliding off, the agent turned toward the target) and
  the shaped reward (distance-scaled slack, progress, success bonus).

Departures from the reference repo, each a choice that changes no value:
its instruction encoder packs the sequence, here each direction runs over
the padded tokens and only steps before each length count (cma.instruction);
the attention's text mask multiplies the energies as its
DotProductAttention does, so padded positions enter the softmax with
energy 0; the truncated normal's log-probability is normalised by the
truncated mass, as its `TruncatedNormal.log_prob`. Its sampling is
rejection sampling, here and in the program an inverse CDF of a given
uniform, which `cdf_gap` checks.

Everything runs in f32 with TF32 off unless `cma.Precision` says
otherwise (the controls). Run it inside `cma.strict_f32()`. It imports
nothing of the program.
"""

from __future__ import annotations

import heapq
import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import cma, grid

PREV_ACTION_DIM = 4
ANGLE_DIM = 4
PANO_KEY_DIM = 128
RGB_CHANNELS = 512  # ResNet18's layer4


@dataclass(frozen=True)
class Arch:
    """The widths and ranges of one waypoint configuration."""

    hidden: int = 256
    rgb_out: int = 128
    depth_out: int = 128
    num_panos: int = 12
    depth_hw: int = 256
    vocab: int = 2504
    embed: int = 50
    instr_hidden: int = 128
    normalize_rgb: bool = False
    min_distance: float = 0.25
    max_distance: float = 4.0
    min_distance_var: float = 0.01
    max_distance_var: float = 3.516
    min_offset_var: float = 0.00030625
    max_offset_var: float = 0.06853892
    offset_temperature: float = 4.0

    @property
    def instr(self) -> cma.Arch:
        """The instruction encoder's and the depth trunk's widths, as
        reference/cma.py takes them."""
        return cma.Arch(num_actions=1, depth_hw=self.depth_hw, instr_tokens=True, vocab=self.vocab, embed=self.embed,
                        instr_hidden=self.instr_hidden)

    @property
    def depth_channels(self) -> int:
        return self.instr.depth_channels + 64

    @property
    def depth_positions(self) -> int:
        return self.instr.depth_spatial**2

    @property
    def kv(self) -> int:
        """The pano attention's key and value width: the spatially attended
        RGB and depth, and the pano's angle features."""
        return self.rgb_out + self.depth_out + ANGLE_DIM


# ------------------------------------------------------------------ spec
def _tv_resnet18_spec(prefix: str) -> List[Tuple]:
    out = [(f"{prefix}0.weight", (64, 3, 7, 7), "w", 3 * 49)] + cma._bn(f"{prefix}1", 64)
    cin = 64
    for li in range(4):
        planes = 64 * 2**li
        for b in range(2):
            p = f"{prefix}{li + 4}.{b}."
            out += [(p + "conv1.weight", (planes, cin, 3, 3), "w", cin * 9)] + cma._bn(p + "bn1", planes)
            out += [(p + "conv2.weight", (planes, planes, 3, 3), "w", planes * 9)] + cma._bn(p + "bn2", planes)
            if b == 0 and li > 0:
                out += [(p + "downsample.0.weight", (planes, cin, 1, 1), "w", cin)] + cma._bn(p + "downsample.1", planes)
            cin = planes
    return out


def _dense(p: str, d_out: int, d_in: int, kernel: Tuple = (), bias: bool = True) -> List[Tuple]:
    out = [(f"{p}.weight", (d_out, d_in) + kernel, "w", d_in)]
    return out + ([(f"{p}.bias", (d_out,), "bias", 0)] if bias else [])


def param_spec(arch: Arch) -> List[Tuple[str, Tuple[int, ...], str, int]]:
    """(name, shape, kind, fan_in) of every tensor of the policy's
    state_dict, kinds as `cma.param_spec`'s."""
    H, kv = arch.hidden, arch.kv
    instr_c = 2 * arch.instr_hidden
    spec: List[Tuple] = [("net.instruction_encoder.embedding_layer.weight", (arch.vocab, arch.embed), "emb", 0)]
    spec += cma._lstm_spec("net.instruction_encoder.encoder_rnn.", arch.embed, arch.instr_hidden)
    spec += _tv_resnet18_spec("net.rgb_encoder.cnn.")
    spec.append(("net.rgb_encoder.spatial_embeddings.weight", (16, 64), "emb", 0))
    spec += cma._gn_resnet50_spec("net.depth_encoder.visual_encoder.", arch.instr)
    spec.append(("net.depth_encoder.spatial_embeddings.weight", (arch.depth_positions, 64), "emb", 0))
    spec += _dense("net.rgb_pool_linear", arch.rgb_out, RGB_CHANNELS)
    spec += _dense("net.rgb_hist_linear.2", arch.rgb_out, RGB_CHANNELS + 64)
    spec += _dense("net.depth_hist_linear.1", arch.depth_out, arch.depth_channels * arch.depth_positions)
    spec += cma._gru_spec("net.visual_rnn.rnn.", 2 * arch.rgb_out + arch.depth_out + PREV_ACTION_DIM, H)
    spec += _dense("net.inst_attn_q.0", H // 2, H)
    spec += _dense("net.inst_attn_k", H // 2, instr_c, (1,))
    spec += _dense("net.text_q_linear", H // 2, instr_c)
    spec += _dense("net.rgb_kv_spatial", H // 2 + arch.rgb_out, RGB_CHANNELS + 64, (1,))
    spec += _dense("net.depth_kv_spatial", H // 2 + arch.depth_out, arch.depth_channels, (1,))
    spec += _dense("net.pano_attn.q_linear", PANO_KEY_DIM, instr_c, bias=False)
    spec += _dense("net.pano_attn.k_linear", PANO_KEY_DIM, kv, bias=False)
    spec += _dense("net.pano_attn.v_linear", PANO_KEY_DIM, kv, bias=False)
    spec += _dense("net.pano_attn.final_linear", kv, PANO_KEY_DIM, bias=False)
    spec += cma._gn("net.pano_attn.layer_norm", kv)
    spec += _dense("net.main_state_compress.0", H, instr_c + kv + H + PREV_ACTION_DIM)
    spec += cma._gru_spec("net.main_state_encoder.rnn.", H, H)
    spec += _dense("net.compress_x_linear.0", kv, H)
    spec += _dense("net.stop_linear", 1, H)
    for head in ("distance_linear", "distance_var_linear", "offset_linear", "offset_var_linear"):
        spec += _dense(f"net.{head}.0", 1, kv + H)
    spec += _dense("critic.fc", 1, H)
    return spec


def trainable(name: str) -> bool:
    """What the optimizer updates: not the two frozen backbones (nor the
    ResNet18's BatchNorm buffers under them), nor the pretrained (GloVe)
    token table."""
    return not name.startswith(("net.depth_encoder.visual_encoder.", "net.rgb_encoder.cnn.",
                                "net.instruction_encoder.embedding_layer."))


# -------------------------------------------------------------- encoders
def tv_resnet18(x: torch.Tensor, p: Dict[str, torch.Tensor], prefix: str, prec: cma.Precision) -> torch.Tensor:
    """The torchvision ResNet18 trunk through layer4, BatchNorm frozen."""
    x = F.relu(cma._frozen_bn(cma._conv(x, p[f"{prefix}0.weight"], prec, 2, 3), p, f"{prefix}1", prec))
    x = F.max_pool2d(x, 3, 2, 1)
    for li in range(4):
        for b in range(2):
            q = f"{prefix}{li + 4}.{b}."
            s = 2 if (b == 0 and li > 0) else 1
            res = x
            if b == 0 and li > 0:
                res = cma._frozen_bn(cma._conv(x, p[q + "downsample.0.weight"], prec, s), p, q + "downsample.1", prec)
            y = F.relu(cma._frozen_bn(cma._conv(x, p[q + "conv1.weight"], prec, s, 1), p, q + "bn1", prec))
            y = cma._frozen_bn(cma._conv(y, p[q + "conv2.weight"], prec, 1, 1), p, q + "bn2", prec)
            x = F.relu(cma._enc_round(y + res, prec))
    return x


def with_spatial(x: torch.Tensor, emb: torch.Tensor, prec: cma.Precision) -> torch.Tensor:
    """x [..., C, h * w] with the [h * w, 64] embedding appended as 64
    channels (in the encoders' precision): [..., C + 64, h * w]. The
    embeddings train; the backbones do not."""
    spatial = cma._enc_round(emb, prec).T.expand(tuple(x.shape[:-2]) + (64, x.shape[-1]))
    return torch.cat([x, spatial], dim=-2)


def encode(p: Dict[str, torch.Tensor], arch: Arch, rgb: torch.Tensor, depth: torch.Tensor,
           prec: cma.Precision = cma.F32) -> Tuple[torch.Tensor, torch.Tensor]:
    """Frames rgb [N, H, W, 3] u8 and depth [N, H, W, 1] in [0, 1] -> the
    frozen backbones' maps ([N, 512, 16], [N, C_d, h * w]) f32 (rounded as
    `prec.enc` says), before the spatial embeddings."""
    x = rgb.float().permute(0, 3, 1, 2) / 255.0
    if arch.normalize_rgb:
        mean = torch.tensor([0.485, 0.456, 0.406], device=x.device).view(1, 3, 1, 1)
        std = torch.tensor([0.229, 0.224, 0.225], device=x.device).view(1, 3, 1, 1)
        x = (x - mean) / std
    trunk = tv_resnet18(cma._enc_round(x, prec), p, "net.rgb_encoder.cnn.", prec)
    pooled = cma._enc_round(trunk.mean(dim=(2, 3), keepdim=True), prec).expand(-1, -1, 4, 4)
    d = cma.gn_resnet50(cma._enc_round(depth.float().permute(0, 3, 1, 2), prec), p, "net.depth_encoder.visual_encoder.",
                        prec)
    return pooled.flatten(2), d.flatten(2)


def encode_steps(p, arch: Arch, obs: Dict[str, torch.Tensor], masks: torch.Tensor, prec: cma.Precision = cma.F32,
                 chunk: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 13 frames of every row (obs rgb [R, 12, H, W, 3], depth [R, 12,
    H, W, 1], rgb_history, depth_history [R, H, W, C]; the history frame
    zeroed where masks [R] is 0) -> `encode`'s maps ([R, 13, 512, 16],
    [R, 13, C_d, h * w]), `chunk` rows at a time."""
    outs_r, outs_d = [], []
    R = masks.shape[0]
    for lo in range(0, R, chunk):
        sl = slice(lo, lo + chunk)
        m = masks[sl].reshape(-1, 1, 1, 1)
        rgb = torch.cat([obs["rgb"][sl], (obs["rgb_history"][sl].float() * m).to(obs["rgb"].dtype)[:, None]], dim=1)
        depth = torch.cat([obs["depth"][sl], (obs["depth_history"][sl] * m)[:, None]], dim=1)
        n = rgb.shape[0]
        r, d = encode(p, arch, rgb.reshape((-1,) + tuple(rgb.shape[2:])), depth.reshape((-1,) + tuple(depth.shape[2:])), prec)
        outs_r.append(r.reshape((n, 13) + tuple(r.shape[1:])))
        outs_d.append(d.reshape((n, 13) + tuple(d.shape[1:])))
    return torch.cat(outs_r), torch.cat(outs_d)


# ------------------------------------------------------------------- step
def _lin(x, p, name, prec, bias=True):
    return cma._linear(x, p[f"{name}.weight"], p[f"{name}.bias"] if bias else None, prec)


def _dot_attention(q, k, v, scale, prec, mask=None):
    """q [B, D], k [B, D, P], v [B, E, P] -> [B, E]; a mask multiplies the
    energies (zero where it is 0), before the scale."""
    energy = cma._einsum("bd,bdp->bp", q, k, prec)
    if mask is not None:
        energy = energy * mask.float()
    return cma._einsum("bp,bdp->bd", torch.softmax(energy * scale, dim=-1), v, prec)


def prev_action_features(prev: Dict[str, torch.Tensor], mask: torch.Tensor, arch: Arch) -> torch.Tensor:
    """[sin, cos] of the previous pano's angle, its offset (radians) and
    distance (metres), zero at an episode's first step: [B, 4]."""
    angle = prev["pano"].float() * (2 * math.pi / arch.num_panos)
    out = torch.stack([torch.sin(angle), torch.cos(angle), prev["offset"].float(), prev["distance"].float()], dim=1)
    return out * mask[:, None]


def step(p: Dict[str, torch.Tensor], arch: Arch, rgb: torch.Tensor, depth: torch.Tensor, instr_emb: torch.Tensor,
         prev: Dict[str, torch.Tensor], mask: torch.Tensor, angle: torch.Tensor, h1: torch.Tensor, h2: torch.Tensor,
         prec: cma.Precision = cma.F32) -> Dict[str, torch.Tensor]:
    """One step of every row after the backbones. rgb [B, 13, 512, 16],
    depth [B, 13, C_d, h * w] (`encode`'s maps; frame 12 the history frame), instr_emb
    [B, 2 H_i, L], prev {pano, offset, distance} [B], mask [B] (0 at an
    episode's first step), angle [B, 12, 4], h1, h2 [B, H]. Returns
    logits [B, 13], d_loc, d_var, o_loc, o_var [B, 12], value [B], h1,
    h2."""
    H, P = arch.hidden, arch.num_panos
    B = mask.shape[0]
    feats = prev_action_features(prev, mask, arch)
    rgb = with_spatial(rgb, p["net.rgb_encoder.spatial_embeddings.weight"], prec)
    depth = with_spatial(depth, p["net.depth_encoder.spatial_embeddings.weight"], prec)
    rgb_p, rgb_h = rgb[:, :P], rgb[:, P]
    depth_p, depth_h = depth[:, :P], depth[:, P]
    pooled = _lin(rgb_p[:, :, :RGB_CHANNELS].mean(dim=3), p, "net.rgb_pool_linear", prec).mean(dim=1)
    rgb_hist = F.relu(_lin(rgb_h.mean(dim=2), p, "net.rgb_hist_linear.2", prec))
    depth_hist = F.relu(_lin(depth_h.flatten(1), p, "net.depth_hist_linear.1", prec))
    m = mask[:, None]
    h1 = cma._gru(torch.cat([pooled, feats, rgb_hist, depth_hist], dim=1), h1 * m, p, "net.visual_rnn.rnn.", prec)

    dk = H // 2
    scale = 1.0 / math.sqrt(dk)
    text_mask = ~(instr_emb == 0.0).all(dim=1)
    q = F.relu(_lin(h1, p, "net.inst_attn_q.0", prec))
    text = _dot_attention(q, cma._conv1d(instr_emb, p, "net.inst_attn_k", prec), instr_emb, scale, prec, text_mask)

    tq = _lin(text, p, "net.text_q_linear", prec).repeat_interleave(P, dim=0)
    rgb_kv = cma._conv1d(rgb_p.reshape((B * P,) + tuple(rgb_p.shape[2:])), p, "net.rgb_kv_spatial", prec)
    depth_kv = cma._conv1d(depth_p.reshape((B * P,) + tuple(depth_p.shape[2:])), p, "net.depth_kv_spatial", prec)
    spatial_rgb = _dot_attention(tq, rgb_kv[:, :dk], rgb_kv[:, dk:], scale, prec).reshape(B, P, -1)
    spatial_depth = _dot_attention(tq, depth_kv[:, :dk], depth_kv[:, dk:], scale, prec).reshape(B, P, -1)
    shared = torch.cat([spatial_rgb, spatial_depth, angle.float()], dim=2)  # [B, 12, kv]

    pq = cma._linear(text, p["net.pano_attn.q_linear.weight"], None, prec)
    pk = cma._linear(shared, p["net.pano_attn.k_linear.weight"], None, prec)
    pv = cma._linear(shared, p["net.pano_attn.v_linear.weight"], None, prec)
    energy = cma._einsum("bd,bpd->bp", pq, pk, prec) / math.sqrt(PANO_KEY_DIM)
    attended = cma._einsum("bp,bpd->bd", torch.softmax(energy, dim=-1), pv, prec)
    attended = cma._linear(attended, p["net.pano_attn.final_linear.weight"], None, prec)
    attended = F.layer_norm(attended, (arch.kv,), p["net.pano_attn.layer_norm.weight"], p["net.pano_attn.layer_norm.bias"],
                            1e-6)

    x = F.relu(_lin(torch.cat([text, attended, h1, feats], dim=1), p, "net.main_state_compress.0", prec))
    h2 = cma._gru(x, h2 * m, p, "net.main_state_encoder.rnn.", prec)
    x = h2

    dotted = (shared * F.relu(_lin(x, p, "net.compress_x_linear.0", prec))[:, None, :]).sum(dim=2)
    logits = torch.cat([dotted, _lin(x, p, "net.stop_linear", prec)], dim=1)
    catted = torch.cat([shared, x[:, None, :].expand(B, P, H)], dim=2)

    def head(name):
        return _lin(catted, p, f"net.{name}.0", prec)[..., 0]

    d_loc = (arch.max_distance - arch.min_distance) * torch.sigmoid(head("distance_linear")) + arch.min_distance
    d_var = (arch.max_distance_var - arch.min_distance_var) * torch.sigmoid(head("distance_var_linear")) + arch.min_distance_var
    o_loc = (math.pi / P) * torch.tanh(head("offset_linear") / arch.offset_temperature)
    o_var = (arch.max_offset_var - arch.min_offset_var) * torch.sigmoid(head("offset_var_linear")) + arch.min_offset_var
    value = _lin(x, p, "critic.fc", prec)[:, 0]
    return {"logits": logits, "d_loc": d_loc, "d_var": d_var, "o_loc": o_loc, "o_var": o_var, "value": value,
            "h1": h1, "h2": h2}


def sequence(p, arch: Arch, rgb, depth, instr_emb, prev: Dict[str, torch.Tensor], masks, angle, h0,
             prec: cma.Precision = cma.F32) -> Dict[str, torch.Tensor]:
    """`step` over T steps of n rows: rgb, depth [T, n, 13, ...],
    instr_emb [T, n, 2 H_i, L], prev {k: [T, n]}, masks [T, n], angle
    [T, n, 12, 4], h0 [n, 2, H] (the two GRUs' states before step 0).
    Returns each of `step`'s outputs stacked [T, n, ...]."""
    h1, h2 = h0[:, 0], h0[:, 1]
    outs = []
    for t in range(masks.shape[0]):
        o = step(p, arch, rgb[t], depth[t], instr_emb[t], {k: v[t] for k, v in prev.items()}, masks[t], angle[t], h1, h2,
                 prec)
        h1, h2 = o["h1"], o["h2"]
        outs.append(o)
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


# --------------------------------------------------------- distributions
def _std_cdf(x):
    return 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def _std_pdf(x):
    return torch.exp(-0.5 * x * x) / math.sqrt(2.0 * math.pi)


def tn_log_prob(loc, scale, lo: float, hi: float, value):
    """log of Normal(loc, scale)'s density at value over its mass on [lo, hi]."""
    z = (value - loc) / scale
    mass = _std_cdf((hi - loc) / scale) - _std_cdf((lo - loc) / scale)
    return -0.5 * z * z - torch.log(scale) - 0.5 * math.log(2.0 * math.pi) - torch.log(mass)


def tn_entropy(loc, scale, lo: float, hi: float):
    """The entropy of Normal(loc, scale) truncated to [lo, hi]."""
    a, b = (lo - loc) / scale, (hi - loc) / scale
    mass = _std_cdf(b) - _std_cdf(a)
    return (0.5 * math.log(2.0 * math.pi * math.e) + torch.log(scale * mass)
            + (a * _std_pdf(a) - b * _std_pdf(b)) / (2.0 * mass))


def evaluate(out: Dict[str, torch.Tensor], actions: Dict[str, torch.Tensor], arch: Arch):
    """The joint log-probability of taken actions {pano (12 = STOP),
    distance, offset} (each [...]) under `step`'s outputs, and the entropy
    of the pano, offset and distance components (the latter two zero on
    STOP rows). Returns (log_prob, {pano, offset, distance})."""
    P = arch.num_panos
    logp = torch.log_softmax(out["logits"], dim=-1)
    pano = actions["pano"].long()
    pano_lp = logp.gather(-1, pano[..., None])[..., 0]
    pano_ent = -(logp.exp() * logp).sum(-1)
    at = (pano % P)[..., None]

    def pick(x):
        return x.gather(-1, at)[..., 0]

    moving = (pano != P).float()
    d_loc, d_scale = pick(out["d_loc"]), torch.sqrt(pick(out["d_var"]))
    o_loc, o_scale = pick(out["o_loc"]), torch.sqrt(pick(out["o_var"]))
    lim = math.pi / P
    d_lp = tn_log_prob(d_loc, d_scale, arch.min_distance, arch.max_distance, actions["distance"].float())
    o_lp = tn_log_prob(o_loc, o_scale, -lim, lim, actions["offset"].float())
    ent = {"pano": pano_ent, "offset": moving * tn_entropy(o_loc, o_scale, -lim, lim),
           "distance": moving * tn_entropy(d_loc, d_scale, arch.min_distance, arch.max_distance)}
    return pano_lp + moving * (d_lp + o_lp), ent


def cdf_gap(logits: torch.Tensor, pano: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """How far u [...] lies outside [CDF(a - 1), CDF(a)) of the
    categorical `logits` [..., 13] at the drawn pano a [...]: 0 where a is
    the inverse CDF's draw at u."""
    cdf = torch.cumsum(torch.softmax(logits.float(), dim=-1), dim=-1)
    hi = cdf.gather(-1, pano.long()[..., None])[..., 0]
    lo = torch.where(pano > 0, cdf.gather(-1, (pano.long() - 1).clamp(min=0)[..., None])[..., 0], torch.zeros_like(hi))
    return torch.clamp(torch.maximum(lo - u, u - hi), min=0.0)


def draw_pano(logits: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The inverse CDF's pano at u: the first action whose cumulative
    probability exceeds u."""
    cdf = torch.cumsum(torch.softmax(logits.float(), dim=-1), dim=-1)
    return (cdf < u[..., None]).sum(dim=-1).clamp(max=logits.shape[-1] - 1)


# ------------------------------------------------------------- the world
def nearest_free(occ: np.ndarray, i: int, j: int) -> Tuple[int, int]:
    """The cell itself where it is free, else the nearest free cell by
    squared cell distance (the first in row-major order on ties)."""
    if not occ[i, j]:
        return i, j
    free = np.argwhere(~occ)
    k = int(np.argmin((free[:, 0] - i) ** 2 + (free[:, 1] - j) ** 2))
    return int(free[k, 0]), int(free[k, 1])


def cell_of(occ: np.ndarray, x: float, z: float) -> Tuple[int, int]:
    n = occ.shape[0]
    return int(np.clip(x / grid.RES, 0, n - 1)), int(np.clip(z / grid.RES, 0, n - 1))


def scene_field(occ: np.ndarray, goal_xz: Tuple[float, float]) -> np.ndarray:
    """The geodesic distance (m, f64) of every cell to the goal's cell (its
    nearest free cell where it is blocked), by Dijkstra over the 8
    neighbours: a step of one cell to a side, sqrt(2) cells diagonally,
    never into a blocked cell nor past one at a corner; +inf where
    unreachable."""
    n = occ.shape[0]
    gi, gj = nearest_free(occ, *cell_of(occ, *goal_xz))
    dist = np.full((n, n), np.inf)
    dist[gi, gj] = 0.0
    heap = [(0.0, gi, gj)]
    diag = math.sqrt(2.0) * grid.RES
    while heap:
        d, i, j = heapq.heappop(heap)
        if d > dist[i, j]:
            continue
        for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1), (1, 1), (1, -1), (-1, 1), (-1, -1)):
            a, b = i + di, j + dj
            if not (0 <= a < n and 0 <= b < n) or occ[a, b]:
                continue
            if di and dj and (occ[i + di, j] or occ[i, j + dj]):
                continue
            nd = d + (diag if di and dj else grid.RES)
            if nd < dist[a, b]:
                dist[a, b] = nd
                heapq.heappush(heap, (nd, a, b))
    return dist


def field_at(field: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """field [B, N, N] (f32) at the cells of pos [B, 3]."""
    ci, cj = grid._cell(pos[:, 0], pos[:, 2], field.shape[1])
    return grid._lookup(field, ci, cj)


def waypoint_step(occ: torch.Tensor, pos: torch.Tensor, heading: torch.Tensor, r: torch.Tensor, theta: torch.Tensor,
                  stop: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """GO_TOWARD_POINT of every row: the target r metres away at heading +
    theta; a straight walk toward it sampled at i / n of the way (n =
    max(2, int(length / (0.25 cell))), i = 1..n) that stops before the first
    blocked sample, no sliding; the agent turned toward the target,
    (atan2(dx, dz) + pi) mod 2 pi. The walk ends on a free point, so the
    host's navigability check and snap leave it as it is. STOP rows stay as
    they are."""
    ang = heading + theta
    target = pos + r[:, None] * torch.stack([-torch.sin(ang), torch.zeros_like(ang), -torch.cos(ang)], dim=-1)
    delta = target - pos
    length = torch.linalg.vector_norm(delta[:, 0::2], dim=-1)
    moved = []
    for b in range(pos.shape[0]):
        if float(length[b]) < 1e-9:
            moved.append(target[b])
            continue
        n = max(2, int(float(length[b]) / (0.25 * grid.RES)))
        ts = torch.arange(1, n + 1, dtype=torch.float32, device=pos.device) / n
        end, reached = grid._walk(occ[b : b + 1], pos[b : b + 1], delta[b : b + 1], ts)
        moved.append(target[b] if bool(reached[0]) else end[0])
    moved = torch.stack(moved)
    turned = torch.remainder(torch.atan2(delta[:, 0], delta[:, 2]) + math.pi, 2 * math.pi)
    return torch.where(stop[:, None], pos, moved), torch.where(stop, heading, turned)


def waypoint_reward(field: torch.Tensor, prev_distance: torch.Tensor, prev_pos: torch.Tensor, pos: torch.Tensor,
                    r: torch.Tensor, stop: torch.Tensor, rm: Dict[str, float]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The waypoint reward of every row after its step: the slack reward
    scaled by the predicted distance (by the distance moved on STOP) over
    0.25 m, capped at the slack reward; the progress toward the goal in
    geodesic metres (-1 where it is not finite); the success bonus on a
    STOP within the success distance. Returns (reward, distance to goal)."""
    d = field_at(field, pos)
    moved = torch.linalg.vector_norm(prev_pos[:, 0::2] - pos[:, 0::2], dim=-1)
    slack = torch.clamp(rm["slack_reward"] * torch.where(stop, moved, r) / 0.25, max=rm["slack_reward"])
    progress = prev_distance - d
    progress = torch.where(torch.isfinite(progress), progress, torch.full_like(progress, -1.0))
    success = (stop & (d < rm["success_distance"])).float()
    return slack + rm["distance_scalar"] * progress + rm["success_reward"] * success, d
