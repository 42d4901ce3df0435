"""The plain reference of the Cross-Modal Attention policy (Krantz et al.,
ECCV 2020, "Beyond the Nav-Graph"), in plain PyTorch and f32.

- `param_spec`: every parameter and buffer by the published model's
  state_dict names and shapes, with the distribution the benchmark draws it
  from. The benchmark makes the weights from this list; the program gets
  them by name, so a program whose shapes differ fails to load them.
- `visual`, `instruction`, `step`: the forward pass. The torchvision
  ResNet50 (frozen BatchNorm) encodes RGB, the DD-PPO ResNet50 (GroupNorm,
  32 base planes) encodes depth, an LSTM (bidirectional, packed-sequence
  semantics) encodes the instruction; then GRU 1 over [rgb, depth, previous
  action], the instruction attended by GRU 1's state, RGB and depth
  attended by the attended instruction, GRU 2 over their compressed concat,
  the action head and the progress monitor.

Everything runs in f32 with TF32 off unless `Precision` says otherwise:
the benchmark's controls run the same code a step below what the
configuration states (encoders in fp8 with per-tensor scales, the rest in
TF32, each product's operands rounded to TF32's mantissa here, so that the
control reads the same on any device). Run it inside `strict_f32()`. It
imports nothing of the program.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # the largest finite float8_e4m3fn


@dataclass(frozen=True)
class Arch:
    """The widths of one CMA configuration."""

    num_actions: int
    hidden: int = 512
    rgb_out: int = 256
    depth_out: int = 128
    depth_hw: int = 256  # the depth frame's side after the transforms
    instr_tokens: bool = True  # token ids through a frozen table, else BERT features
    vocab: int = 2504
    embed: int = 50
    feature_dim: int = 768
    instr_hidden: int = 128
    progress_monitor: bool = False
    pm_alpha: float = 1.0
    frozen_embedding: bool = True

    @property
    def depth_spatial(self) -> int:
        return max(1, int((self.depth_hw // 2) / 32))

    @property
    def depth_channels(self) -> int:
        return int(round(2048 / self.depth_spatial**2))

    @property
    def instr_out(self) -> int:
        return 2 * self.instr_hidden


@dataclass(frozen=True)
class Precision:
    """enc: "f32", "bf16" or "fp8" for the two ResNets; rest: "f32" or
    "tf32" for everything after them."""

    enc: str = "f32"
    rest: str = "f32"


F32 = Precision()


# ------------------------------------------------------------------ spec
def _tv_resnet50_spec(prefix: str) -> List[Tuple]:
    out = [(f"{prefix}0.weight", (64, 3, 7, 7), "w", 3 * 49)]
    out += _bn(f"{prefix}1", 64)
    cin = 64
    for li, (blocks, planes) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512))):
        for b in range(blocks):
            p = f"{prefix}{li + 4}.{b}."
            out += [(p + "conv1.weight", (planes, cin, 1, 1), "w", cin)] + _bn(p + "bn1", planes)
            out += [(p + "conv2.weight", (planes, planes, 3, 3), "w", planes * 9)] + _bn(p + "bn2", planes)
            out += [(p + "conv3.weight", (planes * 4, planes, 1, 1), "w", planes)] + _bn(p + "bn3", planes * 4)
            if b == 0:
                out += [(p + "downsample.0.weight", (planes * 4, cin, 1, 1), "w", cin)] + _bn(p + "downsample.1", planes * 4)
            cin = planes * 4
    return out


def _bn(p: str, c: int) -> List[Tuple]:
    return [(f"{p}.weight", (c,), "scale", 0), (f"{p}.bias", (c,), "shift", 0),
            (f"{p}.running_mean", (c,), "shift", 0), (f"{p}.running_var", (c,), "var", 0)]


def _gn(p: str, c: int) -> List[Tuple]:
    return [(f"{p}.weight", (c,), "scale", 0), (f"{p}.bias", (c,), "shift", 0)]


def _gn_resnet50_spec(prefix: str, arch: Arch) -> List[Tuple]:
    base = 32
    out = [(f"{prefix}backbone.conv1.0.weight", (base, 1, 7, 7), "w", 49)] + _gn(f"{prefix}backbone.conv1.1", base)
    cin = base
    for li, blocks in enumerate((3, 4, 6, 3)):
        planes = base * 2**li
        for b in range(blocks):
            p = f"{prefix}backbone.layer{li + 1}.{b}."
            out += [(p + "convs.0.weight", (planes, cin, 1, 1), "w", cin)] + _gn(p + "convs.1", planes)
            out += [(p + "convs.3.weight", (planes, planes, 3, 3), "w", planes * 9)] + _gn(p + "convs.4", planes)
            out += [(p + "convs.6.weight", (planes * 4, planes, 1, 1), "w", planes)] + _gn(p + "convs.7", planes * 4)
            if b == 0:
                out += [(p + "downsample.0.weight", (planes * 4, cin, 1, 1), "w", cin)] + _gn(p + "downsample.1", planes * 4)
            cin = planes * 4
    c = arch.depth_channels
    out += [(f"{prefix}compression.0.weight", (c, cin, 3, 3), "w", cin * 9)] + _gn(f"{prefix}compression.1", c)
    return out


def _lstm_spec(p: str, d_in: int, h: int) -> List[Tuple]:
    out = []
    for suffix in ("", "_reverse"):
        out += [(f"{p}weight_ih_l0{suffix}", (4 * h, d_in), "w", d_in), (f"{p}weight_hh_l0{suffix}", (4 * h, h), "w", h),
                (f"{p}bias_ih_l0{suffix}", (4 * h,), "bias", 0), (f"{p}bias_hh_l0{suffix}", (4 * h,), "bias", 0)]
    return out


def _gru_spec(p: str, d_in: int, h: int) -> List[Tuple]:
    return [(f"{p}weight_ih_l0", (3 * h, d_in), "w", d_in), (f"{p}weight_hh_l0", (3 * h, h), "w", h),
            (f"{p}bias_ih_l0", (3 * h,), "bias", 0), (f"{p}bias_hh_l0", (3 * h,), "bias", 0)]


def _dense_spec(p: str, d_out: int, d_in: int, kernel: Tuple = ()) -> List[Tuple]:
    return [(f"{p}.weight", (d_out, d_in) + kernel, "w", d_in), (f"{p}.bias", (d_out,), "bias", 0)]


def param_spec(arch: Arch) -> List[Tuple[str, Tuple[int, ...], str, int]]:
    """(name, shape, kind, fan_in) of every tensor of the policy's
    state_dict. Kinds: w (normal over sqrt(fan_in)), bias, scale and shift
    (of a norm), var (a running variance), emb (unit normal), head (the
    action head at unit gain), head_bias."""
    H, A = arch.hidden, arch.num_actions
    rgb_c, depth_c = 2048 + 64, arch.depth_channels + 64
    s = arch.depth_spatial
    spec: List[Tuple] = []
    if arch.instr_tokens:
        spec.append(("net.instruction_encoder.embedding_layer.weight", (arch.vocab, arch.embed), "emb", 0))
    d_in = arch.embed if arch.instr_tokens else arch.feature_dim
    spec += _lstm_spec("net.instruction_encoder.encoder_rnn.", d_in, arch.instr_hidden)
    spec += _gn_resnet50_spec("net.depth_encoder.visual_encoder.", arch)
    spec.append(("net.depth_encoder.spatial_embeddings.weight", (s * s, 64), "emb", 0))
    spec += _tv_resnet50_spec("net.rgb_encoder.cnn.")
    spec.append(("net.rgb_encoder.spatial_embeddings.weight", (16, 64), "emb", 0))
    spec.append(("net.prev_action_embedding.weight", (A + 1, 32), "emb", 0))
    spec += _dense_spec("net.rgb_linear.2", arch.rgb_out, rgb_c)
    spec += _dense_spec("net.depth_linear.1", arch.depth_out, depth_c * s * s)
    spec += _gru_spec("net.state_encoder.rnn.", arch.rgb_out + arch.depth_out + 32, H)
    spec += _gru_spec("net.second_state_encoder.rnn.", H, H)
    spec += _dense_spec("net.state_q", H // 2, H)
    spec += _dense_spec("net.text_k", H // 2, arch.instr_out, (1,))
    spec += _dense_spec("net.text_q", H // 2, arch.instr_out)
    spec += _dense_spec("net.rgb_kv", H // 2 + arch.rgb_out, rgb_c, (1,))
    spec += _dense_spec("net.depth_kv", H // 2 + arch.depth_out, depth_c, (1,))
    spec += _dense_spec("net.second_state_compress.0", H, H + arch.instr_out + arch.rgb_out + arch.depth_out + 32)
    if arch.progress_monitor:
        spec += _dense_spec("net.progress_monitor", 1, H)
    spec += [("action_distribution.linear.weight", (A, H), "head", H), ("action_distribution.linear.bias", (A,), "head_bias", 0)]
    return spec


def trainable(name: str, arch: Arch) -> bool:
    """What the optimizer updates: not the two ResNets, nor a pretrained
    token table (reference trainer: frozen encoders, frozen GloVe)."""
    if name.startswith(("net.depth_encoder.visual_encoder.", "net.rgb_encoder.cnn.")):
        return False
    return not (arch.instr_tokens and arch.frozen_embedding and name.startswith("net.instruction_encoder.embedding"))


# ------------------------------------------------------------- precision
@contextlib.contextmanager
def strict_f32():
    """TF32 off for the library's products: the reference's f32 is f32 (the
    control's TF32 is emulated operand by operand, `_tf32`)."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _round_tf32(t: torch.Tensor) -> torch.Tensor:
    i = t.float().contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class _TF32(torch.autograd.Function):
    """f32 rounded to TF32's 10 mantissa bits, to nearest even: what the
    tensor cores read of a product's operands with TF32 on. The gradient
    that flows back through it is rounded the same way, as the backward
    products read it."""

    @staticmethod
    def forward(ctx, t):
        return _round_tf32(t)

    @staticmethod
    def backward(ctx, g):
        return _round_tf32(g)


def _tf32(t: torch.Tensor) -> torch.Tensor:
    return _TF32.apply(t)


def _ops(prec: "Precision", *ts):
    return tuple(_tf32(t) if prec.rest == "tf32" else t for t in ts)


def _linear(x, w, b, prec: "Precision"):
    x, w = _ops(prec, x, w)
    return F.linear(x, w, b)


def _conv1d(x, p, name, prec: "Precision"):
    x, w = _ops(prec, x, p[f"{name}.weight"])
    return F.conv1d(x, w, p[f"{name}.bias"])


def _einsum(eq, a, b, prec: "Precision"):
    a, b = _ops(prec, a, b)
    return torch.einsum(eq, a, b)


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """t through float8 e4m3 with one scale for the tensor, back in f32."""
    scale = t.detach().abs().amax().clamp(min=1e-12) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _enc_round(x: torch.Tensor, prec: Precision) -> torch.Tensor:
    if prec.enc == "fp8full":
        return _fp8(x)
    if prec.enc in ("bf16", "fp8"):
        return x.to(torch.bfloat16).to(torch.float32)
    return x


def _conv(x, w, prec: Precision, stride=1, padding=0):
    if prec.enc in ("fp8", "fp8full"):
        x, w = _fp8(x), _fp8(w)
    elif prec.enc == "bf16":
        x, w = x.to(torch.bfloat16).float(), w.to(torch.bfloat16).float()
    return _enc_round(F.conv2d(x, w, None, stride, padding), prec)


# ------------------------------------------------------------- encoders
def _frozen_bn(x, p, name, prec):
    inv = p[f"{name}.weight"] * torch.rsqrt(p[f"{name}.running_var"] + 1e-5)
    y = x * inv.view(1, -1, 1, 1) + (p[f"{name}.bias"] - p[f"{name}.running_mean"] * inv).view(1, -1, 1, 1)
    return _enc_round(y, prec)


def tv_resnet50(x: torch.Tensor, p: Dict[str, torch.Tensor], prefix: str, prec: Precision) -> torch.Tensor:
    x = F.relu(_frozen_bn(_conv(x, p[f"{prefix}0.weight"], prec, 2, 3), p, f"{prefix}1", prec))
    x = F.max_pool2d(x, 3, 2, 1)
    for li, (blocks, stride) in enumerate(zip((3, 4, 6, 3), (1, 2, 2, 2))):
        for b in range(blocks):
            q = f"{prefix}{li + 4}.{b}."
            s = stride if b == 0 else 1
            res = x
            if b == 0:
                res = _frozen_bn(_conv(x, p[q + "downsample.0.weight"], prec, s), p, q + "downsample.1", prec)
            y = F.relu(_frozen_bn(_conv(x, p[q + "conv1.weight"], prec), p, q + "bn1", prec))
            y = F.relu(_frozen_bn(_conv(y, p[q + "conv2.weight"], prec, s, 1), p, q + "bn2", prec))
            x = F.relu(_enc_round(_frozen_bn(_conv(y, p[q + "conv3.weight"], prec), p, q + "bn3", prec) + res, prec))
    return x


def _group_norm(x, p, name, groups, prec):
    return _enc_round(F.group_norm(x, groups, p[f"{name}.weight"], p[f"{name}.bias"], 1e-5), prec)


def gn_resnet50(x: torch.Tensor, p: Dict[str, torch.Tensor], prefix: str, prec: Precision) -> torch.Tensor:
    groups = 16
    b = f"{prefix}backbone."
    x = F.avg_pool2d(x, 2)
    x = F.relu(_group_norm(_conv(x, p[b + "conv1.0.weight"], prec, 2, 3), p, b + "conv1.1", groups, prec))
    x = F.max_pool2d(x, 3, 2, 1)
    for li, (blocks, stride) in enumerate(zip((3, 4, 6, 3), (1, 2, 2, 2))):
        for k in range(blocks):
            q = f"{b}layer{li + 1}.{k}."
            s = stride if k == 0 else 1
            res = x
            if k == 0:
                res = _group_norm(_conv(x, p[q + "downsample.0.weight"], prec, s), p, q + "downsample.1", groups, prec)
            y = F.relu(_group_norm(_conv(x, p[q + "convs.0.weight"], prec), p, q + "convs.1", groups, prec))
            y = F.relu(_group_norm(_conv(y, p[q + "convs.3.weight"], prec, s, 1), p, q + "convs.4", groups, prec))
            y = _group_norm(_conv(y, p[q + "convs.6.weight"], prec), p, q + "convs.7", groups, prec)
            x = F.relu(_enc_round(y + res, prec))
    x = _conv(x, p[f"{prefix}compression.0.weight"], prec, 1, 1)
    return F.relu(_group_norm(x, p, f"{prefix}compression.1", 1, prec))


def _spatial(x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    b, _, h, w = x.shape
    return torch.cat([x, emb.T.reshape(1, 64, h, w).expand(b, 64, h, w)], dim=1)


def visual(p: Dict[str, torch.Tensor], rgb: torch.Tensor, depth: torch.Tensor, prec: Precision = F32):
    """The frozen backbones: rgb [B, H, W, 3] u8 -> [B, 2048, 4, 4] (a 4x4
    adaptive average pool), depth [B, H, W, 1] in [0, 1] -> [B, C, s, s];
    both f32 (rounded as `prec.enc` says)."""
    x = rgb.float().permute(0, 3, 1, 2) / 255.0
    x = _enc_round(x, prec)
    r = F.adaptive_avg_pool2d(tv_resnet50(x, p, "net.rgb_encoder.cnn.", prec), (4, 4))
    d = gn_resnet50(_enc_round(depth.float().permute(0, 3, 1, 2), prec), p, "net.depth_encoder.visual_encoder.", prec)
    return _enc_round(r, prec), d


# ---------------------------------------------------------- instruction
def _lstm(x: torch.Tensor, p: Dict[str, torch.Tensor], name: str, suffix: str, hidden: int, prec: Precision) -> torch.Tensor:
    """x [B, L, D] -> outputs [B, L, H], gates in torch's order (i, f, g, o)."""
    B, L, _ = x.shape
    xi = _linear(x, p[f"{name}weight_ih_l0{suffix}"], p[f"{name}bias_ih_l0{suffix}"], prec)
    w_hh, b_hh = p[f"{name}weight_hh_l0{suffix}"], p[f"{name}bias_hh_l0{suffix}"]
    h = x.new_zeros(B, hidden)
    c = x.new_zeros(B, hidden)
    outs = []
    for t in range(L):
        i, f, g, o = (xi[:, t] + _linear(h, w_hh, b_hh, prec)).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        outs.append(h)
    return torch.stack(outs, dim=1)


def _reverse_within(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    L = x.shape[1]
    t = torch.arange(L, device=x.device)[None, :]
    idx = torch.where(t < lengths[:, None], lengths[:, None] - 1 - t, t)
    return torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))


def instruction(p: Dict[str, torch.Tensor], instr: torch.Tensor, arch: Arch, prec: Precision = F32) -> torch.Tensor:
    """Token ids [B, L] (0 pads the tail) or features [B, L, D] (zero rows
    pad the tail) -> [B, 2 * hidden, L], zero past each length."""
    if arch.instr_tokens:
        lengths = (instr != 0).sum(dim=1)
        x = F.embedding(instr.long(), p["net.instruction_encoder.embedding_layer.weight"])
    else:
        x = instr.float()
        lengths = ((x != 0.0).sum(dim=2) != 0).sum(dim=1)
    name = "net.instruction_encoder.encoder_rnn."
    valid = (torch.arange(x.shape[1], device=x.device)[None, :] < lengths[:, None]).float()[:, :, None]
    fwd = _lstm(x, p, name, "", arch.instr_hidden, prec) * valid
    bwd = _lstm(_reverse_within(x, lengths), p, name, "_reverse", arch.instr_hidden, prec) * valid
    return torch.cat([fwd, _reverse_within(bwd, lengths)], dim=2).permute(0, 2, 1)


# ----------------------------------------------------------------- step
def _gru(x, h, p, name, prec):
    gi = _linear(x, p[f"{name}weight_ih_l0"], p[f"{name}bias_ih_l0"], prec)
    gh = _linear(h, p[f"{name}weight_hh_l0"], p[f"{name}bias_hh_l0"], prec)
    ir, iz, i_n = gi.chunk(3, dim=-1)
    hr, hz, h_n = gh.chunk(3, dim=-1)
    r, z = torch.sigmoid(ir + hr), torch.sigmoid(iz + hz)
    n = torch.tanh(i_n + r * h_n)
    return (1 - z) * n + z * h


def _attend(q, k, v, scale, prec, mask=None):
    energy = _einsum("bd,bdp->bp", q, k, prec)
    if mask is not None:
        energy = energy - mask.float() * 1e8
    return _einsum("bp,bdp->bd", torch.softmax(energy * scale, dim=-1), v, prec)


def step(p: Dict[str, torch.Tensor], arch: Arch, rgb_feat: torch.Tensor, depth_feat: torch.Tensor,
         instr_emb: torch.Tensor, prev_action: torch.Tensor, mask: torch.Tensor, h1: torch.Tensor, h2: torch.Tensor,
         prec: Precision = F32):
    """One step of every episode after the backbones. rgb_feat [B, 2048, 4,
    4], depth_feat [B, C, s, s], instr_emb [B, 2H_i, L], prev_action [B]
    (the last action taken), mask [B] (0 at an episode's first step),
    h1, h2 [B, H]. Returns (logits [B, A], h1, h2, progress [B] or None)."""
    H = arch.hidden
    rgb = _spatial(rgb_feat, p["net.rgb_encoder.spatial_embeddings.weight"]).flatten(2)
    depth = _spatial(depth_feat, p["net.depth_encoder.spatial_embeddings.weight"]).flatten(2)
    idx = ((prev_action.float() + 1.0) * mask).long()
    prev = F.embedding(idx, p["net.prev_action_embedding.weight"])
    rgb_in = F.relu(_linear(rgb.mean(dim=2), p["net.rgb_linear.2.weight"], p["net.rgb_linear.2.bias"], prec))
    depth_in = F.relu(_linear(depth.flatten(1), p["net.depth_linear.1.weight"], p["net.depth_linear.1.bias"], prec))
    m = mask[:, None]
    h1 = _gru(torch.cat([rgb_in, depth_in, prev], dim=1), h1 * m, p, "net.state_encoder.rnn.", prec)
    scale = 1.0 / (H // 2) ** 0.5
    text_mask = (instr_emb == 0.0).all(dim=1)
    q = _linear(h1, p["net.state_q.weight"], p["net.state_q.bias"], prec)
    text = _attend(q, _conv1d(instr_emb, p, "net.text_k", prec), instr_emb, scale, prec, text_mask)
    rgb_kv, depth_kv = _conv1d(rgb, p, "net.rgb_kv", prec), _conv1d(depth, p, "net.depth_kv", prec)
    tq = _linear(text, p["net.text_q.weight"], p["net.text_q.bias"], prec)
    rgb_att = _attend(tq, rgb_kv[:, : H // 2], rgb_kv[:, H // 2 :], scale, prec)
    depth_att = _attend(tq, depth_kv[:, : H // 2], depth_kv[:, H // 2 :], scale, prec)
    x = torch.cat([h1, text, rgb_att, depth_att, prev], dim=1)
    x = F.relu(_linear(x, p["net.second_state_compress.0.weight"], p["net.second_state_compress.0.bias"], prec))
    h2 = _gru(x, h2 * m, p, "net.second_state_encoder.rnn.", prec)
    logits = _linear(h2, p["action_distribution.linear.weight"], p["action_distribution.linear.bias"], prec)
    progress: Optional[torch.Tensor] = None
    if arch.progress_monitor:
        pm = _linear(h2, p["net.progress_monitor.weight"], p["net.progress_monitor.bias"], prec)
        progress = torch.tanh(pm)[:, 0]
    return logits, h1, h2, progress
