"""The yardstick's arithmetic: the H100's peaks, each kernel's least time
from its shapes, and the model FLOPs of a step, counted from the
configuration's widths. Nothing here reads the program.

Peaks are NVIDIA's for one H100 SXM, dense: 989 TFLOP/s in bf16, 67 TFLOP/s
in f32 outside the tensor cores (the port runs its f32 products with TF32
off), 3.35 TB/s of HBM3. A kernel's least time is the larger of its
operations over the peak and its bytes over the bandwidth, each input byte
read once and each output byte written once.
"""

from __future__ import annotations

from typing import Dict, Tuple

HBM_BYTES_PER_S = 3.35e12
PEAK = {"bf16": 989e12, "f32": 67e12}


def least_s(nbytes: float, flops: float, peak: float = PEAK["f32"]) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / peak)


# ------------------------------------------------------------- kernels
def b1_forward_s(T: int, B: int, H: int, gates: bool) -> float:
    """B1 (gru_sequence) forward at [T, B, H]: reads the input projection
    xi [T, B, 3H], the masks [T, B], h0 [B, H], w_hh [3H, H] and b_hh [3H];
    writes out [T, B, H] (and the gates [T, B, 4H] when training). One
    [B, H] x [H, 3H] product per step and about 12 operations per (row,
    unit) for the gates, in f32."""
    moved = 4 * (T * B * 3 * H + T * B + B * H + 3 * H * H + 3 * H + T * B * H + (T * B * 4 * H if gates else 0))
    return least_s(moved, T * (2 * 3 * H * H * B + 12 * H * B))


def b1_backward_s(T: int, B: int, H: int) -> float:
    """B1's backward recurrence (the cluster route's kernel) at [T, B, H]:
    reads d_out, the stored gates, masks, h0, out and w_hh; writes d_xi,
    d_gh [T, B, 3H] and d_h0. One [B, 3H] x [3H, H] product per step and
    about 20 operations per (row, unit), in f32."""
    rows = T * B
    moved = 4 * (rows * H + rows * 4 * H + rows + B * H + rows * H + 3 * H * H + 2 * rows * 3 * H + B * H)
    return least_s(moved, 2 * rows * 3 * H * H + rows * 20 * H)


def b2_s(B: int, in_hw: Tuple[int, int], out_hw: Tuple[int, int], C: int, in_bytes: int, out_bytes: int) -> float:
    """B2 (fused resize) of B frames: the input read once, the output
    written once, about 11 operations per output element."""
    n_in, n_out = B * in_hw[0] * in_hw[1] * C, B * out_hw[0] * out_hw[1] * C
    return least_s(n_in * in_bytes + n_out * out_bytes, 11 * n_out)


# --------------------------------------------------------- model FLOPs
def _conv(cout: int, cin: int, k: int, hw: int) -> float:
    return 2.0 * cout * cin * k * k * hw * hw


def tv_resnet50_flops(side: int) -> float:
    """torchvision ResNet50 through layer4 on a side x side image."""
    s = side // 2
    f = _conv(64, 3, 7, s)
    s = (s + 1) // 2  # max pool 3, stride 2, padding 1
    cin = 64
    for li, (blocks, planes) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512))):
        for b in range(blocks):
            stride = 2 if (b == 0 and li > 0) else 1
            out = s // stride
            f += _conv(planes, cin, 1, s) + _conv(planes, planes, 3, out) + _conv(planes * 4, planes, 1, out)
            if b == 0:
                f += _conv(planes * 4, cin, 1, out)
            cin, s = planes * 4, out
    return f


def gn_resnet50_flops(side: int, out_channels: int) -> float:
    """The DD-PPO depth ResNet50 (32 base planes) on a side x side frame:
    a 2x2 average pool, the trunk, a 3x3 compression to `out_channels`."""
    s = side // 2 // 2
    f = _conv(32, 1, 7, s)
    s = (s + 1) // 2
    cin = 32
    for li, blocks in enumerate((3, 4, 6, 3)):
        planes = 32 * 2**li
        for b in range(blocks):
            stride = 2 if (b == 0 and li > 0) else 1
            out = s // stride
            f += _conv(planes, cin, 1, s) + _conv(planes, planes, 3, out) + _conv(planes * 4, planes, 1, out)
            if b == 0:
                f += _conv(planes * 4, cin, 1, out)
            cin, s = planes * 4, out
    return f + _conv(out_channels, cin, 3, s)


def lstm_flops(tokens: float, d_in: int, hidden: int) -> Tuple[float, float]:
    """(input projection, recurrence) FLOPs of one direction over `tokens`."""
    return 2.0 * tokens * d_in * 4 * hidden, 2.0 * tokens * hidden * 4 * hidden


def cma_head_flops(arch, tokens: float) -> float:
    """Everything after the backbones and the instruction LSTM, for one
    step of one episode: the linears, the 1x1 convolutions, the three
    attentions, both GRUs and the heads."""
    H, I = arch.hidden, arch.instr_out
    rgb_c, depth_c, s2 = 2048 + 64, arch.depth_channels + 64, arch.depth_spatial**2
    f = 2.0 * rgb_c * arch.rgb_out + 2.0 * depth_c * s2 * arch.depth_out
    d1 = arch.rgb_out + arch.depth_out + 32
    f += 2.0 * d1 * 3 * H + 2.0 * H * 3 * H  # GRU 1
    f += 2.0 * H * (H // 2) + 2.0 * I * (H // 2) * tokens + 2.0 * (H // 2) * tokens + 2.0 * I * tokens  # text attention
    f += 2.0 * rgb_c * (H // 2 + arch.rgb_out) * 16 + 2.0 * depth_c * (H // 2 + arch.depth_out) * s2
    f += 2.0 * I * (H // 2) + 2.0 * (H // 2) * 16 * 2 + 2.0 * (H // 2) * s2 * 2
    f += 2.0 * (H + I + arch.rgb_out + arch.depth_out + 32) * H  # compress
    f += 2.0 * H * 3 * H * 2  # GRU 2
    f += 2.0 * H * arch.num_actions + (2.0 * H if arch.progress_monitor else 0.0)
    return f


def rollout_step_least_s(arch, rgb_side: int, tokens: float) -> Dict[str, float]:
    """The least device seconds of one env step of one episode, by part:
    the backbones at the bf16 peak, the instruction LSTM and the rest at
    the f32 peak (the configuration's precisions). Also the FLOPs."""
    conv = tv_resnet50_flops(rgb_side) + gn_resnet50_flops(arch.depth_hw, arch.depth_channels)
    d_in = arch.embed if arch.instr_tokens else arch.feature_dim
    proj, rec = lstm_flops(tokens, d_in, arch.instr_hidden)
    rest = 2 * (proj + rec) + cma_head_flops(arch, tokens)
    return {"flops": conv + rest, "least_s": conv / PEAK["bf16"] + rest / PEAK["f32"]}


def train_frame_flops(arch, tokens: float) -> float:
    """Forward and backward FLOPs of the trainable parts for one frame of
    a batch, on the bank's features: backward counts twice the forward,
    except the LSTM's input projection, whose input (the frozen token
    table's rows) needs no gradient (once). All in f32."""
    d_in = arch.embed if arch.instr_tokens else arch.feature_dim
    proj, rec = lstm_flops(tokens, d_in, arch.instr_hidden)
    forward = 2 * (proj + rec) + cma_head_flops(arch, tokens)
    return 3 * forward - 2 * proj
