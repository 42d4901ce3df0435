"""The waypoint policy's model FLOPs and least time, counted from the
configuration's widths (benchmark/reference/waypoint.py): what `mfu.ppo`
divides by the window. Nothing here reads the program.

An update of the DD-PPO cell is (T + 1) x N forward passes of the act step
(T steps and the bootstrap value, each of N rows and 13 frames: 12 pano
views and the history frame) and K minibatch steps of T x n rows: the
frozen backbones recomputed over every row's 13 frames (forward only), the
trainable parts forward and backward. A backward counts twice the forward
of a product (the input's gradient and the weight's), once where its input
needs no gradient (the frozen backbones' features, the frozen token
table's rows: the weight's alone). Convolutions count at the bf16 peak (the
configuration's encoders), everything else at the f32 peak, as
`roofline.rollout_step_least_s` counts them.
"""

from __future__ import annotations

from typing import Dict, Tuple

from benchmark.roofline import PEAK, _conv, gn_resnet50_flops, lstm_flops

INSTRUCTION_TOKENS = 200  # the padded instruction the biLSTM runs over every step (tasks/sensors.MAX_INSTRUCTION_LEN)


def tv_resnet18_flops(side: int) -> float:
    """torchvision ResNet18 through layer4 on a side x side image."""
    s = side // 2
    f = _conv(64, 3, 7, s)
    s = (s + 1) // 2  # max pool 3, stride 2, padding 1
    cin = 64
    for li in range(4):
        planes = 64 * 2**li
        for b in range(2):
            stride = 2 if (b == 0 and li > 0) else 1
            out = s // stride
            f += _conv(planes, cin, 3, out) + _conv(planes, planes, 3, out)
            if b == 0 and li > 0:
                f += _conv(planes, cin, 1, out)
            cin, s = planes, out
    return f


def backbone_flops(arch, rgb_side: int = 224) -> float:
    """The two frozen backbones over one row's 13 frames."""
    return 13.0 * (tv_resnet18_flops(rgb_side) + gn_resnet50_flops(arch.depth_hw, arch.instr.depth_channels))


def head_flops(arch) -> Tuple[float, float]:
    """(FLOPs of one row's step after the backbones, the part of them whose
    input needs no gradient): the instruction biLSTM, the linears and 1x1
    convolutions, the attentions, both GRUs, the heads and the critic."""
    H, P, L, kv = arch.hidden, arch.num_panos, INSTRUCTION_TOKENS, arch.kv
    I, dk = 2 * arch.instr_hidden, arch.hidden // 2
    rgb_c, depth_c, s2 = 512 + 64, arch.depth_channels, arch.depth_positions
    proj, rec = lstm_flops(L, arch.embed, arch.instr_hidden)
    frozen_in = 2 * proj  # the biLSTM's input projection of the frozen token table's rows
    frozen_in += 2.0 * P * 512 * arch.rgb_out + 2.0 * rgb_c * arch.rgb_out + 2.0 * depth_c * s2 * arch.depth_out
    frozen_in += 2.0 * P * 16 * rgb_c * (dk + arch.rgb_out) + 2.0 * P * s2 * depth_c * (dk + arch.depth_out)
    f = frozen_in + 2 * rec
    f += 2.0 * (2 * arch.rgb_out + arch.depth_out + 4) * 3 * H + 2.0 * H * 3 * H  # visual GRU
    f += 2.0 * H * dk + 2.0 * I * dk * L + 2.0 * dk * L + 2.0 * I * L  # instruction attention
    f += 2.0 * I * dk + 2.0 * P * (2 * dk * 16 + 2 * dk * s2)  # spatial attention per pano frame
    f += 2.0 * I * 128 + 2.0 * 2 * P * kv * 128 + 2.0 * 2 * P * 128 + 2.0 * 128 * kv  # pano attention
    f += 2.0 * (I + kv + H + 4) * H + 2.0 * H * 3 * H * 2  # compress, main GRU
    f += 2.0 * H * kv + 2.0 * P * kv + 2.0 * H + 4 * 2.0 * P * (kv + H) + 2.0 * H  # heads and critic
    return f, frozen_in


def update_least_s(arch, N: int, T: int, K: int, rows: int) -> Dict[str, float]:
    """FLOPs of one update and their least time on the chip."""
    conv = backbone_flops(arch)
    head, frozen_in = head_flops(arch)
    act_rows, train_rows = (T + 1) * N, K * T * rows
    conv_total = (act_rows + train_rows) * conv
    rest = act_rows * head + train_rows * (3 * head - frozen_in)
    return {"flops": conv_total + rest, "least_s": conv_total / PEAK["bf16"] + rest / PEAK["f32"]}
