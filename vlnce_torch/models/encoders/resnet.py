"""Visual backbones (port of vlnce_tpu/models/encoders/resnet.py).

Two architectures, matching the reference's encoders weight for weight
(reference vlnce_baselines/models/encoders/resnet_encoders.py:17-229), with
the reference's state_dict key names:

- GNResNetEncoder: habitat-DDPPO ResNet (GroupNorm, baseplanes 32, 7x7 stem,
  avg-pool-2 input stem, 3x3 compression head to a ~2048-element spatial
  output). Used for depth. Keys: backbone.conv1.{0,1},
  backbone.layer{i}.{b}.convs.*, .downsample.{0,1}, compression.{0,1}.
- TVResNet: torchvision ResNet50/18 trunk with frozen BatchNorm, as an
  indexed Sequential (cnn.0 = conv1, cnn.1 = bn1, cnn.4..7 = layer1..4).
  Used for RGB.

Tensors are NCHW logically; on CUDA the policy keeps them channels_last,
which is the JAX package's NHWC in memory. Everything runs in the activation
dtype (bf16 on the card by default) with f32 parameters cast at use.
Convolutions go to cuDNN: none of them is a kernel of the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Conv2d):
    """Conv2d that runs in its input's dtype (f32 weights cast at use)."""

    def forward(self, x):
        w = self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, w, b, self.stride, self.padding, self.dilation, self.groups)


class GroupNorm(nn.GroupNorm):
    """GroupNorm whose affine runs in its input's dtype."""

    def forward(self, x):
        return F.group_norm(x, self.num_groups, self.weight.to(x.dtype), self.bias.to(x.dtype), self.eps)


class FrozenBatchNorm(nn.Module):
    """Eval-mode BatchNorm as a fixed affine over running stats. The affine
    is folded in f32 and applied in the input's dtype (resnet.py:51-56)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        inv = self.weight * torch.rsqrt(self.running_var + self.eps)
        scale = inv.to(x.dtype).view(1, -1, 1, 1)
        shift = (self.bias - self.running_mean * inv).to(x.dtype).view(1, -1, 1, 1)
        return x * scale + shift


def _conv(cin, cout, k, stride=1, padding=0):
    return Conv2d(cin, cout, k, stride, padding, bias=False)


# ---------------------------------------------------------------------------
# GroupNorm ResNet (habitat-DDPPO architecture)
# ---------------------------------------------------------------------------


class GNBasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin, planes, ngroups, stride=1):
        super().__init__()
        self.convs = nn.Sequential(
            _conv(cin, planes, 3, stride, 1), GroupNorm(ngroups, planes), nn.ReLU(True),
            _conv(planes, planes, 3, 1, 1), GroupNorm(ngroups, planes),
        )
        self.downsample = None
        if stride != 1 or cin != planes:
            self.downsample = nn.Sequential(_conv(cin, planes, 1, stride), GroupNorm(ngroups, planes))

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(self.convs(x) + residual)


class GNBottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, planes, ngroups, stride=1):
        super().__init__()
        out_ch = planes * self.expansion
        self.convs = nn.Sequential(
            _conv(cin, planes, 1), GroupNorm(ngroups, planes), nn.ReLU(True),
            _conv(planes, planes, 3, stride, 1), GroupNorm(ngroups, planes), nn.ReLU(True),
            _conv(planes, out_ch, 1), GroupNorm(ngroups, out_ch),
        )
        self.downsample = None
        if stride != 1 or cin != out_ch:
            self.downsample = nn.Sequential(_conv(cin, out_ch, 1, stride), GroupNorm(ngroups, out_ch))

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(self.convs(x) + residual)


class GNResNet(nn.Module):
    """habitat_baselines.rl.ddppo.policy.resnet.ResNet equivalent."""

    def __init__(self, in_channels: int, base_planes: int, ngroups: int, layers, block):
        super().__init__()
        self.conv1 = nn.Sequential(
            _conv(in_channels, base_planes, 7, 2, 3), GroupNorm(ngroups, base_planes), nn.ReLU(True),
        )
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        inplanes = base_planes
        for li, (num_blocks, stride) in enumerate(zip(layers, (1, 2, 2, 2))):
            planes = base_planes * (2**li)
            blocks = []
            for b in range(num_blocks):
                blocks.append(block(inplanes, planes, ngroups, stride if b == 0 else 1))
                inplanes = planes * block.expansion
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
        self.out_channels = inplanes

    def forward(self, x):
        x = self.maxpool(self.conv1(x))
        for li in range(1, 5):
            x = getattr(self, f"layer{li}")(x)
        return x


class GNResNetEncoder(nn.Module):
    """habitat ResNetEncoder: avg-pool-2 stem -> GNResNet -> 3x3 compression
    conv (GroupNorm(1), ReLU) sized for a ~2048-element flat output."""

    def __init__(self, input_hw: Tuple[int, int] = (256, 256), in_channels: int = 1, base_planes: int = 32,
                 ngroups: int = 16, backbone: str = "resnet50"):
        super().__init__()
        layers = {"resnet18": (2, 2, 2, 2), "resnet50": (3, 4, 6, 3)}[backbone]
        block = GNBasicBlock if backbone == "resnet18" else GNBottleneck
        self.input_hw = tuple(input_hw)
        self.backbone = GNResNet(in_channels, base_planes, ngroups, layers, block)
        num_c, _, _ = self.output_shape_chw()
        self.compression = nn.Sequential(
            _conv(self.backbone.out_channels, num_c, 3, 1, 1), GroupNorm(1, num_c), nn.ReLU(True),
        )

    def output_shape_chw(self) -> Tuple[int, int, int]:
        spatial = self.input_hw[0] // 2  # avg-pool stem
        final_spatial = max(1, int(spatial * (1.0 / 32.0)))
        num_c = int(round(2048 / (final_spatial**2)))
        return (num_c, final_spatial, final_spatial)

    def forward(self, x):
        """x: [B, C, H, W] -> [B, c_compressed, h, w]."""
        return self.compression(self.backbone(F.avg_pool2d(x, 2)))


# ---------------------------------------------------------------------------
# torchvision-style ResNet (frozen BatchNorm)
# ---------------------------------------------------------------------------


class TVBasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin, planes, stride=1):
        super().__init__()
        self.conv1 = _conv(cin, planes, 3, stride, 1)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3, 1, 1)
        self.bn2 = FrozenBatchNorm(planes)
        self.downsample = None
        if stride != 1 or cin != planes:
            self.downsample = nn.Sequential(_conv(cin, planes, 1, stride), FrozenBatchNorm(planes))

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(y)) + residual)


class TVBottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, planes, stride=1):
        super().__init__()
        out_ch = planes * self.expansion
        self.conv1 = _conv(cin, planes, 1)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3, stride, 1)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = _conv(planes, out_ch, 1)
        self.bn3 = FrozenBatchNorm(out_ch)
        self.downsample = None
        if stride != 1 or cin != out_ch:
            self.downsample = nn.Sequential(_conv(cin, out_ch, 1, stride), FrozenBatchNorm(out_ch))

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        return F.relu(self.bn3(self.conv3(y)) + residual)


def tv_resnet(version: str = "resnet50") -> Tuple[nn.Sequential, int]:
    """torchvision resnet18/50 trunk through layer4 (no pool/fc) as the
    reference's indexed Sequential; returns (trunk, output channels)."""
    layers = {"resnet18": (2, 2, 2, 2), "resnet50": (3, 4, 6, 3)}[version]
    block = TVBasicBlock if version == "resnet18" else TVBottleneck
    mods = [_conv(3, 64, 7, 2, 3), FrozenBatchNorm(64), nn.ReLU(True), nn.MaxPool2d(3, 2, 1)]
    inplanes = 64
    for li, (num_blocks, stride) in enumerate(zip(layers, (1, 2, 2, 2))):
        planes = 64 * (2**li)
        blocks = []
        for b in range(num_blocks):
            blocks.append(block(inplanes, planes, stride if b == 0 else 1))
            inplanes = planes * block.expansion
        mods.append(nn.Sequential(*blocks))
    return nn.Sequential(*mods), inplanes
