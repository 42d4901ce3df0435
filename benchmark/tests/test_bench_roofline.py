"""The yardstick's arithmetic against counts made by hand."""

import pytest

from benchmark import roofline
from benchmark.reference.cma import Arch


def test_resnet50_flops():
    # torchvision's ResNet50 is 4.09 GMAC at 224, of which the classifier is
    # 2048 x 1000 and the trunk the rest
    assert roofline.tv_resnet50_flops(224) == pytest.approx(2 * (4.0895e9 - 2.048e6), rel=0.01)
    # stem of the depth net: 256 -> avg pool 128 -> 7x7 stride 2 -> 64x64 outputs, 32 filters of 1 x 49
    stem = 2.0 * 32 * 49 * 64 * 64
    assert roofline.gn_resnet50_flops(256, 128) > stem
    # the same trunk at a quarter of the width squared and (64/112)^2 of the
    # positions, one input channel, and the 3x3 compression 1024 -> 128 at 4x4
    trunk = roofline.tv_resnet50_flops(224) * 0.25 * (64 / 112) ** 2
    assert roofline.gn_resnet50_flops(256, 128) == pytest.approx(trunk + 2.0 * 128 * 1024 * 9 * 16, rel=0.02)


def test_lstm_and_gru_counts():
    proj, rec = roofline.lstm_flops(10, 768, 128)
    assert proj == 2 * 10 * 768 * 512 and rec == 2 * 10 * 128 * 512


def test_b1_bounds_by_hand():
    # T=1, B=64, H=512: 4 bytes x (xi 64*1536 + masks 64 + h0 64*512 + w_hh 1536*512 + b_hh 1536 + out 64*512)
    moved = 4 * (98304 + 64 + 32768 + 786432 + 1536 + 32768)
    flops = 2 * 1536 * 512 * 64 + 12 * 512 * 64
    assert roofline.b1_forward_s(1, 64, 512, gates=False) == pytest.approx(max(moved / 3.35e12, flops / 67e12))
    assert flops / 67e12 > moved / 3.35e12  # bound by operations
    rows = 64 * 5
    bwd_flops = 2 * rows * 1536 * 512 + rows * 20 * 512
    assert roofline.b1_backward_s(64, 5, 512) == pytest.approx(bwd_flops / 67e12)


def test_b2_bound_by_hand():
    # 64 RGB frames u8 480x640x3 -> 256x341x3: bytes in + bytes out over 3.35 TB/s
    moved = 64 * 480 * 640 * 3 + 64 * 256 * 341 * 3
    assert roofline.b2_s(64, (480, 640), (256, 341), 3, 1, 1) == pytest.approx(moved / 3.35e12)


def test_step_least_time_and_train_flops():
    rxr = Arch(num_actions=6, instr_tokens=False)
    least = roofline.rollout_step_least_s(rxr, 224, tokens=100.0)
    conv = roofline.tv_resnet50_flops(224) + roofline.gn_resnet50_flops(256, 128)
    assert least["flops"] > conv and least["least_s"] > conv / 989e12
    r2r = Arch(num_actions=4, progress_monitor=True)
    f = roofline.train_frame_flops(r2r, tokens=30.0)
    proj, rec = roofline.lstm_flops(30.0, 50, 128)
    assert f == pytest.approx(3 * (2 * (proj + rec) + roofline.cma_head_flops(r2r, 30.0)) - 2 * proj)
