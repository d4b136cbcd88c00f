"""benchmark/flops.py against torch.utils.flop_counter on the plain
reference at full width (shapes only: the meta device). The counter sees
the convolutions and the matrix products (BiLSTM, dense heads); the
reference resizes by F.interpolate, which it does not count, and which
flops.py counts apart as lerps."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops, weights

PUBLISHED = {"n_fft": 2048, "hop_length": 1024, "nout": 32, "nout_lstm": 128,
             "offset": 64, "sr": 44100}


@pytest.mark.parametrize("crop", [256, 1024])
def test_forward_matches_flop_counter(crop):
    model = weights.reference_model(PUBLISHED, "meta").eval()
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(torch.zeros(1, 2, 1025, crop, device="meta"))
    counts = {str(k): v for k, v in counter.get_flop_counts()["Global"].items()}
    f = flops.forward_flops(PUBLISHED, 1, crop)
    assert counts["aten.convolution"] == f["conv"]
    assert counter.get_total_flops() == f["conv"] + f["lstm"] + f["dense"]
    assert 0 < f["resize"] < 0.01 * f["total"]


def test_scales_with_batch_and_counts_training():
    one = flops.forward_flops(PUBLISHED, 1, 256)["total"]
    assert flops.forward_flops(PUBLISHED, 4, 256)["total"] == 4 * one
    train = flops.train_flops(PUBLISHED, 4, 256)
    fwd = flops.forward_flops(PUBLISHED, 4, 256)
    # every product but the first layers' input gradients, thrice
    assert 2.9 * fwd["conv"] < train["conv"] < 3 * fwd["conv"]
    assert train["lstm"] == 3 * fwd["lstm"]


def test_bounds():
    # the recurrence at the flagship's largest crop-256 launch (T 128,
    # 2N 8, H 64) is bound by its operations: 0.000505 ms (PERF.md)
    assert flops.recurrence_bound_s(128, 8, 64) == pytest.approx(
        0.000505e-3, rel=0.01)
    f32 = flops.conv_bound_s(PUBLISHED, 4, 256, "highest")
    bf16 = flops.conv_bound_s(PUBLISHED, 4, 256, "bfloat16")
    assert f32 >= 4 * flops.forward_flops(PUBLISHED, 1, 256)["conv"] \
        / flops.PEAK_F32_FLOPS
    assert bf16 < f32


def test_useful_patches():
    # the published separator's count: one patch past whole rois
    cfg = PUBLISHED
    roi = 256 - 2 * 64
    assert flops.useful_patches(1024 * (roi - 1) - 1, cfg, 256) == 1
    assert flops.useful_patches(1024 * roi, cfg, 256) == 2
