"""The controls of `correct` come out as not correct: the reference in
the precision below the configuration's (TF32 for float32), at the
published widths on one 30 s song or one training step. On the card only; the
full readings, at each cell's own size and load, come from
benchmark/calibrate.py."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import check_serve, check_train, harness, traffic
from benchmark import weights
from benchmark.reference import train as ref_train
from benchmark.reference.precision import tf32

pytestmark = pytest.mark.cuda


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def limits(cell):
    return json.loads((harness.BENCH_DIR / "limits" / f"{cell}.json")
                      .read_text())


def serve_files(cell):
    files = harness.cell_files(cell)
    return files["config"], files["traffic"]


@pytest.mark.parametrize("cell", ["serve-single-f32", "serve-dir-f32"])
def test_tf32_reference_fails_a_float32_serving_cell(cell):
    dev = card()
    cfg, tr = serve_files(cell)
    song = traffic.make_songs([30 * cfg["sr"]], cfg["sr"], 8, 41, dev)[0]
    sd = weights.make_state_dict(cfg, 41, dev)
    ref = check_serve.reference_stems(cfg, sd, tr, {0: song}, dev)
    low = check_serve.reference_stems(cfg, sd, tr, {0: song}, dev,
                                      allow_tf32=True)
    assert check_serve.numbers(low, ref)["nsr"] > limits(cell)["nsr"]


def test_tf32_reference_fails_the_training_cell():
    dev = card()
    cfg = harness.cell_files("train-b4-f32")["config"]
    sd = weights.make_state_dict(cfg, 43, dev)
    g = torch.Generator(device=dev).manual_seed(43)
    X = torch.rand(4, 2, 1025, 256, generator=g, device=dev)
    batches = [(X, X * torch.rand(X.shape, generator=g, device=dev))]
    readings = []
    for allow in (False, True):
        model = weights.reference_model(cfg, dev, sd)
        with tf32(allow):
            readings.append(ref_train.steps(model, batches, 1e-3, 43, dev))
    feed = torch.stack([check_train.fingerprint(*b) for b in batches])
    low = dict(zip(("losses", "grads", "change"), readings[1]),
               feed=feed.cpu().numpy())
    got = check_train.numbers(low, (*readings[0], 0.0, low["feed"]))
    assert any(got[k] > v for k, v in limits("train-b4-f32").items())
