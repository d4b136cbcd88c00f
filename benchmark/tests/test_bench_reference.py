"""The plain references against the port's CPU path, at a tiny size:
the same weights give the same masks, stems and first training loss."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import program, traffic, weights
from benchmark.reference import serve as ref_serve
from benchmark.reference import train as ref_train

TINY = {"n_fft": 256, "hop_length": 128, "nout": 8, "nout_lstm": 16,
        "offset": 64, "sr": 8000}
CPU = torch.device("cpu")


def models(seed=3):
    sd = weights.make_state_dict(TINY, seed, CPU)
    port = program.model(TINY, sd, CPU, "highest")
    return sd, port, weights.reference_model(TINY, CPU, sd).eval()


def test_state_dicts_share_the_published_keys():
    sd, port, ref = models()
    assert set(sd) == set(port.state_dict()) == set(ref.state_dict())


def test_eval_masks_agree():
    _, port, ref = models()
    x = torch.rand(2, 2, 129, 256, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        assert torch.allclose(port(x), ref(x), atol=1e-6)


@pytest.mark.parametrize("bucket", [0, 8000])
def test_stems_agree(bucket):
    from vocal_remover_tpu_torch.separate.separator import Separator

    _, port, ref = models()
    song = traffic.make_songs([21000], 8000, 4, 5, CPU)[0]
    sep = Separator(port, batchsize=2, cropsize=256, device=CPU)
    y, v = sep.separate_wave(song, pcm16_io=True, bucket=bucket or None)
    yr, vr = ref_serve.separate(ref, torch.from_numpy(song), 256, 2, bucket)
    m = yr.shape[1]
    assert 21000 - 128 < m <= 21000
    for got, want in ((y, yr), (v, vr)):
        d = np.abs(got[:, :m].astype(np.int32) - want.numpy())
        assert d.max() <= 1


def test_first_training_loss_agrees():
    """Train mode with the same dropout stream: the port's Trainer's
    first loss is the reference's."""
    from vocal_remover_tpu_torch.train.step import Trainer

    sd, port, ref = models()
    g = torch.Generator().manual_seed(2)
    X = torch.rand(2, 2, 129, 256, generator=g)
    y = X * torch.rand(2, 2, 129, 256, generator=g)
    trainer = Trainer(port, learning_rate=1e-3, seed=11, device="cpu")
    loss = trainer.train_epoch([(X.numpy(), y.numpy())])
    losses, _, _ = ref_train.steps(ref, [(X, y)], 1e-3, 11, CPU)
    assert loss == pytest.approx(losses[0], rel=1e-5)
