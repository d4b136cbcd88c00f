"""GPU port, tools slice: the port's host metrics (train/metrics.py) and
pitch shifting (utils/pitch.py) against the JAX package's on the same
seeded inputs."""

import numpy as np
import pytest

from vocal_remover_tpu.train import metrics as jmetrics
from vocal_remover_tpu.utils import pitch as jpitch
from vocal_remover_tpu_torch.train import metrics
from vocal_remover_tpu_torch.utils import pitch

SR = 8000


def _signals(seed, n=3 * SR):
    rng = np.random.default_rng(seed)
    ref = rng.standard_normal((2, n)).astype(np.float32)
    est = (0.8 * ref + 0.3 * rng.standard_normal((2, n))).astype(np.float32)
    ref[:, SR:SR + SR // 2] = 0  # a silent stretch: skipped windows
    return ref, est


@pytest.mark.parametrize("name,args", [
    ("sdr", ()),
    ("si_sdr", ()),
    ("median_sdr", (SR,)),
    ("median_sdr", (SR, 0.25)),
])
@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_match_jax(name, args, seed):
    """Within 1e-9 relative."""
    ref, est = _signals(seed)
    got = getattr(metrics, name)(ref, est, *args)
    want = getattr(jmetrics, name)(ref, est, *args)
    assert isinstance(got, float) and np.isfinite(got)
    assert got == pytest.approx(want, rel=1e-9, abs=0)


def test_framewise_sdr_matches_jax():
    ref, est = _signals(2)
    got = metrics.framewise_sdr(ref, est, SR, 0.5)
    want = jmetrics.framewise_sdr(ref, est, SR, 0.5)
    assert len(got) == len(want) == 5  # one of the six windows is silent
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)
    assert np.isnan(metrics.median_sdr(ref[:, :10], est[:, :10], SR))


def _wave(seconds=2.0):
    """Stereo 8 kHz wave: two tones and a little noise."""
    rng = np.random.default_rng(5)
    t = np.arange(int(SR * seconds)) / SR
    w = np.stack([0.5 * np.sin(2 * np.pi * 440 * t),
                  0.4 * np.sin(2 * np.pi * 660 * t)])
    return (w + 0.02 * rng.standard_normal(w.shape)).astype(np.float32)


@pytest.mark.parametrize("n_steps", [-1, 2, 0])
def test_pitch_shift_matches_jax(n_steps):
    """Bit-identical: the same host STFT, loop dtypes and resampler."""
    w = _wave()
    got = pitch.pitch_shift(w, SR, n_steps, n_fft=512, hop_length=128)
    want = jpitch.pitch_shift(w, SR, n_steps, n_fft=512, hop_length=128)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == w.shape
    assert np.array_equal(got, want)
    if n_steps == 0:
        assert np.array_equal(got, w)


@pytest.mark.parametrize("rate", [0.8, 1.25])
def test_time_stretch_matches_jax(rate):
    w = _wave(1.0)
    got = pitch.time_stretch(w, rate, n_fft=256, hop_length=64)
    want = jpitch.time_stretch(w, rate, n_fft=256, hop_length=64)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.shape[-1] == int(round(w.shape[-1] / rate))
    assert np.array_equal(got, want)


def test_pitch_shift_moves_the_tone():
    """+12 semitones doubles a 440 Hz tone (the port's own check of the
    algorithm, beside the parity above)."""
    t = np.arange(SR) / SR
    w = np.sin(2 * np.pi * 440 * t).astype(np.float32)[None]
    out = pitch.pitch_shift(w, SR, 12, n_fft=1024, hop_length=256)[0]
    spec = np.abs(np.fft.rfft(out[SR // 4:3 * SR // 4]))
    peak = np.argmax(spec) * SR / (SR // 2)
    assert abs(peak - 880) < 20
