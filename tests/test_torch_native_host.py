"""GPU port: the host data-path kernels of the port's native extension
(native/host.c: `load_crop_abs`, `pcm16_encode`, `pcm16_decode`,
`quantize_u8`) against the JAX package's built extension
(native/vrtnative.c), byte for byte, and the paths that read through
them: TrainingSet's magnitude fast path and the device-resident
dataset's magnitudes, against the JAX package's default (C extension)
path. Numpy's |z| / coef differs from the C read by a few ulp in a third
to a half of the values, so these hold bits, not a tolerance."""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vocal_remover_tpu import native as jnative
from vocal_remover_tpu.data import cache as jcache
from vocal_remover_tpu.data import dataset as jdataset
from vocal_remover_tpu.data.device_cache import (
    DeviceTrainingSource as JDeviceTrainingSource,
)
from vocal_remover_tpu_torch import native
from vocal_remover_tpu_torch.native import build as native_build
from vocal_remover_tpu_torch.data import cache, dataset, device_cache
from vocal_remover_tpu_torch.data.device_cache import DeviceTrainingSource
from vocal_remover_tpu_torch.utils import audio


@pytest.fixture(scope="module", autouse=True)
def built():
    """Both extensions built; without a C compiler these tests skip, as
    tests/test_native.py does."""
    if not (os.environ.get("CC") or shutil.which("cc")):
        pytest.skip("no C compiler available")
    assert jnative.get() is not None, "the JAX package's extension"
    native_build.load()


def _cache(tmp_path, rng, T=300, F=129, name="c.npy"):
    arr = (rng.standard_normal((T, 2, F))
           + 1j * rng.standard_normal((T, 2, F))).astype(np.complex64)
    path = str(tmp_path / name)
    np.save(path, arr)
    return path, arr


@pytest.mark.parametrize("start,n,coef", [
    (0, 300, 1.0), (37, 256, 2.5), (299, 1, 0.37), (120, 64, 1e-3),
    (5, 7, np.float32(13.25)),
])
def test_load_crop_abs_equals_jax_bit_for_bit(tmp_path, start, n, coef):
    path, arr = _cache(tmp_path, np.random.default_rng(start + n))
    got = native.load_crop_abs(path, start, n, coef)
    want = jnative.load_crop_abs(path, start, n, coef)
    assert got.dtype == np.float32 and got.shape == (2, 129, n)
    assert np.array_equal(got, want)
    # numpy's expression is the same value to a few ulp, and not always it
    ref = (np.abs(arr[start:start + n].transpose(1, 2, 0)) / coef).astype(
        np.float32)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


def test_load_crop_abs_differs_from_numpy(tmp_path):
    """The fault the native read repairs: at full width (1025 bins), a
    crop of 256 rows at row 37 of a 400-row cache, coef the cache's max
    |z| as make_training_set gives it, numpy's |z| / coef and the C read
    disagree in about a third of the values (by 1-3 ulp, 1e-6 relative
    at most), so only the C read gives the JAX package's training
    items.""" 
    path, arr = _cache(tmp_path, np.random.default_rng(5), T=400, F=1025)
    coef = np.max([np.abs(arr).max()])
    got = native.load_crop_abs(path, 37, 256, coef)
    ref = (np.abs(arr[37:293].transpose(1, 2, 0)) / coef).astype(np.float32)
    share = float(np.mean(got != ref))
    assert 0.2 < share < 0.7, share
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


def test_load_crop_abs_rejects_bad_layout(tmp_path):
    path = str(tmp_path / "bad.npy")
    np.save(path, np.zeros((10, 3, 4), np.complex64))  # channel dim != 2
    with pytest.raises(ValueError, match="bad npy"):
        native.load_crop_abs(path, 0, 4, 1.0)
    with pytest.raises(ValueError):
        jnative.load_crop_abs(path, 0, 4, 1.0)
    good, _ = _cache(tmp_path, np.random.default_rng(1), T=10, F=4)
    with pytest.raises(ValueError):  # past the last row
        native.load_crop_abs(good, 8, 4, 1.0)
    with pytest.raises(ValueError):
        native.load_crop_abs(str(tmp_path / "missing.npy"), 0, 1, 1.0)


@pytest.mark.parametrize("shape", [(2, 5000), (4097,), (3, 2, 100)])
def test_pcm16_round_trip_equals_jax(shape):
    rng = np.random.default_rng(len(shape))
    w = (rng.standard_normal(shape) * 1.2).astype(np.float32)
    w.flat[:4] = [1.0, -1.0, 0.5 / 32768, 1.5 / 32768]  # clip, ties
    enc = native.pcm16_encode(w)
    assert enc.dtype == np.int16 and enc.shape == shape
    assert np.array_equal(enc, jnative.pcm16_encode(w))
    assert np.array_equal(enc, np.round(np.clip(
        w, -1.0, 1.0 - 1.0 / 32768.0) * 32768.0).astype(np.int16))
    # a float64, non-contiguous input is cast and laid out first
    wt = w.astype(np.float64).T
    assert np.array_equal(native.pcm16_encode(wt), jnative.pcm16_encode(wt))
    dec = native.pcm16_decode(enc)
    assert dec.dtype == np.float32 and dec.shape == shape
    assert np.array_equal(dec, jnative.pcm16_decode(enc))
    assert np.array_equal(dec, enc.astype(np.float32) / 32768.0)
    assert np.array_equal(native.pcm16_encode(dec), enc)


@pytest.mark.parametrize("case", ["plain", "nan_inf", "all_negative",
                                  "all_zero"])
def test_quantize_u8_equals_jax(case):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 2, 33, 40)) ** 2).astype(np.float32)
    if case == "nan_inf":
        x.flat[7], x.flat[100], x.flat[101] = np.nan, -np.inf, np.inf
    elif case == "all_negative":
        x = -x
    elif case == "all_zero":
        x = np.zeros_like(x)
    got, want = native.quantize_u8(x), jnative.quantize_u8(x)
    assert set(got) == {"q", "scale"}
    assert got["q"].dtype == np.uint8 and got["q"].shape == x.shape
    assert type(got["scale"]) is type(want["scale"]) is np.float32
    assert np.array_equal(got["q"], want["q"])
    assert got["scale"] == want["scale"]
    if case == "nan_inf":
        # +inf is the max: scale inf, every finite value 0, NaN 0
        assert got["scale"] == np.inf and got["q"].flat[7] == 0
    if case in ("all_negative", "all_zero"):
        assert got["scale"] == 1 and not got["q"].any()


SR, N_FFT, HOP = 8000, 256, 128


@pytest.fixture
def cached(tmp_path):
    """One cached 8 kHz stereo pair, written and cached by each package
    in its own directory (the same bytes): (the port's training set, the
    JAX package's)."""
    t = np.arange(int(SR * 2.5)) / SR
    y = np.stack([0.4 * np.sin(2 * np.pi * 190 * t)] * 2)
    x = y + 0.1 * np.sin(2 * np.pi * 700 * t)
    x = x + 0.01 * np.random.default_rng(11).standard_normal(x.shape)
    sets = []
    for pkg, c in (("port", cache), ("jax", jcache)):
        pair = [str(tmp_path / pkg / sub / "s.wav")
                for sub in ("mixtures", "instruments")]
        for path, wave in zip(pair, (x, y)):
            os.makedirs(os.path.dirname(path))
            audio.write_wav(path, wave, SR)
        sets.append(c.make_training_set([pair], SR, HOP, N_FFT))
    return sets


def test_training_items_equal_jax_default_path(cached):
    """TrainingSet's magnitude fast path reads through the native kernel
    in both packages: equal items, two epochs, crops that fit and one
    longer than the song (padded)."""
    tset, jset = cached
    for crop in (64, 400):
        kw = dict(cropsize=crop, reduction_rate=0.0, reduction_weight=None,
                  mixup_rate=0.0, mixup_alpha=1.0, seed=4)
        a = dataset.TrainingSet(tset * 3, **kw)
        b = jdataset.TrainingSet(jset * 3, **kw)
        for epoch in (0, 1):
            a.set_epoch(epoch)
            b.set_epoch(epoch)
            for i in range(len(a)):
                (x, y), (jx, jy) = a[i], b[i]
                assert x.shape == (2, N_FFT // 2 + 1, crop)
                assert np.array_equal(x, jx) and np.array_equal(y, jy)


def test_resident_magnitudes_equal_jax_device_source(cached, monkeypatch):
    """The device-resident dataset's magnitudes (port `_magnitudes`, and
    what a source holds at float32) equal the JAX package's
    DeviceTrainingSource's input read (its native branch) bit for bit."""
    monkeypatch.setattr(device_cache, "_RESIDENT_BYTES", 0)
    tset, jset = cached
    (X_path, y_path, coef), (jX_path, jy_path, jcoef) = tset[0], jset[0]
    assert coef == jcoef
    n = cache.read_npy_shape(X_path)[0]
    for p, jp in ((X_path, jX_path), (y_path, jy_path)):
        assert np.array_equal(device_cache._magnitudes(p, coef),
                              jnative.load_crop_abs(jp, 0, n, jcoef))
    src = DeviceTrainingSource(tset * 2, cropsize=32, dtype=torch.float32,
                               device="cpu")
    jsrc = JDeviceTrainingSource(jset * 2, cropsize=32, dtype=jnp.float32)
    assert np.array_equal(src.X_all.numpy(), np.asarray(jsrc.X_all))
    assert np.array_equal(src.y_all.numpy(), np.asarray(jsrc.y_all))
