"""GPU port, the library keywords of audio I/O and the ops against the
JAX package's, with the same inputs: `load(mono=, dtype=)`,
`write_wav(subtype=)`, `resample(res_type=)`, `have_ffmpeg`,
`crop_center`, `istft_length`, `hann_window(dtype=)`, `interp_taps`,
`resize_bilinear(lerp2x=)`, `upsample2x`'s default and `imread`."""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vocal_remover_tpu.ops import resize as jresize
from vocal_remover_tpu.ops import stft as jstft
from vocal_remover_tpu.utils import audio as jaudio
from vocal_remover_tpu.utils import image as jimage
from vocal_remover_tpu.utils import spec as jspec
from vocal_remover_tpu_torch.ops import resize, stft
from vocal_remover_tpu_torch.utils import audio, image, spec

SR = 8000


def _wave(channels=2, seconds=0.3, seed=51):
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * seconds)) / SR
    w = [0.5 * np.sin(2 * np.pi * (220 + 110 * c) * t)
         + 0.05 * rng.standard_normal(t.size) for c in range(channels)]
    return np.stack(w).astype(np.float32)


@pytest.mark.parametrize("subtype", ["PCM_16", "FLOAT"])
def test_write_wav_subtype_matches_jax(tmp_path, subtype):
    """The same file bytes as JAX's writer, stereo and one channel;
    FLOAT reads back exactly."""
    for w in (_wave(2), _wave(1)[0]):
        p, jp = str(tmp_path / "p.wav"), str(tmp_path / "j.wav")
        audio.write_wav(p, w * 1.3, SR, subtype=subtype)
        jaudio.write_wav(jp, w * 1.3, SR, subtype=subtype)
        with open(p, "rb") as f, open(jp, "rb") as g:
            assert f.read() == g.read()
        if subtype == "FLOAT":
            got, sr = audio.read_wav(p)
            assert sr == SR and np.array_equal(got.reshape(w.shape), w * 1.3)
    for writer in (audio.write_wav, jaudio.write_wav):
        with pytest.raises(ValueError, match="unsupported subtype"):
            writer(str(tmp_path / "x.wav"), _wave(), SR, subtype="PCM_24")


@pytest.mark.parametrize("sr", [SR, 11025, None])
@pytest.mark.parametrize("mono,dtype", [(False, np.float32),
                                        (True, np.float32),
                                        (True, np.float64)])
def test_load_mono_dtype_matches_jax(tmp_path, sr, mono, dtype):
    """Resampled first, then the channel mean (JAX's order), in `dtype`;
    a one-channel file is 1-D either way."""
    for ch in (2, 1):
        path = str(tmp_path / f"s{ch}.wav")
        audio.write_wav(path, _wave(ch), SR)
        got, gsr = audio.load(path, sr=sr, mono=mono, dtype=dtype)
        want, wsr = jaudio.load(path, sr=sr, mono=mono, dtype=dtype)
        assert gsr == wsr and got.dtype == want.dtype == dtype
        assert got.shape == want.shape
        assert got.ndim == (1 if mono or ch == 1 else 2)
        assert np.array_equal(got, want)


@pytest.mark.parametrize("res_type", ["kaiser_fast", "kaiser_best",
                                      "polyphase"])
def test_resample_res_type_matches_jax(res_type):
    w = _wave(2, seconds=0.1)
    for target in (16000, 6000):
        got = audio.resample(w, SR, target, res_type=res_type)
        want = jaudio.resample(w, SR, target, res_type=res_type)
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got, want)
    assert audio.resample(w, SR, SR, res_type=res_type).dtype == np.float32


def test_have_ffmpeg_matches_jax():
    assert audio.have_ffmpeg() is jaudio.have_ffmpeg()


def test_crop_center_matches_jax():
    rng = np.random.default_rng(52)
    h1 = rng.standard_normal((2, 3, 4, 11)).astype(np.float32)
    for t2 in (11, 7, 4):
        h2 = np.zeros((1, t2))
        want = jspec.crop_center(h1, h2)
        assert np.array_equal(spec.crop_center(h1, h2), want)
        got = spec.crop_center(torch.from_numpy(h1), torch.zeros(3, t2))
        assert isinstance(got, torch.Tensor)
        assert np.array_equal(got.numpy(), want)
    for fn in (spec.crop_center, jspec.crop_center):
        with pytest.raises(ValueError, match="time width"):
            fn(h1, np.zeros((1, 12)))


def test_istft_length_matches_jax_and_istft():
    for n_frames, n_fft, hop in ((1, 256, 128), (37, 256, 64), (9, 2048,
                                                                 1024)):
        n = stft.istft_length(n_frames, n_fft, hop)
        assert n == jstft.istft_length(n_frames, n_fft, hop)
        spec_ = np.zeros((2, n_fft // 2 + 1, n_frames), np.complex64)
        assert stft.istft_np(spec_, n_fft, hop).shape[-1] == n


def test_hann_window_dtype_matches_jax():
    for n in (256, 2048, 1):
        w = stft.hann_window(n)
        assert w.dtype == torch.float32 and w.device.type == "cpu"
        assert np.array_equal(w.numpy(), jstft.hann_window(n))
        w64 = stft.hann_window(n, "cpu", dtype=torch.float64)
        assert w64.dtype == torch.float64
        assert np.array_equal(w64.numpy(), jstft.hann_window(n, np.float64))
        assert torch.equal(stft.hann_window(n, dtype=torch.bfloat16),
                           w64.to(torch.bfloat16))


def test_interp_taps_match_jax():
    for n_in, n_out in ((5, 10), (7, 3), (1, 6), (6, 1), (128, 256)):
        for a, b in zip(resize.interp_taps(n_in, n_out),
                        jresize.interp_taps(n_in, n_out), strict=True):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.numpy(), 1, -1)


@pytest.mark.parametrize("in_hw,out_hw", [
    ((5, 7), (10, 14)),  # both axes exactly 2x
    ((5, 7), (10, 9)),   # one axis 2x, the other a general ratio
    ((1, 8), (2, 16)),   # 1 -> 2: the lerp and the broadcast agree
    ((4, 3), (7, 5)),    # general ratios: the matrix either way
])
@pytest.mark.parametrize("lerp2x", [True, False])
def test_resize_bilinear_lerp2x_matches_jax(in_hw, out_hw, lerp2x):
    x = np.random.default_rng(53).standard_normal((2, *in_hw, 3)).astype(
        np.float32)
    want = np.asarray(jresize.resize_bilinear(jnp.asarray(x), *out_hw,
                                              lerp2x=lerp2x))
    got = resize.resize_bilinear(_nchw(x), *out_hw, lerp2x=lerp2x)
    np.testing.assert_allclose(_nhwc(got), want, rtol=0, atol=3e-6)
    if lerp2x and in_hw == (5, 7):  # the lerp is the phase-split formula
        lerp = resize._up2x_axis(_nchw(x), 2)
        if out_hw[1] == 14:
            lerp = resize._up2x_axis(lerp, 3)
        else:
            lerp = resize.resize_bilinear(lerp, 10, 9, lerp2x=False)
        assert torch.equal(got, lerp)


def test_upsample2x_default_is_jax_default():
    """Both packages lerp by default; lerp=False is the matrix form."""
    x = np.random.default_rng(54).standard_normal((1, 6, 5, 2)).astype(
        np.float32)
    want = np.asarray(jresize.upsample2x(jnp.asarray(x)))
    got = resize.upsample2x(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), want, rtol=0, atol=1e-6)
    assert torch.equal(got, resize.upsample2x(_nchw(x), lerp=True))
    assert torch.equal(resize.upsample2x(_nchw(x), lerp=False),
                       resize.resize_bilinear(_nchw(x), 12, 10,
                                              lerp2x=False))


def test_imread_matches_jax(tmp_path, monkeypatch, capsys):
    """With PIL: the array JAX's imread gives; a file that is not an
    image, or no PIL: None, the error printed, as JAX's."""
    pytest.importorskip("PIL")
    img = np.random.default_rng(55).integers(0, 256, (9, 7, 3), np.uint8)
    path = str(tmp_path / "i.png")
    assert image.imwrite(path, img)
    got, want = image.imread(path), jimage.imread(path)
    assert np.array_equal(got, want) and np.array_equal(got, img)
    bad = str(tmp_path / "bad.png")
    with open(bad, "wb") as f:
        f.write(b"not an image")
    capsys.readouterr()
    assert image.imread(bad) is None and jimage.imread(bad) is None
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and out[0] == out[1]
    monkeypatch.setitem(sys.modules, "PIL", None)  # no PIL to import
    monkeypatch.setattr(jimage, "_HAVE_PIL", False)
    assert image.imread(path) is None and jimage.imread(path) is None
    assert capsys.readouterr().out == "PIL unavailable\n" * 2
