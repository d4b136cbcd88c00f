"""GPU port: STFT / iSTFT and the patch windowing vs the JAX package."""

import numpy as np
import pytest
import torch

from vocal_remover_tpu.ops import stft as jstft
from vocal_remover_tpu.ops import windowing as jwin
from vocal_remover_tpu_torch.ops import stft as tstft
from vocal_remover_tpu_torch.ops import windowing as twin

torch.set_num_threads(1)


def test_hann_window_and_frame_count():
    np.testing.assert_array_equal(tstft.hann_window(256).numpy(),
                                  jstft.hann_window(256))
    for length in (1000, 1024, 44100):
        assert (tstft.num_frames(length, 2048, 1024)
                == jstft.num_frames(length, 2048, 1024))


@pytest.mark.parametrize("n_fft,hop", [(2048, 1024), (256, 128), (512, 128)])
def test_stft_matches_jax(rng, n_fft, hop):
    wave = rng.standard_normal((2, 11025)).astype(np.float32)
    re, im = jstft.stft(wave, n_fft, hop)
    tre, tim = tstft.stft(torch.from_numpy(wave), n_fft, hop)
    assert tre.shape == re.shape == (2, n_fft // 2 + 1,
                                     jstft.num_frames(11025, n_fft, hop))
    scale = np.abs(np.asarray(re) + 1j * np.asarray(im)).max()
    np.testing.assert_allclose(tre.numpy(), re, atol=2e-4 * scale)
    np.testing.assert_allclose(tim.numpy(), im, atol=2e-4 * scale)


@pytest.mark.parametrize("n_fft,hop,length", [
    (2048, 1024, 11025),  # trimmed to length
    (2048, 1024, None),   # natural length
    (256, 128, 12000),    # zero-padded past the last frame
    (512, 128, 11025),    # 75% overlap
])
def test_istft_matches_jax(rng, n_fft, hop, length):
    wave = rng.standard_normal((2, 11025)).astype(np.float32)
    re, im = (np.array(a) for a in jstft.stft(wave, n_fft, hop))
    ref = np.asarray(jstft.istft(re, im, n_fft, hop, length))
    out = tstft.istft(torch.from_numpy(re), torch.from_numpy(im), n_fft, hop,
                      length).numpy()
    assert out.shape == ref.shape
    scale = np.abs(re + 1j * im).max()
    np.testing.assert_allclose(out, ref, atol=2e-4 * scale)


@pytest.mark.parametrize("width,cropsize,offset", [
    (188, 256, 64), (1000, 256, 64), (300, 1024, 64), (50, 128, 0),
])
def test_windowing_matches_jax(rng, width, cropsize, offset):
    pad_l, pad_r, roi = twin.make_padding(width, cropsize, offset)
    assert (pad_l, pad_r, roi) == jwin.make_padding(width, cropsize, offset)
    padded = pad_l + width + pad_r
    n = twin.num_patches(padded, roi, offset)
    assert n == jwin.num_patches(padded, roi, offset)
    x = rng.standard_normal((2, 5, padded)).astype(np.float32)
    patches = twin.extract_patches(torch.from_numpy(x), cropsize, roi, offset)
    ref = np.asarray(jwin.extract_patches(x, cropsize, roi, offset))
    assert patches.shape == ref.shape == (n, 2, 5, cropsize)
    np.testing.assert_array_equal(patches.numpy(), ref)
    np.testing.assert_array_equal(
        twin.stitch_masks(patches, offset).numpy(),
        np.asarray(jwin.stitch_masks(ref, offset)))
