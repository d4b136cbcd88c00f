"""Pitch shifting: a phase-vocoder time stretch, then a resample.

Counterpart of vocal_remover_tpu/utils/pitch.py, the built-in stand-in
for the external `soundstretch -pitch=N` that the reference's offline
augmentation shells out to (reference augment.py:28-29, 59-60). Built on
the port's host STFT (`ops/stft.py` `stft_np` / `istft_np`) and its
`kaiser_fast` resampler, with the JAX package's dtypes: the loop mixes
float32 angles of the complex64 spectrogram with a float64 phase advance
and writes complex64, so both packages give the same samples.
"""

from __future__ import annotations

import numpy as np

from vocal_remover_tpu_torch.ops.stft import istft_np, stft_np
from vocal_remover_tpu_torch.utils.audio import resample


def time_stretch(wave: np.ndarray, rate: float, n_fft: int = 2048,
                 hop_length: int = 512) -> np.ndarray:
    """Phase-vocoder time stretch of a (..., L) wave by `rate` (rate > 1
    speeds up), librosa's algorithm."""
    spec = stft_np(wave, n_fft, hop_length)  # (..., F, T)
    n_bins, n_frames = spec.shape[-2], spec.shape[-1]

    steps = np.arange(0, n_frames, rate)
    stretched = np.zeros(spec.shape[:-1] + (len(steps),), np.complex64)

    phi_advance = np.linspace(0, np.pi * hop_length, n_bins)
    phase_acc = np.angle(spec[..., 0])

    # two zero frames so the last steps can interpolate
    spec_pad = np.concatenate(
        [spec, np.zeros(spec.shape[:-1] + (2,), spec.dtype)], axis=-1)

    for t, step in enumerate(steps):
        i = int(step)
        frac = step - i
        s0 = spec_pad[..., i]
        s1 = spec_pad[..., i + 1]
        mag = (1 - frac) * np.abs(s0) + frac * np.abs(s1)
        stretched[..., t] = mag * np.exp(1.0j * phase_acc)
        dphase = np.angle(s1) - np.angle(s0) - phi_advance
        dphase = dphase - 2 * np.pi * np.round(dphase / (2 * np.pi))
        phase_acc = phase_acc + phi_advance + dphase

    out_len = int(round(wave.shape[-1] / rate))
    return istft_np(stretched, n_fft, hop_length, length=out_len)


def pitch_shift(wave: np.ndarray, sr: int, n_steps: float,
                n_fft: int = 2048, hop_length: int = 512) -> np.ndarray:
    """Shift the pitch by `n_steps` semitones, keeping the duration."""
    if n_steps == 0:
        return wave.astype(np.float32)
    rate = 2.0 ** (-n_steps / 12.0)
    stretched = time_stretch(wave, rate, n_fft, hop_length)
    # read at sr / rate and resampled to sr: the duration comes back and
    # every frequency is scaled by 2 ** (n_steps / 12)
    shifted = resample(stretched, orig_sr=int(round(sr / rate)),
                       target_sr=sr)
    n = wave.shape[-1]
    if shifted.shape[-1] >= n:
        return shifted[..., :n].astype(np.float32)
    pad = [(0, 0)] * (shifted.ndim - 1) + [(0, n - shifted.shape[-1])]
    return np.pad(shifted, pad).astype(np.float32)
