"""Centred STFT / iSTFT (librosa semantics).

Counterpart of vocal_remover_tpu/ops/stft.py `stft`/`istft`: reflect
padding of n_fft // 2 per side, periodic Hann window, win_length ==
n_fft; the inverse overlap-adds the windowed frames, divides by the
window sum of squares where it exceeds float32's tiny, trims n_fft // 2
per side and then trims or zero-pads to `length`. Real and imaginary
parts travel as a pair of real tensors, as in the JAX package.

`stft_np` / `istft_np` are the host (numpy) mirrors of `stft_np` /
`istft_np` there, for the spectrogram path (`Separator.separate`, the
CLI's `--postprocess` / `--output_image`): a float64 window and
overlap-add, `np.fft`, complex64 spectrograms.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["hann_window", "num_frames", "istft_length", "frame_spectrum",
           "stft", "overlap_add", "istft", "stft_np", "istft_np"]


def _hann_np(n_fft: int) -> np.ndarray:
    """Periodic Hann window in float64."""
    n = np.arange(n_fft)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / n_fft)


def hann_window(n_fft: int, device=None,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Periodic Hann window in `dtype` on `device`, computed in float64
    as the JAX package does."""
    return torch.from_numpy(_hann_np(n_fft)).to(device, dtype)


def num_frames(length: int, n_fft: int, hop_length: int) -> int:
    """Number of STFT frames for a centred transform of `length` samples."""
    return 1 + (length + 2 * (n_fft // 2) - n_fft) // hop_length


def istft_length(n_frames: int, n_fft: int, hop_length: int) -> int:
    """Output length of a centred iSTFT (librosa's default, length=None)."""
    return n_fft + hop_length * (n_frames - 1) - 2 * (n_fft // 2)


def frame_spectrum(x, n_fft: int, hop_length: int):
    """Un-centred STFT of an already padded slice: (..., length) float32
    -> (real, imag), each (..., n_fft//2 + 1, n_frames) float32, frame t
    windowing samples [t * hop, t * hop + n_fft). The counterpart of the
    JAX package's framing by `_device_frame_indices`, for callers that do
    their own padding (segment streaming)."""
    lead = x.shape[:-1]
    frames = x.reshape(-1, x.shape[-1]).unfold(-1, n_fft, hop_length)
    spec = torch.fft.rfft(frames * hann_window(n_fft, x.device), dim=-1)
    spec = spec.transpose(-1, -2).reshape(*lead, n_fft // 2 + 1, -1)
    return spec.real.float(), spec.imag.float()


def stft(wave, n_fft: int, hop_length: int):
    """(..., length) float32 -> (real, imag), each (..., n_fft//2 + 1,
    n_frames) float32."""
    pad = n_fft // 2
    x = torch.nn.functional.pad(wave.reshape(1, -1, wave.shape[-1]),
                                (pad, pad), mode="reflect")
    return frame_spectrum(x[0].reshape(*wave.shape[:-1], -1), n_fft,
                          hop_length)


def overlap_add(frames, hop_length: int):
    """(B, n_frames, n_fft) -> (B, n_fft + hop * (n_frames - 1))."""
    b, n_frames, n_fft = frames.shape
    total = n_fft + hop_length * (n_frames - 1)
    out = torch.nn.functional.fold(
        frames.transpose(1, 2), output_size=(1, total),
        kernel_size=(1, n_fft), stride=(1, hop_length),
    )
    return out.reshape(b, total)


def istft(real, imag, n_fft: int, hop_length: int, length: int | None = None):
    """(..., n_bins, n_frames) real/imag pair -> (..., length) float32."""
    lead = real.shape[:-2]
    n_frames = real.shape[-1]
    spec = torch.complex(real, imag).reshape(-1, *real.shape[-2:])
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1)
    window = hann_window(n_fft, real.device)
    y = overlap_add(frames * window, hop_length)
    wss = overlap_add((window * window).expand(1, n_frames, n_fft),
                      hop_length)
    tiny = float(np.finfo(np.float32).tiny)
    y = torch.where(wss > tiny, y / wss.clamp_min(tiny), y)
    pad = n_fft // 2
    y = y[..., pad:y.shape[-1] - pad]
    if length is not None:
        if length <= y.shape[-1]:
            y = y[..., :length]
        else:
            y = torch.nn.functional.pad(y, (0, length - y.shape[-1]))
    return y.reshape(*lead, y.shape[-1])


@functools.lru_cache(maxsize=32)
def _frame_indices(n_frames: int, n_fft: int, hop_length: int) -> np.ndarray:
    return (np.arange(n_frames)[:, None] * hop_length
            + np.arange(n_fft)[None, :]).astype(np.int32)


@functools.lru_cache(maxsize=32)
def _window_sumsquare(n_frames: int, n_fft: int,
                      hop_length: int) -> np.ndarray:
    """Sum of the squared synthesis windows over the overlap-add grid
    (float32, as the JAX package keeps it)."""
    w2 = _hann_np(n_fft) ** 2
    out = np.zeros(n_fft + hop_length * (n_frames - 1), np.float64)
    for t in range(n_frames):
        out[t * hop_length:t * hop_length + n_fft] += w2
    return out.astype(np.float32)


def stft_np(wave: np.ndarray, n_fft: int, hop_length: int) -> np.ndarray:
    """Host STFT: (..., length) -> complex64 (..., n_fft//2 + 1,
    n_frames)."""
    pad = n_fft // 2
    x = np.pad(wave, [(0, 0)] * (wave.ndim - 1) + [(pad, pad)],
               mode="reflect")
    idx = _frame_indices(num_frames(wave.shape[-1], n_fft, hop_length),
                         n_fft, hop_length)
    frames = x[..., idx] * _hann_np(n_fft)
    spec = np.fft.rfft(frames, axis=-1).astype(np.complex64)
    return np.moveaxis(spec, -1, -2)


def istft_np(spec: np.ndarray, n_fft: int, hop_length: int,
             length: int | None = None) -> np.ndarray:
    """Host iSTFT of a complex (..., n_bins, n_frames) array -> float32
    (..., length); `length` None keeps the natural length."""
    n_frames = spec.shape[-1]
    frames = np.fft.irfft(np.moveaxis(spec, -1, -2), n=n_fft, axis=-1)
    frames = frames * _hann_np(n_fft)
    y = np.zeros(frames.shape[:-2] + (n_fft + hop_length * (n_frames - 1),),
                 np.float64)
    for t in range(n_frames):
        y[..., t * hop_length:t * hop_length + n_fft] += frames[..., t, :]
    wss = _window_sumsquare(n_frames, n_fft, hop_length).astype(np.float64)
    tiny = np.finfo(np.float32).tiny
    y = np.where(wss > tiny, y / np.maximum(wss, tiny), y)
    pad = n_fft // 2
    y = y[..., pad:y.shape[-1] - pad]
    if length is not None:
        if length <= y.shape[-1]:
            y = y[..., :length]
        else:
            y = np.pad(y, [(0, 0)] * (y.ndim - 1)
                       + [(0, length - y.shape[-1])])
    return y.astype(np.float32)
