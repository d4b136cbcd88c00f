"""Host-side spectrogram utilities (numpy).

Counterpart of vocal_remover_tpu/utils/spec.py: `crop_center` (numpy
arrays and tensors), `merge_artifacts`, the
`--postprocess` mask refinement (reference lib/spec_utils.py:60-93),
`spectrogram_to_image`, the `--output_image` dump (:34-57), and the
training set's `trim_silence` / `align_wave_head_and_tail` (:96-119).
Their thresholds, fade bookkeeping, uint8 scaling and correlation are
their contract, so the arithmetic follows the reference step for step.
"""

from __future__ import annotations

import numpy as np

__all__ = ["crop_center", "merge_artifacts", "spectrogram_to_image",
           "trim_silence", "align_wave_head_and_tail"]


def crop_center(h1, h2):
    """Centre-crop `h1` along the time axis (-1) to `h2`'s width (numpy
    arrays or tensors of shape (..., T); reference lib/spec_utils.py:8-23
    crops dim 3 of NCHW tensors)."""
    t1, t2 = h1.shape[-1], h2.shape[-1]
    if t1 == t2:
        return h1
    if t1 < t2:
        raise ValueError("h1 time width must be >= h2 time width")
    s = (t1 - t2) // 2
    return h1[..., s:s + t2]


def merge_artifacts(y_mask, thres=0.05, min_range=64, fade_size=32):
    """Find runs of time frames whose mask minimum over (channel, freq)
    exceeds `thres` for longer than `min_range` frames, and fade the mask
    toward 1 there. Mutates and returns `y_mask` ((C, F, T) numpy)."""
    if min_range < fade_size * 2:
        raise ValueError("min_range must be >= fade_size * 2")

    idx = np.where(y_mask.min(axis=(0, 1)) > thres)[0]
    if len(idx) == 0:
        return y_mask
    # runs of consecutive frames
    breaks = np.where(np.diff(idx) != 1)[0]
    start_idx = np.insert(idx[breaks + 1], 0, idx[0])
    end_idx = np.append(idx[breaks], idx[-1])
    keep = np.where(end_idx - start_idx > min_range)[0]

    weight = np.zeros_like(y_mask)
    if len(keep) > 0:
        old_e = None
        for s, e in zip(start_idx[keep], end_idx[keep]):
            if old_e is not None and s - old_e < fade_size:
                s = old_e - fade_size * 2

            if s != 0:
                weight[:, :, s:s + fade_size] = np.linspace(0, 1, fade_size)
            else:
                s -= fade_size

            if e != y_mask.shape[2]:
                weight[:, :, e - fade_size:e] = np.linspace(1, 0, fade_size)
            else:
                e += fade_size

            weight[:, :, s + fade_size:e - fade_size] = 1
            old_e = e

    y_mask += weight * (1 - y_mask)
    return y_mask


def spectrogram_to_image(spec, mode="magnitude"):
    """Log-power (or phase) spectrogram -> uint8 image; a (C, F, T)
    spectrogram gives an (F, T, C + 1) image whose first channel is the
    max over the others."""
    if mode == "magnitude":
        y = np.abs(spec) if np.iscomplexobj(spec) else spec
        y = np.log10(y ** 2 + 1e-8)
    elif mode == "phase":
        y = np.angle(spec) if np.iscomplexobj(spec) else spec
    else:
        raise ValueError(mode)

    y = y - y.min()
    y = y * (255 / y.max())
    img = np.uint8(y)

    if y.ndim == 3:
        img = img.transpose(1, 2, 0)
        img = np.concatenate([np.max(img, axis=2, keepdims=True), img], axis=2)

    return img


def trim_silence(wave, top_db=60.0, frame_length=2048, hop_length=512):
    """Trim leading/trailing silence, equivalent to librosa.effects.trim
    defaults (used by reference lib/spec_utils.py:97-98).

    Args:
      wave: (C, L) or (L,) float array.
    Returns:
      (trimmed_wave, (start_sample, end_sample))
    """
    mono = wave if wave.ndim == 1 else wave.mean(axis=0)
    n = len(mono)
    if n == 0:
        return wave, (0, 0)
    # Padded, centered RMS frames (librosa.feature.rms with center=True).
    pad = frame_length // 2
    x = np.pad(mono.astype(np.float64), (pad, pad), mode="constant")
    n_frames = 1 + (len(x) - frame_length) // hop_length
    idx = np.arange(n_frames)[:, None] * hop_length + np.arange(frame_length)
    rms = np.sqrt(np.mean(x[idx] ** 2, axis=1))
    ref = rms.max()
    if ref <= 0:
        return wave[..., 0:0], (0, 0)
    db = 20.0 * np.log10(np.maximum(rms, 1e-40) / ref)
    nonsilent = np.where(db > -top_db)[0]
    if len(nonsilent) == 0:
        return wave[..., 0:0], (0, 0)
    start = int(nonsilent[0] * hop_length)
    end = int(min(n, (nonsilent[-1] + 1) * hop_length))
    return wave[..., start:end], (start, end)


def align_wave_head_and_tail(a, b, sr):
    """Cross-correlation alignment of a (mixture, instrumental) pair
    (reference lib/spec_utils.py:96-119): trim silence on both, estimate
    the delay from the first 4 seconds of the mono sums, shift, and
    truncate both to equal length."""
    a, _ = trim_silence(a)
    b, _ = trim_silence(b)

    a_mono = a[:, : sr * 4].sum(axis=0)
    b_mono = b[:, : sr * 4].sum(axis=0)

    a_mono = a_mono - a_mono.mean()
    b_mono = b_mono - b_mono.mean()

    offset = len(a_mono) - 1
    delay = int(np.argmax(np.correlate(a_mono, b_mono, "full"))) - offset

    if delay > 0:
        a = a[:, delay:]
    else:
        b = b[:, abs(delay):]

    if a.shape[1] < b.shape[1]:
        b = b[:, : a.shape[1]]
    else:
        a = a[:, : b.shape[1]]

    return a, b
