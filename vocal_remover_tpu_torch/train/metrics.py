"""Separation quality metrics, on host arrays.

Counterpart of vocal_remover_tpu/train/metrics.py (the reference
computes no quality metric beyond the L1 spectrogram loss, SURVEY.md
section 5): the energy-ratio SDR of the MDX / MUSDB18 leaderboards, the
scale-invariant SI-SDR, and museval's median of one-second SDRs.
"""

from __future__ import annotations

import numpy as np

__all__ = ["sdr", "si_sdr", "framewise_sdr", "median_sdr"]


def sdr(reference: np.ndarray, estimate: np.ndarray, eps=1e-8) -> float:
    """10 log10(||s||^2 / ||s - s_hat||^2) over the whole signal."""
    num = np.sum(reference ** 2)
    den = np.sum((reference - estimate) ** 2)
    return float(10.0 * np.log10((num + eps) / (den + eps)))


def si_sdr(reference: np.ndarray, estimate: np.ndarray, eps=1e-8) -> float:
    """Scale-invariant SDR: the estimate projected onto the reference."""
    ref = reference - reference.mean()
    est = estimate - estimate.mean()
    alpha = np.sum(ref * est) / (np.sum(ref ** 2) + eps)
    target = alpha * ref
    return float(10.0 * np.log10((np.sum(target ** 2) + eps)
                                 / (np.sum((est - target) ** 2) + eps)))


def framewise_sdr(reference, estimate, sr, win_seconds=1.0, eps=1e-8):
    """SDRs of non-overlapping windows (museval's chunking); windows where
    the reference is silent are skipped."""
    win = int(sr * win_seconds)
    out = []
    for s in range(0, reference.shape[-1] - win + 1, win):
        ref = reference[..., s:s + win]
        if np.sum(ref ** 2) < eps:
            continue
        out.append(sdr(ref, estimate[..., s:s + win], eps))
    return np.asarray(out)


def median_sdr(reference, estimate, sr, win_seconds=1.0) -> float:
    """Median of the framewise SDRs, the MUSDB18 headline statistic."""
    frames = framewise_sdr(reference, estimate, sr, win_seconds)
    return float(np.median(frames)) if len(frames) else float("nan")
