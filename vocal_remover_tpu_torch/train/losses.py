"""Loss functions.

Counterpart of vocal_remover_tpu/train/losses.py: the live training
objective is L1(mask * X, y) on magnitudes (reference train.py:89);
validation is L1 on the offset-trimmed masked spectrogram
(train.py:122-130). The wave-domain SDR losses that the reference
defines but leaves dormant (train.py:37-65, commented out at :83-88 /
:125-129) are live here, as in the JAX package, through the device
iSTFT (ops/stft.py `istft`, differentiable).
"""

from __future__ import annotations

import torch

from vocal_remover_tpu_torch.ops.stft import istft


def l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def mask_l1_loss(mask, X_mag, y_mag):
    """Training loss: L1 between masked mixture and instrumental target."""
    return l1(mask * X_mag, y_mag)


def to_wave(spec_re, spec_im, n_fft, hop_length):
    """Batched device iSTFT of (..., F, T) re/im spectrograms (reference
    train.py:37-43 `to_wave`)."""
    return istft(spec_re, spec_im, n_fft, hop_length)


def _correlation(a, b, eps):
    return torch.sum(a * b) / (torch.linalg.vector_norm(a)
                               * torch.linalg.vector_norm(b) + eps)


def sdr_loss(y, y_pred, eps=1e-8):
    """Negative scale-invariant correlation SDR (reference
    train.py:46-50)."""
    return -_correlation(y, y_pred, eps)


def weighted_sdr_loss(y, y_pred, n, n_pred, eps=1e-8):
    """Noise-weighted SDR (reference train.py:53-65)."""
    a = torch.sum(y ** 2)
    a = a / (torch.sum(y ** 2) + torch.sum(n ** 2) + eps)
    return -(a * _correlation(y, y_pred, eps)
             + (1 - a) * _correlation(n, n_pred, eps))
