"""Loss functions.

Counterpart of vocal_remover_tpu/train/losses.py `l1` and
`mask_l1_loss`: the live training objective is L1(mask * X, y) on
magnitudes (reference train.py:89); validation is L1 on the
offset-trimmed masked spectrogram (train.py:122-130). The wave-domain
SDR losses are ROADMAP.md A9 (`--wave_loss`).
"""

from __future__ import annotations

import torch


def l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def mask_l1_loss(mask, X_mag, y_mag):
    """Training loss: L1 between masked mixture and instrumental target."""
    return l1(mask * X_mag, y_mag)
