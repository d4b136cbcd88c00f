"""Sliding-window math and patch extraction for whole-song separation.

Counterpart of vocal_remover_tpu/ops/windowing.py (the reference's
lib/dataset.py `make_padding` and inference.py patch loop): a song of
`width` STFT frames is left-padded by `offset`, right-padded so that
`roi_size = cropsize - 2*offset` divides the interior, cut into
overlapping `cropsize`-frame patches every `roi_size` frames, and each
patch contributes only its central `roi_size` frames to the output.
"""

from __future__ import annotations

import torch

__all__ = ["make_padding", "num_patches", "extract_patches", "stitch_masks"]


def make_padding(width: int, cropsize: int, offset: int):
    """(pad_left, pad_right, roi_size) for a `width`-frame spectrogram:
    every input frame is covered exactly once by a patch's valid
    (offset-trimmed) centre."""
    left = offset
    roi_size = cropsize - offset * 2
    if roi_size == 0:
        roi_size = cropsize
    right = roi_size - (width % roi_size) + left
    return left, right, roi_size


def num_patches(padded_width: int, roi_size: int, offset: int) -> int:
    """Patch count over an already-padded width."""
    return (padded_width - 2 * offset) // roi_size


def extract_patches(x, cropsize: int, roi_size: int, offset: int):
    """(..., T_padded) -> (num_patches, ..., cropsize); patch i covers
    [i*roi_size, i*roi_size + cropsize)."""
    n = num_patches(x.shape[-1], roi_size, offset)
    patches = x.unfold(-1, cropsize, roi_size)[..., :n, :]
    return patches.movedim(-2, 0)


def stitch_masks(masks, offset: int):
    """(num_patches, ..., cropsize) -> (..., num_patches * roi_size): the
    patches' valid centres, concatenated along time."""
    if offset > 0:
        masks = masks[..., offset:-offset]
    n, roi = masks.shape[0], masks.shape[-1]
    out = masks.movedim(0, -2)
    return out.reshape(*out.shape[:-2], n * roi)
