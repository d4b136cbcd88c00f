"""Host-side spectrogram utilities (numpy).

Counterpart of vocal_remover_tpu/utils/spec.py `merge_artifacts`, the
`--postprocess` mask refinement (reference lib/spec_utils.py:60-93). Its
run-length thresholds and fade bookkeeping are its contract, so the
arithmetic follows the reference step for step.
"""

from __future__ import annotations

import numpy as np

__all__ = ["merge_artifacts"]


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
