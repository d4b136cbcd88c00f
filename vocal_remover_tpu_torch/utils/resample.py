"""Band-limited sinc-interpolation resampling (resampy-compatible).

The port's own copy of vocal_remover_tpu/utils/resample.py (numpy only).

The reference loads audio through `librosa.load(..., res_type=
'kaiser_fast')` (reference inference.py:136-138, lib/spec_utils.py:
139-142), which resamples with resampy's windowed-sinc interpolator
[Smith, "Digital audio resampling", CCRMA]. A polyphase resampler is
the same *family* but not the same *numbers*, so spectrogram caches
built from resampled sources would not be comparable with
reference-era caches (VERDICT.md missing #5). This module implements
the same algorithm:

  * filter: right half of `rolloff * sinc(rolloff * t)` over
    `num_zeros` zero crossings sampled at `precision` points per
    crossing, tapered by a Kaiser window (beta per quality preset) —
    resampy's `sinc_window` construction with the published
    kaiser_fast / kaiser_best parameters.
  * kernel: for each output time, both filter wings are evaluated by
    linear interpolation into the precomputed table and dot-multiplied
    against the input neighborhood; when downsampling, the filter is
    time-stretched and amplitude-scaled by the rate ratio.
  * length: the engine emits floor(n * ratio) samples (resampy), and
    `resample()` fixes the result to ceil(n * ratio) samples exactly
    like `librosa.resample(..., fix=True)`.

The kernel is vectorized over output samples (the tap count is bounded
by `num_zeros / min(ratio, 1)` per wing, so the tap loop is short) —
no per-sample Python loop. Exactness vs the resampy *package* can only
be certified where resampy is installed; the construction and kernel
follow its published algorithm and constants.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.signal.windows import kaiser

__all__ = ["resample", "sinc_window", "QUALITY"]

# resampy quality presets: (num_zeros, precision bits per crossing,
# rolloff, kaiser beta)
QUALITY = {
    "kaiser_fast": (16, 512, 0.85, 8.555504641634386),
    "kaiser_best": (64, 512, 0.9475937167399596, 12.984585247040012),
}

_TABLE_CACHE: dict = {}


def sinc_window(num_zeros: int, precision: int, rolloff: float,
                beta: float) -> np.ndarray:
    """Right half of the windowed-sinc interpolation filter
    (`num_zeros * precision + 1` taps, tap 0 = filter center)."""
    n = num_zeros * precision
    t = np.linspace(0, num_zeros, n + 1, endpoint=True)
    win = rolloff * np.sinc(rolloff * t)
    taper = kaiser(2 * n + 1, beta)[n:]
    return (win * taper).astype(np.float64)


def _table(res_type: str):
    tab = _TABLE_CACHE.get(res_type)
    if tab is None:
        try:
            num_zeros, precision, rolloff, beta = QUALITY[res_type]
        except KeyError:
            raise ValueError(
                f"unknown res_type {res_type!r}; options: {sorted(QUALITY)}"
            ) from None
        win = sinc_window(num_zeros, precision, rolloff, beta)
        delta = np.empty_like(win)
        delta[:-1] = np.diff(win)
        delta[-1] = 0.0
        tab = _TABLE_CACHE[res_type] = (win, delta, precision)
    return tab


def _resample_1d_wings(x: np.ndarray, n_out: int, ratio: float,
                       win: np.ndarray, delta: np.ndarray,
                       precision: int) -> np.ndarray:
    """The interpolation kernel, vectorized over output samples.

    x: (..., n_in) float64. Returns (..., n_out) float64.
    (The whole-array case of the chunked kernel below.)
    """
    return _resample_1d_wings_offset(x, 0, n_out, 0, ratio, win, delta,
                                     precision)


def _resample_1d_wings_offset(x_seg, o0, o1, i0, ratio, win, delta,
                              precision):
    """Chunked variant: compute outputs [o0, o1) from the input segment
    starting at absolute sample i0. Exact only when x_seg covers every
    tap of every output in the range (callers pad with `margin`) OR the
    segment border coincides with the true array border (the global
    edges, where the short-window sums ARE the correct behavior)."""
    scale = min(ratio, 1.0)
    if scale < 1.0:
        win = win * scale
        delta = delta * scale
    index_step = int(scale * precision)
    if index_step == 0:
        # ratio below 1/precision (e.g. 44100 -> <90 Hz with the
        # kaiser_fast table): the filter table has no resolution left
        # and the tap-count bound below would floor-divide by zero.
        raise ValueError(
            f"resample ratio {ratio:.2e} is below the filter table's "
            f"resolution (1/{precision}); downsample in stages instead"
        )
    nwin = win.shape[0]
    n_seg = x_seg.shape[-1]

    t_out = np.arange(o0, o1, dtype=np.float64) / ratio
    n0 = t_out.astype(np.int64)
    n_loc = n0 - i0  # local index of the anchor sample

    y = np.zeros(x_seg.shape[:-1] + (o1 - o0,), np.float64)

    frac = scale * (t_out - n0)
    index_frac = frac * precision
    offset = index_frac.astype(np.int64)
    eta = index_frac - offset
    i_max_all = np.minimum(n0 + 1, (nwin - offset) // index_step)
    i_max_all = np.minimum(i_max_all, n_loc + 1)
    for i in range(int(max(i_max_all.max(), 0))):
        ok = i < i_max_all
        idx = np.where(ok, offset + i * index_step, 0)
        w = (win[idx] + eta * delta[idx]) * ok
        src = np.where(ok, n_loc - i, 0)
        y += w * x_seg[..., src]

    frac_r = scale - frac
    index_frac = frac_r * precision
    offset = index_frac.astype(np.int64)
    eta = index_frac - offset
    k_max_all = np.minimum(n_seg - n_loc - 1, (nwin - offset) // index_step)
    for k in range(int(max(k_max_all.max(), 0))):
        ok = k < k_max_all
        idx = np.where(ok, offset + k * index_step, 0)
        w = (win[idx] + eta * delta[idx]) * ok
        src = np.where(ok, n_loc + 1 + k, 0)
        y += w * x_seg[..., src]

    return y


# output-axis chunk size for the long-signal path (module-level so
# tests can shrink it to exercise chunk boundaries cheaply)
_CHUNK = 1 << 20


def resample(x: np.ndarray, orig_sr: int, target_sr: int,
             res_type: str = "kaiser_fast") -> np.ndarray:
    """Resample (..., L) along the last axis; float32 out.

    Matches `librosa.resample(..., res_type=res_type, fix=True)`
    semantics: the band-limited interpolator produces floor(L * ratio)
    samples and the result is zero-padded/trimmed to ceil(L * ratio).
    """
    if orig_sr == target_sr:
        return np.asarray(x, np.float32)
    if orig_sr <= 0 or target_sr <= 0:
        raise ValueError("sample rates must be positive")

    ratio = float(target_sr) / float(orig_sr)
    n_in = x.shape[-1]
    n_engine = int(n_in * ratio)
    n_target = int(math.ceil(n_in * ratio))

    win, delta, precision = _table(res_type)
    xd = np.asarray(x, np.float64)
    # chunk the output axis: the vectorized kernel materializes
    # ~taps x chunk doubles of temporaries (a 10-minute song would
    # otherwise peak at hundreds of MB)
    CHUNK = _CHUNK
    if n_engine <= CHUNK:
        y = _resample_1d_wings(xd, n_engine, ratio, win, delta, precision)
    else:
        parts = []
        nwin = win.shape[0]
        # per-wing tap count exactly as the kernel bounds it:
        # (nwin - offset) // index_step with index_step FLOORED
        # (a fractional-step estimate undercounts and would clip the
        # outermost taps at chunk boundaries)
        index_step = max(1, int(min(ratio, 1.0) * precision))
        margin = nwin // index_step + 2
        for o0 in range(0, n_engine, CHUNK):
            o1 = min(o0 + CHUNK, n_engine)
            # input span feeding outputs [o0, o1), plus filter margins
            i0 = max(0, int(o0 / ratio) - margin)
            i1 = min(n_in, int(o1 / ratio) + margin + 1)
            seg = _resample_1d_wings_offset(
                xd[..., i0:i1], o0, o1, i0, ratio, win, delta, precision
            )
            parts.append(seg)
        y = np.concatenate(parts, axis=-1)
    if n_engine < n_target:
        pad = [(0, 0)] * (y.ndim - 1) + [(0, n_target - n_engine)]
        y = np.pad(y, pad)
    elif n_engine > n_target:
        y = y[..., :n_target]
    return y.astype(np.float32)
