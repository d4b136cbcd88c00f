"""Native host code: audio decoders (FLAC, MP3, AAC-LC and HE-AAC with
SBR) and the host data-path kernels.

Counterpart of vocal_remover_tpu/native: `flac_decode` / `mp3_decode` /
`aac_decode`, and `load_crop_abs` / `pcm16_encode` / `pcm16_decode` /
`quantize_u8` with the JAX package's signatures and results, on the
port's own copy of the C sources, built at first use (build.py). The JAX
package falls back to numpy where its extension does not build; the port
does not: a failed build raises RuntimeError. A malformed stream or .npy
file raises ValueError.
"""

from __future__ import annotations

import numpy as np

__all__ = ["flac_decode", "mp3_decode", "aac_decode", "load_crop_abs",
           "pcm16_encode", "pcm16_decode", "quantize_u8"]


def _ext():
    from vocal_remover_tpu_torch.native import build

    return build.load()


def flac_decode(data: bytes):
    """FLAC stream bytes -> ((n, ch) int32 pcm, sample_rate, bps)."""
    raw, n, ch, sr, bps = _ext().flac_decode(data)
    return np.frombuffer(raw, "<i4").reshape(n, ch), sr, bps


def mp3_decode(data: bytes):
    """MP3 stream bytes -> ((n, ch) float32 pcm, sample_rate)."""
    raw, n, ch, sr = _ext().mp3_decode(data)
    return np.frombuffer(raw, np.float32).reshape(n, ch), sr


def aac_decode(data: bytes):
    """AAC bytes (ADTS stream or MP4 / M4A container; AAC-LC or HE-AAC)
    -> ((n, ch) float32 pcm, sample_rate)."""
    raw, n, ch, sr = _ext().aac_decode(data)
    return np.frombuffer(raw, np.float32).reshape(n, ch), sr


def load_crop_abs(path: str, start_row: int, n_rows: int,
                  coef: float) -> np.ndarray:
    """Rows [start_row, start_row + n_rows) of a C-ordered (T, 2, F)
    complex64 .npy -> (2, F, n_rows) float32 |z| / coef, read in one
    pass: sqrtf(re * re + im * im) * (float)(1 / coef)."""
    data, F = _ext().load_crop_abs(path, start_row, n_rows, float(coef))
    return np.frombuffer(data, np.float32).reshape(2, F, n_rows)


def pcm16_encode(wave: np.ndarray) -> np.ndarray:
    """float -> int16 PCM of the same shape: clip to [-1, 1 - 1/32768],
    scale by 32768, round half to even (the PCM_16 WAV conversion)."""
    w = np.ascontiguousarray(wave, np.float32)
    return np.frombuffer(_ext().pcm16_encode(w), np.int16).reshape(w.shape)


def pcm16_decode(pcm: np.ndarray) -> np.ndarray:
    """int16 PCM -> float32 x / 32768 of the same shape."""
    p = np.ascontiguousarray(pcm, np.int16)
    return np.frombuffer(_ext().pcm16_decode(p), np.float32).reshape(p.shape)


def quantize_u8(a: np.ndarray) -> dict:
    """float32 array -> {"q": uint8 array, "scale": float32}: the scale
    puts 255 at the largest value (max taken from 0, so NaN and negative
    values do not count; 1 when none is positive), values are multiplied
    by the float32 reciprocal of the scale, clamped to [0, 255] (NaN to
    0) and rounded half to even. The int8 batch staging's quantizer."""
    a = np.ascontiguousarray(a, np.float32)
    raw, scale = _ext().quantize_u8(a)
    return {"q": np.frombuffer(raw, np.uint8).reshape(a.shape),
            "scale": np.float32(scale)}
