"""Native audio decoders: FLAC, MP3, AAC-LC and HE-AAC (SBR).

Counterpart of vocal_remover_tpu/native `flac_decode` / `mp3_decode` /
`aac_decode`, on the port's own copy of the C decoders, built at first
use (build.py). A malformed stream raises ValueError; a failed build
raises RuntimeError.
"""

from __future__ import annotations

import numpy as np

__all__ = ["flac_decode", "mp3_decode", "aac_decode"]


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
