"""WAV audio I/O, resampling and PCM16 encoding (numpy/scipy).

The port's own counterpart of vocal_remover_tpu/utils/audio.py and
native `pcm16_encode`: WAV decode (PCM 8/16/24/32, float32/float64), WAV
encode as 16-bit PCM (soundfile's WAV default, what the reference
writes), and band-limited sinc resampling with the
reference's `kaiser_fast` (utils/resample.py). Compressed formats (FLAC,
MP3, AAC) come with a later slice. Waves are float32, channel-first
(C, L).
"""

from __future__ import annotations

import os
import wave as _wave

import numpy as np
from scipy.io import wavfile

__all__ = ["DECODABLE_EXTS", "load", "read_wav", "write_wav", "resample",
           "pcm16_encode"]

# the extensions `load` decodes in this slice
DECODABLE_EXTS = (".wav",)


def pcm16_encode(wave: np.ndarray) -> np.ndarray:
    """float -> int16 PCM: clip to [-1, 1 - 1/32768], scale by 32768,
    round half to even (the PCM_16 WAV conversion)."""
    w = np.clip(np.asarray(wave, np.float32), -1.0, 1.0 - 1.0 / 32768.0)
    return np.round(w * np.float32(32768.0)).astype(np.int16)


def _pcm24_to_float32(raw: bytes, n_channels: int) -> np.ndarray:
    b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3).astype(np.int32)
    x = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
    x = (x ^ 0x800000) - 0x800000  # sign-extend 24 bit
    return (x.astype(np.float32) / 8388608.0).reshape(-1, n_channels)


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a WAV file -> ((C, L) float32 in [-1, 1], sample_rate)."""
    try:
        sr, data = wavfile.read(path)
    except ValueError:
        # scipy cannot read 24-bit PCM; parse it with the wave module
        with _wave.open(path, "rb") as f:
            if f.getsampwidth() != 3:
                raise
            nch, sr = f.getnchannels(), f.getframerate()
            data = _pcm24_to_float32(f.readframes(f.getnframes()), nch)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 1:
        data = data[:, None]
    return np.ascontiguousarray(data.T), int(sr)


def write_wav(path: str, wave: np.ndarray, sr: int):
    """Write a (C, L) or (L,) float wave as 16-bit PCM."""
    w = np.asarray(wave, np.float32)
    data = pcm16_encode(w.T if w.ndim == 2 else w)
    wavfile.write(path, sr, data[:, 0] if data.ndim == 2 and
                  data.shape[1] == 1 else data)


def resample(wave: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Resample (..., L) with the reference's `kaiser_fast` sinc filter."""
    if orig_sr == target_sr:
        return wave.astype(np.float32)
    from vocal_remover_tpu_torch.utils import resample as _sinc

    return _sinc.resample(wave, orig_sr, target_sr, "kaiser_fast")


def load(path: str, sr: int | None = 44100) -> tuple[np.ndarray, int]:
    """librosa.load(mono=False)-style: ((C, L) float32, or (L,) for a
    one-channel file, sample rate), resampled to `sr` when given. WAV
    only in this slice."""
    if os.path.splitext(path)[1].lower() not in DECODABLE_EXTS:
        raise ValueError(
            f"{path!r}: only WAV input is ported yet; FLAC, MP3 and AAC "
            "come with a later slice"
        )
    wave, file_sr = read_wav(path)
    if sr is not None and file_sr != sr:
        wave = resample(wave, file_sr, sr)
        file_sr = sr
    if wave.shape[0] == 1:
        wave = wave[0]  # librosa returns 1-D for mono files
    return wave.astype(np.float32), file_sr
