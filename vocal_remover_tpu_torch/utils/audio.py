"""Audio I/O, resampling and PCM16 encoding (numpy/scipy).

The port's own counterpart of vocal_remover_tpu/utils/audio.py: WAV
decode (PCM 8/16/24/32, float32/float64), FLAC, MP3 and AAC (AAC-LC and
HE-AAC in .m4a / .mp4 / raw .aac ADTS) through the port's native
decoders (native/), ffmpeg (when on PATH) for a stream they reject or
when they fail to build, WAV encode as 16-bit PCM (soundfile's WAV
default, what the reference writes; the native `pcm16_encode`) or
float32, and band-limited sinc resampling with the reference's
`kaiser_fast` (utils/resample.py; also `kaiser_best`, and scipy's
polyphase filter). Waves are float32, channel-first (C, L).
"""

from __future__ import annotations

import math
import os
import shutil
import subprocess
import tempfile
import wave as _wave

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly

from vocal_remover_tpu_torch.native import pcm16_encode

__all__ = ["load", "read_wav", "read_flac", "read_mp3", "read_aac",
           "write_wav", "resample", "have_ffmpeg", "pcm16_encode"]

_FFMPEG = shutil.which("ffmpeg")


def have_ffmpeg() -> bool:
    return _FFMPEG is not None


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


def write_wav(path: str, wave: np.ndarray, sr: int, subtype: str = "PCM_16"):
    """Write a (C, L) or (L,) float wave: `subtype` "PCM_16" (soundfile's
    WAV default, what the reference writes) or "FLOAT" (float32)."""
    w = np.asarray(wave, np.float32)
    data = w.T if w.ndim == 2 else w[:, None]  # (L, C)
    if subtype == "PCM_16":
        data = pcm16_encode(data)
    elif subtype != "FLOAT":
        raise ValueError(f"unsupported subtype {subtype!r}")
    wavfile.write(path, sr, data[:, 0] if data.shape[1] == 1 else data)


def resample(wave: np.ndarray, orig_sr: int, target_sr: int,
             res_type: str = "kaiser_fast") -> np.ndarray:
    """Resample (..., L): `kaiser_fast` (the reference's) or `kaiser_best`
    band-limited sinc interpolation with librosa / resampy's constants,
    or `polyphase` (scipy's resample_poly, in float64)."""
    if orig_sr == target_sr:
        return wave.astype(np.float32)
    if res_type == "polyphase":
        g = math.gcd(orig_sr, target_sr)
        out = resample_poly(wave.astype(np.float64), target_sr // g,
                            orig_sr // g, axis=-1)
        return out.astype(np.float32)
    from vocal_remover_tpu_torch.utils import resample as _sinc

    return _sinc.resample(wave, orig_sr, target_sr, res_type)


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def read_flac(path: str) -> tuple[np.ndarray, int]:
    """Read a FLAC file -> ((C, L) float32 in [-1, 1], sample_rate)."""
    from vocal_remover_tpu_torch import native

    pcm, sr, bps = native.flac_decode(_read(path))
    wave = pcm.astype(np.float32) / float(1 << (bps - 1))
    return np.ascontiguousarray(wave.T), int(sr)


def read_mp3(path: str) -> tuple[np.ndarray, int]:
    """Read an MP3 file (MPEG-1/2/2.5 Layer III) -> ((C, L) float32,
    sample_rate)."""
    from vocal_remover_tpu_torch import native

    wave, sr = native.mp3_decode(_read(path))
    return np.ascontiguousarray(wave.T), int(sr)


def read_aac(path: str) -> tuple[np.ndarray, int]:
    """Read an AAC file (.m4a / .mp4 container or raw .aac ADTS; AAC-LC
    or HE-AAC) -> ((C, L) float32, sample_rate)."""
    from vocal_remover_tpu_torch import native

    wave, sr = native.aac_decode(_read(path))
    return np.ascontiguousarray(wave.T), int(sr)


def _load_via_ffmpeg(path: str) -> tuple[np.ndarray, int]:
    if _FFMPEG is None:
        raise RuntimeError(
            f"cannot decode {path!r}: the native decoders reject it or do "
            "not read its format, and ffmpeg is not on PATH")
    with tempfile.TemporaryDirectory() as td:
        out = os.path.join(td, "decoded.wav")
        subprocess.run([_FFMPEG, "-v", "error", "-i", path, "-f", "wav",
                        "-c:a", "pcm_f32le", out], check=True)
        return read_wav(out)


# extension -> the reader that decodes it without ffmpeg
_READERS = {".wav": read_wav, ".flac": read_flac, ".mp3": read_mp3,
            ".m4a": read_aac, ".mp4": read_aac, ".aac": read_aac}


def load(path: str, sr: int | None = 44100, mono: bool = False,
         dtype=np.float32) -> tuple[np.ndarray, int]:
    """librosa.load-style: ((C, L), or (L,) for a one-channel file or
    with `mono` (the channels' mean, taken after the resample), in
    `dtype`; sample rate), resampled to `sr` when given. A
    compressed stream goes to ffmpeg, as in the JAX package, when its
    native decoder rejects it (ValueError) or the decoders fail to build
    (RuntimeError); without ffmpeg on PATH the error names both."""
    reader = _READERS.get(os.path.splitext(path)[1].lower())
    if reader is None:
        wave, file_sr = _load_via_ffmpeg(path)
    elif reader is read_wav:
        wave, file_sr = read_wav(path)
    else:
        try:
            wave, file_sr = reader(path)
        except ValueError:
            wave, file_sr = _load_via_ffmpeg(path)
        except RuntimeError as e:  # native/build.py: no compiler, or it failed
            if _FFMPEG is None:
                raise RuntimeError(
                    f"cannot decode {path!r}: the native audio decoders "
                    f"failed to build ({e}), and ffmpeg is not on PATH"
                ) from e
            wave, file_sr = _load_via_ffmpeg(path)
    if sr is not None and file_sr != sr:
        wave = resample(wave, file_sr, sr)
        file_sr = sr
    if mono and wave.shape[0] > 1:
        wave = wave.mean(axis=0, keepdims=True)
    if mono or wave.shape[0] == 1:
        wave = wave[0]  # librosa returns 1-D for mono files
    return wave.astype(dtype), file_sr
