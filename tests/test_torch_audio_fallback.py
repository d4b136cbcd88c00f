"""GPU port: `utils/audio.load` when the native decoders fail to build.

Held against vocal_remover_tpu/utils/audio.py `load`, which sends a
compressed file to ffmpeg when its native decoder is unavailable. Here
the port's decoders cannot build (`CC=false`, an empty build directory)
and a stub `ffmpeg` on PATH writes a known WAV: the port's `load` returns
what the JAX package's returns for the same file; without ffmpeg it
raises naming both causes."""

import os
import shutil

import numpy as np
import pytest

from vocal_remover_tpu.utils import audio as jaudio
from vocal_remover_tpu_torch.native import build
from vocal_remover_tpu_torch.utils import audio, flac

SR = 8000


@pytest.fixture
def no_compiler(tmp_path, monkeypatch):
    """The port's decoders unbuilt and unbuildable in this process."""
    monkeypatch.setenv("CC", "false")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_mod", None)


def _song(tmp_path, ext):
    """A file of extension `ext` and the samples a decoder gives for it:
    a real FLAC stream, or bytes no decoder takes for .mp3 / .m4a."""
    path = str(tmp_path / f"song{ext}")
    t = np.arange(int(0.7 * SR)) / SR
    wave = np.stack([0.5 * np.sin(2 * np.pi * 440 * t),
                     0.3 * np.sin(2 * np.pi * 660 * t)])
    if ext == ".flac":
        flac.write_flac(path, wave, SR)
        return path, jaudio.read_flac(path)[0]
    with open(path, "wb") as f:
        f.write(bytes(range(256)) * 8)
    # PCM16 values (the port's encoder is native, unbuildable here)
    pcm = np.round(np.clip(wave.astype(np.float32), -1.0, 1.0 - 1.0 / 32768.0)
                   * np.float32(32768.0))
    return path, pcm.astype(np.float32) / 32768.0


def _stub_ffmpeg(tmp_path, monkeypatch, samples):
    """Put an `ffmpeg` on PATH that writes `samples` as a 16-bit WAV to
    its last argument, and point both packages at it."""
    known = str(tmp_path / "known.wav")
    jaudio.write_wav(known, samples, SR)  # the port's writer cannot build
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    stub = bin_dir / "ffmpeg"
    stub.write_text('#!/bin/sh\nfor a; do out="$a"; done\n'
                    f'cp "{known}" "$out"\n')
    stub.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}:{os.environ['PATH']}")
    found = shutil.which("ffmpeg")
    assert found == str(stub)
    monkeypatch.setattr(audio, "_FFMPEG", found)
    monkeypatch.setattr(jaudio, "_FFMPEG", found)


@pytest.mark.parametrize("ext", [".flac", ".mp3", ".m4a"])
def test_failed_build_goes_to_ffmpeg_as_in_jax(tmp_path, monkeypatch,
                                               no_compiler, ext):
    path, samples = _song(tmp_path, ext)
    _stub_ffmpeg(tmp_path, monkeypatch, samples)
    with pytest.raises(RuntimeError, match="false failed building"):
        build.build()
    got, got_sr = audio.load(path, sr=SR)
    want, want_sr = jaudio.load(path, sr=SR)
    assert got_sr == want_sr == SR and got.dtype == np.float32
    assert got.shape == want.shape == samples.shape
    np.testing.assert_array_equal(got, want)
    assert build._mod is None  # nothing was built


def test_failed_build_without_ffmpeg_names_both(tmp_path, monkeypatch,
                                                no_compiler):
    path, _ = _song(tmp_path, ".flac")
    monkeypatch.setattr(audio, "_FFMPEG", None)
    with pytest.raises(RuntimeError, match="failed to build") as e:
        audio.load(path, sr=SR)
    assert "false failed building" in str(e.value)
    assert "ffmpeg is not on PATH" in str(e.value)
