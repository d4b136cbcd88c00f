"""Spectrogram cache (host-side, numpy).

Counterpart of vocal_remover_tpu/data/cache.py (reference
lib/spec_utils.py:122-154 `cache_or_load`): per-song complex
spectrograms cached as `.npy` next to the audio under `sr{}_hl{}_nf{}/`,
stored transposed as (T, 2, F) so the training loader can read random
time-crops as contiguous row chunks (the partial-read trick in reference
lib/dataset.py:28-47). The files are byte-identical to the JAX
package's for the same audio.
"""

from __future__ import annotations

import os

import numpy as np

from vocal_remover_tpu_torch.ops.stft import stft_np
from vocal_remover_tpu_torch.utils import audio
from vocal_remover_tpu_torch.utils.spec import align_wave_head_and_tail


def cache_dir_name(sr: int, hop_length: int, n_fft: int) -> str:
    return "sr{}_hl{}_nf{}".format(sr, hop_length, n_fft)


def cache_or_load(mix_path: str, inst_path: str, sr: int, hop_length: int,
                  n_fft: int):
    """-> (X_spec (2, F, T), y_spec, mix_cache_path, inst_cache_path)."""
    mix_basename = os.path.splitext(os.path.basename(mix_path))[0]
    inst_basename = os.path.splitext(os.path.basename(inst_path))[0]

    cd = cache_dir_name(sr, hop_length, n_fft)
    mix_cache_dir = os.path.join(os.path.dirname(mix_path), cd)
    inst_cache_dir = os.path.join(os.path.dirname(inst_path), cd)
    os.makedirs(mix_cache_dir, exist_ok=True)
    os.makedirs(inst_cache_dir, exist_ok=True)

    mix_cache_path = os.path.join(mix_cache_dir, mix_basename + ".npy")
    inst_cache_path = os.path.join(inst_cache_dir, inst_basename + ".npy")

    if os.path.exists(mix_cache_path) and os.path.exists(inst_cache_path):
        X = np.load(mix_cache_path).transpose(1, 2, 0)
        y = np.load(inst_cache_path).transpose(1, 2, 0)
    else:
        X, _ = audio.load(mix_path, sr=sr)
        y, _ = audio.load(inst_path, sr=sr)
        if X.ndim == 1:
            X = np.stack([X, X])
        if y.ndim == 1:
            y = np.stack([y, y])

        X, y = align_wave_head_and_tail(X, y, sr)

        X = stft_np(X, n_fft, hop_length)
        y = stft_np(y, n_fft, hop_length)

        np.save(mix_cache_path, np.ascontiguousarray(X.transpose(2, 0, 1)))
        np.save(inst_cache_path, np.ascontiguousarray(y.transpose(2, 0, 1)))

    if X.shape != y.shape:
        raise ValueError(f"{mix_path} and {inst_path} give spectrograms of "
                         f"shapes {X.shape} and {y.shape}")
    return X, y, mix_cache_path, inst_cache_path


def make_training_set(filelist, sr, hop_length, n_fft):
    """[(X_cache_path, y_cache_path, normalization_coef)] per song
    (reference lib/dataset.py:208-217)."""
    ret = []
    for X_path, y_path in filelist:
        X, y, X_cache_path, y_cache_path = cache_or_load(
            X_path, y_path, sr, hop_length, n_fft
        )
        coef = np.max([np.abs(X).max(), np.abs(y).max()])
        ret.append([X_cache_path, y_cache_path, coef])
    return ret


def read_npy_shape(path: str):
    """Parse only the .npy header (no data read)."""
    with open(path, "rb") as f:
        np.lib.format.read_magic(f)
        shape, _, _ = np.lib.format.read_array_header_1_0(f)
    return shape


def read_npy_rows(path: str, start_row: int, n_rows: int) -> np.ndarray:
    """Read rows [start_row, start_row + n_rows) of a C-ordered 3-D .npy
    without loading the file (reference lib/dataset.py:34-47)."""
    with open(path, "rb") as f:
        np.lib.format.read_magic(f)
        shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
        if fortran:
            raise ValueError(f"{path}: Fortran order arrays are not supported")
        row_size = int(np.prod(shape[1:]))
        f.seek(start_row * row_size * dtype.itemsize, 1)
        flat = np.fromfile(f, count=row_size * n_rows, dtype=dtype)
    return flat.reshape((-1,) + tuple(shape[1:]))
