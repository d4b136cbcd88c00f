"""Bilinear resampling with PyTorch `align_corners=True` semantics.

Counterpart of vocal_remover_tpu/ops/resize.py in its eval form: each
axis is resized by a row-stochastic two-taps-per-row interpolation
matrix as a dense matrix product (frequency first, then time), and a
1 -> n resize (ASPP's frequency-pooled branch) is a broadcast.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["interp_matrix", "upsample2x", "resize_bilinear"]


@functools.lru_cache(maxsize=128)
def interp_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Row-stochastic (n_out, n_in) matrix for 1-D align_corners=True
    linear interpolation (source index = i * (n_in-1) / (n_out-1))."""
    A = np.zeros((n_out, n_in), np.float32)
    if n_in == 1 or n_out == 1:
        A[:, 0] = 1.0
        return A
    src = np.arange(n_out, dtype=np.float64) * (n_in - 1) / (n_out - 1)
    i0 = np.clip(np.floor(src).astype(np.int64), 0, n_in - 2)
    w = src - i0
    A[np.arange(n_out), i0] = (1.0 - w).astype(np.float32)
    A[np.arange(n_out), i0 + 1] += w.astype(np.float32)
    return A


def _matrix(n_in: int, n_out: int, device: torch.device, dtype: torch.dtype):
    """The interp matrix as a tensor, kept per (device, dtype) for the
    eager path. A trace (torch.export, torch.compile) gets a fresh one,
    which it records as a constant: the tensor belongs to that trace
    (its fake mode) and must not stay in the cache, where a later eager
    call would find it."""
    if torch.compiler.is_compiling():
        return torch.from_numpy(interp_matrix(n_in, n_out).copy()).to(
            device, dtype)
    return _cached_matrix(n_in, n_out, device, dtype)


@functools.lru_cache(maxsize=128)
def _cached_matrix(n_in: int, n_out: int, device: torch.device,
                   dtype: torch.dtype):
    return torch.from_numpy(interp_matrix(n_in, n_out)).to(device, dtype)


def resize_bilinear(x, out_h: int, out_w: int):
    """Resize NCHW `x` to (out_h, out_w) with align_corners=True."""
    h, w = x.shape[2], x.shape[3]
    if h != out_h:
        if h == 1:
            x = x.expand(-1, -1, out_h, -1)
        else:
            x = torch.matmul(_matrix(h, out_h, x.device, x.dtype), x)
    if w != out_w:
        if w == 1:
            x = x.expand(-1, -1, -1, out_w)
        else:
            x = torch.matmul(x, _matrix(w, out_w, x.device, x.dtype).t())
    return x


def upsample2x(x):
    """2x bilinear upsample of NCHW `x` (align_corners=True)."""
    return resize_bilinear(x, 2 * x.shape[2], 2 * x.shape[3])
