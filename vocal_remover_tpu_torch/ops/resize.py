"""Bilinear resampling with PyTorch `align_corners=True` semantics.

Counterpart of vocal_remover_tpu/ops/resize.py. In eval each axis is
resized by a row-stochastic two-taps-per-row interpolation matrix as a
dense matrix product (frequency first, then time), and a 1 -> n resize
(ASPP's frequency-pooled branch) is a broadcast. Training's exact 2x
upsample (`upsample2x(x, lerp=True)`, the Decoders in train mode) is the
JAX package's phase-split lerp: out[2k] = a[k] x[k-1] + (1 - a[k]) x[k],
out[2k+1] = b[k] x[k] + (1 - b[k]) x[k+1] (edges clamped), with
a[k] = k / (2h-1), b[k] = (h+k) / (2h-1). Both forms are the same grid;
the gradient flows through both.
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
    # a normal tensor even when first asked for in inference mode (a
    # separation): an inference tensor cannot be saved for a backward
    with torch.inference_mode(False):
        return torch.from_numpy(interp_matrix(n_in, n_out)).to(device, dtype)


@functools.lru_cache(maxsize=128)
def _up2x_weights(h: int):
    """float32 phase weights (a, b) of the exact-2x grid, computed in
    float64 then cast (vocal_remover_tpu/ops/resize.py:95-104)."""
    k = np.arange(h, dtype=np.float64)
    d = 2.0 * h - 1.0
    return (k / d).astype(np.float32), ((h + k) / d).astype(np.float32)


@functools.lru_cache(maxsize=128)
def _up2x_tensors(h: int, device: torch.device):
    a, b = _up2x_weights(h)
    with torch.inference_mode(False):  # as _cached_matrix
        return torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)


def _up2x_axis(x, dim: int):
    """Exact 2x align_corners upsample along `dim` as the phase-split lerp
    (JAX `_up2x_axis`): products in float32 or wider (the float32
    weights promote a bf16 `x`), the result in x's dtype."""
    h = x.shape[dim]
    a, b = _up2x_tensors(h, x.device)
    shape = [1] * x.dim()
    shape[dim] = h
    a, b = a.reshape(shape), b.reshape(shape)
    ct = torch.promote_types(x.dtype, torch.float32)
    # weights 1 - a, 1 - b in float32, as JAX computes them
    wa, wb, w1a, w1b = (w.to(ct) for w in (a, b, 1.0 - a, 1.0 - b))
    xc = x.to(ct)
    x_prev = torch.cat([xc.narrow(dim, 0, 1), xc.narrow(dim, 0, h - 1)], dim)
    x_next = torch.cat([xc.narrow(dim, 1, h - 1), xc.narrow(dim, h - 1, 1)],
                       dim)
    even = wa * x_prev + w1a * xc
    odd = wb * xc + w1b * x_next
    y = torch.stack([even, odd], dim=dim + 1).to(x.dtype)
    out_shape = list(x.shape)
    out_shape[dim] = 2 * h
    return y.reshape(out_shape)


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


def upsample2x(x, lerp: bool = False):
    """2x bilinear upsample of NCHW `x` (align_corners=True): the interp
    matrices, or with `lerp` the phase-split lerp (training)."""
    if lerp:
        return _up2x_axis(_up2x_axis(x, 2), 3)
    return resize_bilinear(x, 2 * x.shape[2], 2 * x.shape[3])
