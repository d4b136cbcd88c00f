"""Stateless NN primitives (NCHW), eval mode.

Counterpart of vocal_remover_tpu/nn/functional.py. Train-mode batch
norm and dropout come with the training slice.
"""

from __future__ import annotations

import torch

from vocal_remover_tpu_torch.nn import config

BN_EPS = 1e-5


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def conv2d(x, w, stride=1, padding=1, dilation=1):
    """Bias-free NCHW conv with an OIHW kernel; `padding` and `dilation`
    are ints or (h, w) pairs (ASPP's anisotropic (freq, time) pairs).

    Input and weight are cast to the compute dtype (nn/config.py): in
    bf16 mode activations stay bf16 and cuDNN accumulates in f32."""
    dt = config.get_compute_dtype()
    if x.dtype != dt:
        x = x.to(dt)
    if w.dtype != dt:
        w = w.to(dt)
    return torch.nn.functional.conv2d(x, w, None, _pair(stride),
                                      _pair(padding), _pair(dilation))


def batch_norm(x, weight, bias, mean, var, axis: int = 1):
    """Eval batch norm with running statistics, folded into one
    multiply-add (vocal_remover_tpu/nn/functional.py:148-154): scale
    and shift are computed in float32 and applied in the activation's
    dtype, so a bf16 chain stays bf16."""
    scale = torch.rsqrt(var + BN_EPS) * weight
    shift = bias - mean * scale
    shape = [1] * x.dim()
    shape[axis] = -1
    return (x * scale.to(x.dtype).reshape(shape)
            + shift.to(x.dtype).reshape(shape))


def relu(x):
    return torch.relu(x)


def leaky_relu(x, negative_slope: float = 0.01):
    return torch.where(x >= 0, x, negative_slope * x)


ACTIVATIONS = {"relu": relu, "leaky_relu": leaky_relu}
