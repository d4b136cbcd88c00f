"""Stateless NN primitives (NCHW).

Counterpart of vocal_remover_tpu/nn/functional.py: the conv, the int8
serving conv, eval and train-mode batch norm, channel dropout and the
activations.
"""

from __future__ import annotations

import torch

from vocal_remover_tpu_torch.nn import config, conv_int8_kernel

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def conv2d_int8(x, q, scale, a_scale=None, stride=1, padding=1, dilation=1,
                *, packed):
    """Quantized serving conv: int8 x int8 -> int32, dequantized to the
    compute dtype (vocal_remover_tpu/nn/functional.py `conv2d_int8`).

    `q` int8 OIHW and `scale` float32 (Cout,) come from
    models/serving.quantize_int8 (per-output-channel symmetric weight
    scales, BatchNorm pre-folded); `packed` is q in the kernel's layout
    (nn/conv_int8_kernel.pack_weights, kept by nn/layers.QConv2d). The
    activation is quantized with the
    static 0-d `a_scale` (serving.calibrate_act_scales) or, when it is
    None, with a dynamic amax(|x|) / 127 of this call, kept on the
    device. The conv runs as nn/conv_int8_kernel.conv2d_int8: the CUDA
    kernel on the card, its plain version on the CPU. Eval only."""
    return conv_int8_kernel.conv2d_int8(
        x.contiguous(), q, scale, a_scale, packed=packed, stride=stride,
        padding=padding, dilation=dilation,
        out_dtype=config.get_compute_dtype())


def conv2d(x, w, stride=1, padding=1, dilation=1):
    """Bias-free NCHW conv with an OIHW kernel; `padding` and `dilation`
    are ints or (h, w) pairs (ASPP's anisotropic (freq, time) pairs).

    Input and weight are cast to the compute dtype (nn/config.py): in
    bf16 mode activations stay bf16 and cuDNN accumulates in f32.

    While a calibration recorder is active (nn/config.calibration), the
    input's amax(|x|) is recorded under id(w), as a 0-d tensor on x's
    device (no host sync)."""
    rec = config.get_calibration_recorder()
    if rec is not None:
        amax = x.detach().float().abs().amax()
        rec[id(w)] = amax if id(w) not in rec else torch.maximum(rec[id(w)],
                                                                  amax)
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


def batch_norm_train(x, weight, bias, running_mean, running_var):
    """Train batch norm over dim 1 of NCHW or (rows, C) `x`
    (vocal_remover_tpu/nn/functional.py:108-157): normalizes with the
    batch mean and biased variance, and updates `running_mean` /
    `running_var` in place with momentum BN_MOMENTUM and the unbiased
    variance.

    A bf16 `x` takes JAX's formula: mean and variance in float32 (a bf16
    variance loses about three digits to cancellation), `scale =
    rsqrt(var + eps) * weight` and `shift = bias - mean * scale` in
    float32, then `x * scale + shift` in bf16, so a bf16 chain stays
    bf16; the running buffers stay float32."""
    if x.dtype != torch.bfloat16:
        return torch.nn.functional.batch_norm(
            x, running_mean, running_var, weight, bias, training=True,
            momentum=BN_MOMENTUM, eps=BN_EPS)
    dims = [d for d in range(x.dim()) if d != 1]
    var, mean = torch.var_mean(x.float(), dim=dims, correction=0)
    n = x.numel() // x.shape[1]
    with torch.no_grad():
        running_mean.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * mean)
        running_var.mul_(1 - BN_MOMENTUM).add_(
            BN_MOMENTUM * (var * (n / max(n - 1, 1))))
    scale = torch.rsqrt(var + BN_EPS) * weight
    shift = bias - mean * scale
    shape = [1] * x.dim()
    shape[1] = -1
    return (x * scale.to(x.dtype).reshape(shape)
            + shift.to(x.dtype).reshape(shape))


def dropout2d(x, rate: float, generator: torch.Generator | None):
    """Channel dropout (torch nn.Dropout2d, JAX `dropout2d`): zeroes
    whole channels of NCHW `x` with probability `rate` and scales the
    kept ones by 1 / (1 - rate). The mask is drawn from `generator`
    (on x's device), so the same generator state gives the same mask;
    no generator (or rate 0) is the identity."""
    if rate == 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    u = torch.rand((x.shape[0], x.shape[1], 1, 1), generator=generator,
                   device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


def relu(x):
    return torch.relu(x)


def leaky_relu(x, negative_slope: float = 0.01):
    return torch.where(x >= 0, x, negative_slope * x)


ACTIVATIONS = {"relu": relu, "leaky_relu": leaky_relu}
