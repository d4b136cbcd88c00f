"""Stateless NN primitives (NCHW).

Counterpart of vocal_remover_tpu/nn/functional.py: the conv, the int8
serving conv, eval and train-mode batch norm, channel dropout and the
activations.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

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


class _SyncBatchNorm(torch.autograd.Function):
    """Train batch norm on the global batch of a data `group`, `n` rows a
    channel: every rank holds an equal share of it (mesh.local_rows). The
    statistics are accumulated in float64 (two passes: the mean, then the
    squared deviations from it) and all-reduced, so they do not depend on
    how the batch is cut; y = x * scale + shift as in `batch_norm_train`'s
    bf16 formula. The backward all-reduces the two per-channel sums of
    the input gradient (each rank back-propagates its own loss, so the
    input gradient is that of the sum of the ranks' losses); the weight
    and bias gradients stay local, summed with the others' when the
    trainer averages gradients over the data axis. Returns (y, mean,
    biased variance), the last two float64 and not differentiable."""

    @staticmethod
    def forward(ctx, x, weight, bias, group, n):
        dims = [d for d in range(x.dim()) if d != 1]
        shape = [1] * x.dim()
        shape[1] = -1
        s = x.sum(dims, dtype=torch.float64)
        dist.all_reduce(s, group=group)
        mean = s / n
        v = (x.to(torch.float64) - mean.reshape(shape)).square_().sum(dims)
        dist.all_reduce(v, group=group)
        var = v / n
        st = torch.promote_types(x.dtype, torch.float32)  # stats dtype
        mean_s, invstd = mean.to(st), torch.rsqrt(var + BN_EPS).to(st)
        scale = invstd * weight
        shift = bias - mean_s * scale
        y = (x * scale.to(x.dtype).reshape(shape)
             + shift.to(x.dtype).reshape(shape))
        ctx.save_for_backward(x, weight, mean_s, invstd)
        ctx.group, ctx.n = group, n
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, weight, mean_s, invstd = ctx.saved_tensors
        dims = [d for d in range(x.dim()) if d != 1]
        shape = [1] * x.dim()
        shape[1] = -1
        st = mean_s.dtype
        xhat = (x.to(st) - mean_s.reshape(shape)) * invstd.reshape(shape)
        g = gy.to(st)
        sums = torch.stack([g.sum(dims), (g * xhat).sum(dims)])
        gbias, gweight = sums.clone()
        dist.all_reduce(sums, group=ctx.group)
        n = ctx.n
        gx = (weight * invstd / n).reshape(shape) * (
            n * g - sums[0].reshape(shape) - xhat * sums[1].reshape(shape))
        return gx.to(x.dtype), gweight, gbias, None, None


def batch_norm_train(x, weight, bias, running_mean, running_var, group=None):
    """Train batch norm over dim 1 of NCHW or (rows, C) `x`
    (vocal_remover_tpu/nn/functional.py:108-157): normalizes with the
    batch mean and biased variance, and updates `running_mean` /
    `running_var` in place with momentum BN_MOMENTUM and the unbiased
    variance.

    A bf16 `x` takes JAX's formula: mean and variance in float32 (a bf16
    variance loses about three digits to cancellation), `scale =
    rsqrt(var + eps) * weight` and `shift = bias - mean * scale` in
    float32, then `x * scale + shift` in bf16, so a bf16 chain stays
    bf16; the running buffers stay float32.

    With a data `group` (a mesh's data axis, parallel/policy.py) the
    statistics are those of the global batch, the batch of every rank of
    the group, as JAX computes them on a mesh (SyncBatchNorm's
    semantics, `_SyncBatchNorm`), and the running variance takes the
    global count."""
    if group is not None:
        n = x.numel() // x.shape[1] * dist.get_world_size(group)
        y, mean, var = _SyncBatchNorm.apply(x, weight, bias, group, n)
        with torch.no_grad():
            _update_running(running_mean, running_var,
                            mean.to(running_mean.dtype),
                            var.to(running_var.dtype), n)
        return y
    if x.dtype != torch.bfloat16:
        return torch.nn.functional.batch_norm(
            x, running_mean, running_var, weight, bias, training=True,
            momentum=BN_MOMENTUM, eps=BN_EPS)
    dims = [d for d in range(x.dim()) if d != 1]
    var, mean = torch.var_mean(x.float(), dim=dims, correction=0)
    n = x.numel() // x.shape[1]
    with torch.no_grad():
        _update_running(running_mean, running_var, mean, var, n)
    scale = torch.rsqrt(var + BN_EPS) * weight
    shift = bias - mean * scale
    shape = [1] * x.dim()
    shape[1] = -1
    return (x * scale.to(x.dtype).reshape(shape)
            + shift.to(x.dtype).reshape(shape))


def _update_running(running_mean, running_var, mean, var, n: int):
    running_mean.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * mean)
    running_var.mul_(1 - BN_MOMENTUM).add_(
        BN_MOMENTUM * (var * (n / max(n - 1, 1))))


def dropout2d(x, rate: float, generator: torch.Generator | None,
              shard: tuple[int, int] | None = None):
    """Channel dropout (torch nn.Dropout2d, JAX `dropout2d`): zeroes
    whole channels of NCHW `x` with probability `rate` and scales the
    kept ones by 1 / (1 - rate). The mask is drawn from `generator`
    (on x's device), so the same generator state gives the same mask;
    no generator (or rate 0) is the identity. `shard` = (rank, ranks)
    of a mesh's data axis: `x` is that rank's rows of the global batch,
    so the global batch's mask is drawn and its rows kept."""
    if rate == 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    r, n = shard or (0, 1)
    u = torch.rand((x.shape[0] * n, x.shape[1], 1, 1), generator=generator,
                   device=x.device)[r * x.shape[0]:(r + 1) * x.shape[0]]
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


def relu(x):
    return torch.relu(x)


def leaky_relu(x, negative_slope: float = 0.01):
    return torch.where(x >= 0, x, negative_slope * x)


ACTIVATIONS = {"relu": relu, "leaky_relu": leaky_relu}
