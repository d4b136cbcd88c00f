"""NN layer modules (NCHW).

Counterpart of vocal_remover_tpu/nn/layers.py. Activations are
(N, C, F, T): H = frequency, W = time. Attribute paths follow the
reference's torch modules, so `state_dict()` keys are the reference's
(`conv.0.weight`, `conv.1.running_mean`, `lstm.weight_ih_l0_reverse`,
`dense.0.weight`, ...). Parameters are created empty; `reset_parameters`
fills them with the torch layer defaults from an explicit generator.

Train mode (`module.train()`) is the JAX package's `train=True`: batch
norm on batch statistics with the running update, the Decoders' lerp 2x
upsample, the BiLSTM's recurrence as the differentiable plain loop, and
channel dropout where a module has it, drawn from the `generator` its
forward is given (none: no dropout, as JAX's `rng=None`).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from vocal_remover_tpu_torch.nn import config, conv_int8_kernel
from vocal_remover_tpu_torch.nn import functional as F
from vocal_remover_tpu_torch.nn.lstm import BiLSTM
from vocal_remover_tpu_torch.ops.resize import resize_bilinear, upsample2x

__all__ = ["Conv2d", "QConv2d", "Linear", "BatchNorm", "Conv2DBNActiv",
           "Encoder", "Decoder", "ASPPModule", "LSTMModule",
           "reset_parameters"]


class Conv2d(nn.Module):
    """Bias-free conv weight (O, I, kh, kw) with its geometry. `tp`: this
    rank's output-channel shard under tensor parallelism (the mask heads
    `out` / `aux_out`; parallel/policy.py), None when whole."""

    tp = None

    def __init__(self, nin, nout, ksize, stride=1, pad=0, dilation=1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(nout, nin, ksize, ksize))
        self.stride, self.pad, self.dilation = stride, pad, dilation

    def reset_parameters(self, generator):
        """torch Conv2d default: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
        bound = 1.0 / math.sqrt(self.weight[0].numel())
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.stride, self.pad, self.dilation)


class QConv2d(nn.Module):
    """An int8-quantized conv (models/serving.quantize_int8), in place of
    a Conv2DBNActiv's `Conv2d` (JAX's {"q", "scale"[, "a_scale"]} kernel
    leaf). Buffers, not parameters: `q` int8 (O, I, kh, kw), `scale`
    float32 (O,), and `a_scale`, a 0-d float32 static activation scale or
    None (dynamic, per call); `packed`, the kernel's layout of q
    (nn/conv_int8_kernel.pack_weights), is made here and not saved."""

    def __init__(self, q, scale, a_scale=None, stride=1, pad=0, dilation=1):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)
        self.register_buffer("a_scale", a_scale)
        self.register_buffer("packed", conv_int8_kernel.pack_weights(q),
                             persistent=False)
        self.stride, self.pad, self.dilation = stride, pad, dilation

    def _load_from_state_dict(self, *args, **kwargs):
        super()._load_from_state_dict(*args, **kwargs)
        self.packed = conv_int8_kernel.pack_weights(self.q)

    def forward(self, x):
        return F.conv2d_int8(x, self.q, self.scale, self.a_scale, self.stride,
                             self.pad, self.dilation, packed=self.packed)


class Linear(nn.Module):
    def __init__(self, nin, nout):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(nout, nin))
        self.bias = nn.Parameter(torch.empty(nout))

    def reset_parameters(self, generator):
        """torch Linear default: U(-1/sqrt(in), 1/sqrt(in)) for both."""
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x):
        """Full float32 (or float64) in every precision mode (the JAX
        package pins this product to HIGHEST); bf16-resident weights are
        cast up."""
        x = config.at_least_float32(x)
        with config.full_float32():
            return torch.nn.functional.linear(x, self.weight.to(x.dtype),
                                              self.bias.to(x.dtype))


class BatchNorm(nn.Module):
    """Batch norm over `axis` (1 for NCHW, -1 for (rows, C)): running
    statistics in eval; in train mode batch statistics, and the running
    buffers and `num_batches_tracked` updated. `group`: a mesh's data
    axis (parallel/policy.py), whose global batch the train-mode
    statistics are taken over; None on one device."""

    group = None

    def __init__(self, nout, axis=1):
        super().__init__()
        self.axis = axis
        self.weight = nn.Parameter(torch.empty(nout))
        self.bias = nn.Parameter(torch.empty(nout))
        self.register_buffer("running_mean", torch.empty(nout))
        self.register_buffer("running_var", torch.empty(nout))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))

    def reset_parameters(self, generator):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x):
        if self.training:
            with torch.no_grad():
                self.num_batches_tracked += 1
            return F.batch_norm_train(x, self.weight, self.bias,
                                      self.running_mean, self.running_var,
                                      self.group)
        return F.batch_norm(x, self.weight, self.bias, self.running_mean,
                            self.running_var, self.axis)


def reset_parameters(module: nn.Module, generator: torch.Generator):
    """Initialise every parameter holder under `module`, in module order."""
    for m in module.modules():
        if m is not module and hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)


def _crop_time(skip, x):
    """Centre-crop `skip` along time (dim 3) to x's width."""
    t1, t2 = skip.shape[3], x.shape[3]
    if t1 == t2:
        return skip
    if t1 < t2:
        raise ValueError("skip time width must be >= x time width")
    s = (t1 - t2) // 2
    return skip[:, :, :, s:s + t2]


class Conv2DBNActiv(nn.Module):
    """Conv2d(bias=False) -> BatchNorm2d -> activation. `tp`: this rank's
    output-channel shard under tensor parallelism (parallel/policy.py):
    the conv, batch norm and activation run on this rank's channels,
    which are then all-gathered; None when whole."""

    tp = None

    def __init__(self, nin, nout, ksize=3, stride=1, pad=1, dilation=1,
                 activ="relu"):
        super().__init__()
        self.conv = nn.Sequential(
            Conv2d(nin, nout, ksize, stride, pad, dilation), BatchNorm(nout)
        )
        self.activ = F.ACTIVATIONS[activ]

    def forward(self, x):
        if self.tp is None:
            return self.activ(self.conv(x))
        return self.tp.gather(self.activ(self.conv(self.tp.enter(x))))


class Encoder(nn.Module):
    """Two Conv2DBNActiv blocks, the first strided (LeakyReLU default)."""

    def __init__(self, nin, nout, ksize=3, stride=1, pad=1,
                 activ="leaky_relu"):
        super().__init__()
        self.conv1 = Conv2DBNActiv(nin, nout, ksize, stride, pad, activ=activ)
        self.conv2 = Conv2DBNActiv(nout, nout, ksize, 1, pad, activ=activ)

    def forward(self, x):
        return self.conv2(self.conv1(x))


class Decoder(nn.Module):
    """Bilinear 2x upsample -> optional skip concat -> conv -> optional
    channel dropout (train mode only; `data_shard`, a mesh's (data rank,
    data ranks), keeps this rank's rows of the global batch's mask)."""

    data_shard = None

    def __init__(self, nin, nout, ksize=3, stride=1, pad=1, activ="relu",
                 dropout=False):
        super().__init__()
        self.conv1 = Conv2DBNActiv(nin, nout, ksize, 1, pad, activ=activ)
        self.dropout = dropout

    def forward(self, x, skip=None, generator=None):
        x = upsample2x(x, lerp=self.training)
        if skip is not None:
            x = torch.cat([x, _crop_time(skip, x)], dim=1)
        h = self.conv1(x)
        if self.dropout and self.training:
            h = F.dropout2d(h, 0.1, generator, self.data_shard)
        return h


class ASPPModule(nn.Module):
    """Atrous spatial pyramid pooling over (freq, time) with a
    freq-pooled branch; dilations are (freq, time) anisotropic pairs.
    `data_shard` as Decoder's."""

    data_shard = None

    def __init__(self, nin, nout, dilations=((4, 2), (8, 4), (12, 6)),
                 activ="relu", dropout=False):
        super().__init__()
        # reference: conv1 = Sequential(AdaptiveAvgPool2d((1, None)), conv)
        self.conv1 = nn.Sequential(
            nn.Identity(), Conv2DBNActiv(nin, nout, 1, 1, 0, activ=activ)
        )
        self.conv2 = Conv2DBNActiv(nin, nout, 1, 1, 0, activ=activ)
        self.conv3 = Conv2DBNActiv(nin, nout, 3, 1, dilations[0],
                                   dilations[0], activ=activ)
        self.conv4 = Conv2DBNActiv(nin, nout, 3, 1, dilations[1],
                                   dilations[1], activ=activ)
        self.conv5 = Conv2DBNActiv(nin, nout, 3, 1, dilations[2],
                                   dilations[2], activ=activ)
        self.bottleneck = Conv2DBNActiv(nout * 5, nout, 1, 1, 0, activ=activ)
        self.dropout = dropout

    def forward(self, x, generator=None):
        h, w = x.shape[2], x.shape[3]
        pooled = x.mean(dim=2, keepdim=True)
        feat1 = resize_bilinear(self.conv1[1](pooled), h, w)
        out = torch.cat([feat1, self.conv2(x), self.conv3(x), self.conv4(x),
                         self.conv5(x)], dim=1)
        out = self.bottleneck(out)
        if self.dropout and self.training:
            out = F.dropout2d(out, 0.1, generator, self.data_shard)
        return out


class LSTMModule(nn.Module):
    """1x1 conv squeeze to one channel -> per-frame BiLSTM over frequency
    vectors -> Dense + BatchNorm1d + ReLU, back to (N, 1, F, T). The
    BiLSTM and the dense head run in float32; in bf16 mode the branch's
    output is cast back to the activation dtype, so the concat in
    BaseNet does not promote the decoder to float32."""

    def __init__(self, nin_conv, nin_lstm, nout_lstm):
        super().__init__()
        self.conv = Conv2DBNActiv(nin_conv, 1, 1, 1, 0)
        self.lstm = BiLSTM(nin_lstm, nout_lstm // 2)
        self.dense = nn.Sequential(Linear(nout_lstm, nin_lstm),
                                   BatchNorm(nin_lstm, axis=-1))
        self.nin_lstm, self.nout_lstm = nin_lstm, nout_lstm

    def forward(self, x):
        n, _, nbins, nframes = x.shape
        h = self.conv(x)[:, 0].permute(2, 0, 1)  # (T, N, F)
        h = self.lstm(h)  # (T, N, nout_lstm)
        h = F.relu(self.dense(h.reshape(-1, self.nout_lstm)))
        h = h.reshape(nframes, n, self.nin_lstm)
        h = h.permute(1, 2, 0).unsqueeze(1)  # (N, 1, F, T)
        return h.to(x.dtype) if x.dtype == torch.bfloat16 else h
