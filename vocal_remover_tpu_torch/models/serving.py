"""Serving-time weight transforms: eval BatchNorm folding, bf16-resident
weights, and pixel-packed encoder weights for the flat-conv kernel.

Counterpart of vocal_remover_tpu/models/serving.py. The JAX package
transforms a variables tree; here the weights live in the `nn.Module`,
so every transform returns a transformed COPY of the module (the
original is not changed) whose eval forward gives the same masks within
float tolerance. The copy carries `serving_transformed = True`: it is
for inference only, and the trainer (train/step.py) refuses it.
`models/convert.to_jax_variables` reads a transformed module back as the
JAX package's transformed tree.

  * `fold_batch_norms`   - eval BN is an affine map per channel; it is
    folded into the conv kernel (and the LSTM head's dense weights) in
    float64, and the BatchNorm that stays carries only the shift.
  * `cast_weights`       - conv / dense / LSTM weights resident in bf16;
    BatchNorm vectors and the flat-kernel bias stay float32. Pairs with
    `nn.config.set_precision('bfloat16')`.
  * `pack_flat_encoders` - attaches the packed `wst` / `bias` operands
    of enc2 / enc3 (nn/conv_pack.build_flat_layer) to every BaseNet, as
    buffers under `flat_enc`; BaseNet.forward then takes the flat
    branch in eval mode.
  * `quantize_int8`      - per-output-channel symmetric int8 conv
    kernels for the U-Net conv stack: each Conv2DBNActiv's Conv2d
    becomes a `QConv2d` (nn/layers.py) that runs the int8 conv
    (nn/conv_int8_kernel.py); activations are quantized per call, or
    with static scales from `calibrate_act_scales`. The BiLSTM branch
    and the mask heads stay float.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn

from vocal_remover_tpu_torch.models.base_net import (
    FLAT_LAYERS,
    BaseNet,
    FlatLayer,
)
from vocal_remover_tpu_torch.models.convert import module_path
from vocal_remover_tpu_torch.nn import config
from vocal_remover_tpu_torch.nn import conv_pack as cp
from vocal_remover_tpu_torch.nn.functional import BN_EPS
from vocal_remover_tpu_torch.nn.layers import (
    BatchNorm,
    Conv2d,
    Conv2DBNActiv,
    LSTMModule,
    QConv2d,
)

__all__ = ["fold_batch_norms", "cast_weights", "quantize_int8",
           "calibrate_act_scales", "act_scale_paths", "pack_flat_encoders",
           "serving_variables"]


def _affine(bn: BatchNorm):
    """Eval BN as (scale, shift) in float64."""
    s = bn.weight.double() / torch.sqrt(bn.running_var.double() + BN_EPS)
    return s, bn.bias.double() - bn.running_mean.double() * s


def _set_identity(bn: BatchNorm, shift):
    """Statistics that make eval batch_norm compute y = x + shift: scale
    1, mean 0, and var such that rsqrt(var + eps) == 1."""
    bn.weight.fill_(1.0)
    bn.bias.copy_(shift)
    bn.running_mean.zero_()
    bn.running_var.fill_(1.0 - BN_EPS)


@torch.no_grad()
def _fold_(model: nn.Module):
    for m in model.modules():
        if isinstance(m, Conv2DBNActiv):
            conv, bn = m.conv[0], m.conv[1]
            s, shift = _affine(bn)
            conv.weight.copy_(conv.weight.double() * s[:, None, None, None])
            _set_identity(bn, shift)
        elif isinstance(m, LSTMModule):
            dense, bn = m.dense[0], m.dense[1]
            s, shift = _affine(bn)
            dense.weight.copy_(dense.weight.double() * s[:, None])
            dense.bias.copy_(dense.bias.double() * s + shift)
            _set_identity(bn, torch.zeros_like(shift))
    model.serving_transformed = True
    return model


@torch.no_grad()
def _cast_(model: nn.Module, dtype):
    for m in model.modules():
        if isinstance(m, BatchNorm):
            continue  # numerically sensitive; applied in the activation dtype
        for p in m.parameters(recurse=False):
            p.data = p.data.to(dtype)
        if isinstance(m, FlatLayer):
            m.set_wst(m.wst.to(dtype))  # the bias adds in float32
    model.serving_transformed = True
    return model


@torch.no_grad()
def _pack_(model: nn.Module):
    for net in model.modules():
        if not isinstance(net, BaseNet):
            continue
        p1 = net._flat_p1()
        if p1 < 4:  # enc3 needs p1 // 4 >= 1
            continue
        packed = nn.ModuleDict()
        for name, div, stride in FLAT_LAYERS:
            # enc1 stays a plain conv: the flat chain enters at e1
            block = getattr(getattr(net, name[:4]), name[5:])
            conv, bn = block.conv[0], block.conv[1]
            hwio = conv.weight.detach().float().cpu().numpy().transpose(
                2, 3, 1, 0)
            lay = cp.build_flat_layer(
                hwio, bn.bias.detach().float().cpu().numpy(), p1 // div,
                stride, act="leaky_relu")
            dev = conv.weight.device
            packed[name] = FlatLayer(torch.from_numpy(lay["wst"]).to(dev),
                                     torch.from_numpy(lay["bias"]).to(dev),
                                     lay["s_list"])
        net.flat_enc = packed
    model.serving_transformed = True
    return model


def _quantize_conv(conv: Conv2d, a_scale):
    """Conv2d -> QConv2d, in numpy with the JAX package's operations on
    the HWIO kernel, so q and scale are bit for bit JAX's."""
    w = conv.weight.detach().float().cpu().numpy().transpose(2, 3, 1, 0)
    scale = np.max(np.abs(w), axis=(0, 1, 2))  # per out channel
    scale = np.maximum(scale, 1e-30) / 127.0
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    dev = conv.weight.device
    return QConv2d(
        torch.from_numpy(np.ascontiguousarray(q.transpose(3, 2, 0, 1))).to(dev),
        torch.from_numpy(scale.astype(np.float32)).to(dev),
        None if a_scale is None else torch.tensor(
            np.float32(a_scale), dtype=torch.float32, device=dev),
        conv.stride, conv.pad, conv.dilation)


@torch.no_grad()
def _quantize_(model: nn.Module, act_scales=None):
    n_attached = 0
    for name, m in model.named_modules():
        # the mask heads `out` / `aux_out` are plain Conv2d modules
        if not isinstance(m, Conv2DBNActiv) or "lstm_dec2" in name.split("."):
            continue
        key = f"{name}.conv.0"
        a_scale = None if act_scales is None else act_scales.get(key)
        n_attached += a_scale is not None
        m.conv[0] = _quantize_conv(m.conv[0], a_scale)
    if act_scales and n_attached == 0:
        raise ValueError(
            "quantize_int8: activation scales were supplied but none "
            "matched the model - calibrate against a model with the same "
            "structure (module names are the keys)")
    model.serving_transformed = True
    return model


def fold_batch_norms(model: nn.Module) -> nn.Module:
    """A copy of `model` with every eval-mode BatchNorm folded into the
    preceding conv / dense weights. Eval forwards match the unfolded
    model to float-association noise. Only valid for inference."""
    return _fold_(copy.deepcopy(model))


def cast_weights(model: nn.Module, dtype=torch.bfloat16) -> nn.Module:
    """A copy of `model` with conv / dense / LSTM weights (and packed
    `wst`) cast to `dtype`; BatchNorm vectors and the flat-kernel bias
    stay float32."""
    return _cast_(copy.deepcopy(model), _torch_dtype(dtype))


def pack_flat_encoders(model: nn.Module) -> nn.Module:
    """A copy of a BN-FOLDED `model` with pixel-packed enc2 / enc3
    weights attached to every BaseNet whose pack p1 = max(1, 128 //
    enc1.nout) is at least 4 (the bias is read from the identity BN's
    shift). enc4 / enc5 keep the plain path: their stride-2 packing
    transition is not block-uniform (cout != 2 * cin)."""
    return _pack_(copy.deepcopy(model))


def quantize_int8(model: nn.Module, act_scales=None) -> nn.Module:
    """A copy of a BN-FOLDED `model` whose Conv2DBNActiv convs are
    per-output-channel symmetric int8 (`QConv2d`: q = clip(round(w /
    scale), -127, 127), scale = max(|w|) / 127 over all but the output
    axis, floored at 1e-30). Kept float, as in the JAX package: everything
    under `lstm_dec2` (its 1x1 squeeze feeds a one-channel recurrence)
    and the `out` / `aux_out` mask heads. The identity BN carrying the
    folded shift stays float32 and adds after dequantization.

    act_scales: {conv module name (`<...>.conv.0`): float32 scale} from
    `calibrate_act_scales` - a static `a_scale` per conv; scales supplied
    of which none matches raise a ValueError."""
    return _quantize_(copy.deepcopy(model), act_scales)


@torch.no_grad()
def calibrate_act_scales(model: nn.Module, batches, margin=1.0):
    """Record each float conv's input amax over eval forwards of
    `batches` (NCHW tensors, moved to the model's device) and return
    {conv module name: np.float32 scale} for quantize_int8's static
    activation quantization: max(amax * margin, 1e-30) / 127, formed in
    float64 as the JAX package forms it. The amax stays on the device
    during the forwards; `act_scale_paths` gives the JAX tree paths."""
    names = {id(m.weight): name for name, m in model.named_modules()
             if isinstance(m, Conv2d)}
    device = next(model.parameters()).device
    was_training = model.training
    model.eval()
    rec: dict = {}
    try:
        with config.calibration(rec):
            for x in batches:
                model(torch.as_tensor(x).to(device))
    finally:
        model.train(was_training)
    return {names[k]: np.float32(max(float(v) * margin, 1e-30) / 127.0)
            for k, v in rec.items() if k in names}


def act_scale_paths(scales):
    """calibrate_act_scales' keys as the JAX package's tree paths (the
    keys of its calibrate_act_scales), through models/convert's key map."""
    return {module_path(name): v for name, v in scales.items()}


def _torch_dtype(dtype):
    if dtype in ("bfloat16", torch.bfloat16):
        return torch.bfloat16
    if dtype in ("float32", torch.float32):
        return torch.float32
    raise ValueError(f"unsupported serving weight dtype {dtype!r}")


def serving_variables(model: nn.Module, dtype=None, flat: bool = False,
                      calibration_batches=None):
    """fold_batch_norms + optional transforms in one call (the serving
    paths' standard transform); returns the transformed copy, in eval
    mode. dtype: None keeps float32 weights, 'bfloat16' /
    torch.bfloat16 casts them, 'int8' quantizes the conv stack
    (quantize_int8) and casts the remaining float weights to bf16; with
    `calibration_batches` (NCHW magnitude batches) the int8 convs get
    static activation scales (calibrate_act_scales), else they quantize
    dynamically per call. flat=True additionally attaches the packed
    enc2 / enc3 weights (pack_flat_encoders); it and int8 exclude each
    other."""
    int8 = isinstance(dtype, str) and dtype == "int8"
    if flat and int8:
        raise ValueError("flat packing and int8 are exclusive serving "
                         "transforms")
    out = _fold_(copy.deepcopy(model))
    if flat:
        _pack_(out)
    if int8:
        act_scales = None
        if calibration_batches is not None:
            act_scales = calibrate_act_scales(out, calibration_batches)
        _quantize_(out, act_scales)
        _cast_(out, torch.bfloat16)
    elif dtype is not None:
        _cast_(out, _torch_dtype(dtype))
    return out.eval()
