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

int8 serving (`quantize_int8`, `calibrate_act_scales`) is ROADMAP.md A13.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from vocal_remover_tpu_torch.models.base_net import (
    FLAT_LAYERS,
    BaseNet,
    FlatLayer,
)
from vocal_remover_tpu_torch.nn import conv_pack as cp
from vocal_remover_tpu_torch.nn.functional import BN_EPS
from vocal_remover_tpu_torch.nn.layers import (
    BatchNorm,
    Conv2DBNActiv,
    LSTMModule,
)

__all__ = ["fold_batch_norms", "cast_weights", "pack_flat_encoders",
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


def _torch_dtype(dtype):
    if dtype in ("bfloat16", torch.bfloat16):
        return torch.bfloat16
    if dtype in ("float32", torch.float32):
        return torch.float32
    raise ValueError(f"unsupported serving weight dtype {dtype!r}")


def serving_variables(model: nn.Module, dtype=None, flat: bool = False):
    """fold_batch_norms + optional transforms in one call (the serving
    paths' standard transform); returns the transformed copy, in eval
    mode. dtype: None keeps float32 weights, 'bfloat16' /
    torch.bfloat16 casts them. flat=True additionally attaches the
    packed enc2 / enc3 weights (pack_flat_encoders)."""
    if isinstance(dtype, str) and dtype == "int8":
        raise ValueError("int8 serving is not ported yet: it comes with "
                         "ROADMAP.md A13 (quantize_int8, conv2d_int8)")
    out = _fold_(copy.deepcopy(model))
    if flat:
        _pack_(out)
    if dtype is not None:
        _cast_(out, _torch_dtype(dtype))
    return out.eval()
