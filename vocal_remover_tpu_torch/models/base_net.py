"""Single U-Net with ASPP bottleneck and BiLSTM branch (NCHW).

Counterpart of vocal_remover_tpu/models/base_net.py (reference
lib/nets.py:8-41): encoders at widths nout*{1,2,4,6,8} (stride 2 from
enc2), ASPP bottleneck (channel dropout 0.1 in training), three decoders
with skips, a BiLSTM branch concatenated at the dec2 scale (T = cropsize
/ 2 frames), and a final decoder.

The flat branch (serving): when `models/serving.pack_flat_encoders` has
attached packed weights (`flat_enc`) and the input's geometry passes
`_flat_supported`, the four convs of enc2 and enc3 run as flat
pixel-packed kernels chained flat to flat (nn/conv_pack.py); enc1 stays
a plain conv. Where the NHWC view is made: the port's activations are
NCHW, so e1 is copied once per band net into NHWC (`permute` +
`contiguous`, a no-op for a channels_last e1), of which `to_flat` is a
free view; the four layers never leave the flat layout; e2 and e3 come
back once, as NCHW-shaped views of the flat outputs (channels_last
strides, no copy), which the convs, concats and resizes downstream take
as they are.
"""

from __future__ import annotations

import torch
from torch import nn

from vocal_remover_tpu_torch.nn import conv_pack as cp
from vocal_remover_tpu_torch.nn import flat_conv_kernel
from vocal_remover_tpu_torch.nn.layers import (
    ASPPModule,
    Conv2DBNActiv,
    Decoder,
    Encoder,
    LSTMModule,
)

# the packed layers, in chain order: (name, pack divisor, stride)
FLAT_LAYERS = (("enc2_conv1", 2, 2), ("enc2_conv2", 2, 1),
               ("enc3_conv1", 4, 2), ("enc3_conv2", 4, 1))


class FlatLayer(nn.Module):
    """Packed operands of one flat conv (`build_flat_layer`), as
    buffers: `wst` in the weight dtype, `bias` always float32, and
    `blocks`, the kernel's walk over the non-zero blocks of `wst`
    (`flat_conv_kernel.block_table`; built here, not saved with the
    weights). The walk depends on wst's values and, through the
    kernel's tile, on its dtype, so it is rebuilt whenever they may have
    changed: `set_wst`, a `.to()` / `.half()`-style cast of the module
    (a move to another device carries the table along), and
    `load_state_dict`; `walk()`, which the forward reads, also rebuilds
    it after an in-place edit of wst or a wst put in another way (it
    holds wst's storage and version against those the walk was built
    from; an inference tensor keeps no version, so an in-place edit of
    such a wst in inference mode is not seen). A dtype the kernel takes
    no tile for has no walk (None): the kernel's wrapper refuses such a
    wst."""

    def __init__(self, wst: torch.Tensor, bias: torch.Tensor, s_list):
        super().__init__()
        self.s_list = tuple(s_list)
        self.register_buffer("wst", wst)
        self.register_buffer("bias", bias)
        self.register_buffer("blocks", None, persistent=False)
        self.set_wst(wst)

    def set_wst(self, wst: torch.Tensor):
        """Replace `wst` (a cast, say) and rebuild its walk."""
        self.wst = wst
        self._rebuild_walk()

    def walk(self):
        """`blocks`, rebuilt first if wst is not what it was built from."""
        if flat_conv_kernel.storage_key(self.wst) != self._walk_of:
            self._rebuild_walk()
        return self.blocks

    def _rebuild_walk(self):
        self.blocks = flat_conv_kernel.block_table(self.wst, self.s_list) \
            if self.wst.dtype in flat_conv_kernel.TILES else None
        self._walk_of = flat_conv_kernel.storage_key(self.wst)

    def _apply(self, fn, recurse=True):
        bias, dtype = self.bias, self.wst.dtype
        stale = flat_conv_kernel.storage_key(self.wst) != self._walk_of
        out = super()._apply(fn, recurse)
        if self.bias.dtype != bias.dtype:  # the bias adds in float32
            self.bias = bias.to(self.bias.device)
        if stale or self.wst.dtype != dtype:
            self._rebuild_walk()
        else:  # a move: the table went along with wst
            self._walk_of = flat_conv_kernel.storage_key(self.wst)
        return out

    def _load_from_state_dict(self, *args, **kwargs):
        super()._load_from_state_dict(*args, **kwargs)
        self._rebuild_walk()


class BaseNet(nn.Module):
    def __init__(self, nin, nout, nin_lstm, nout_lstm,
                 dilations=((4, 2), (8, 4), (12, 6))):
        super().__init__()
        self.nout = nout
        self.enc1 = Conv2DBNActiv(nin, nout, 3, 1, 1)
        self.enc2 = Encoder(nout, nout * 2, 3, 2, 1)
        self.enc3 = Encoder(nout * 2, nout * 4, 3, 2, 1)
        self.enc4 = Encoder(nout * 4, nout * 6, 3, 2, 1)
        self.enc5 = Encoder(nout * 6, nout * 8, 3, 2, 1)
        self.aspp = ASPPModule(nout * 8, nout * 8, dilations, dropout=True)
        self.dec4 = Decoder(nout * (6 + 8), nout * 6, 3, 1, 1)
        self.dec3 = Decoder(nout * (4 + 6), nout * 4, 3, 1, 1)
        self.dec2 = Decoder(nout * (2 + 4), nout * 2, 3, 1, 1)
        self.lstm_dec2 = LSTMModule(nout * 2, nin_lstm, nout_lstm)
        self.dec1 = Decoder(nout * (1 + 2) + 1, nout * 1, 3, 1, 1)
        # ModuleDict of FlatLayer once pack_flat_encoders has run
        self.flat_enc = None

    def _flat_p1(self):
        return max(1, 128 // self.nout)

    def _flat_supported(self, x_shape):
        """x_shape is NCHW. Answers as the JAX package's predicate, so
        both take the flat branch for the same nets; `(w // p1) % 8` is
        the TPU's sublane rule, which the CUDA kernel does not need."""
        n, c, h, w = x_shape
        p1 = self._flat_p1()
        return (p1 >= 4 and w % p1 == 0 and (w // p1) % 8 == 0
                and h % 4 == 0)

    def _apply_encoders_flat(self, e1):
        """e1 (N, nout, F, T) -> e2 (N, 2 nout, F/2, T/2), e3 (N, 4 nout,
        F/4, T/4) through the four packed layers."""
        n, c, h, w = e1.shape
        p1 = self._flat_p1()
        wb = w // p1  # invariant across levels (W and P halve together)
        f = cp.to_flat(e1.permute(0, 2, 3, 1).contiguous(), p1)
        rows, outs = h, {}
        for name, div, stride in FLAT_LAYERS:
            rowtaps, s_list = cp.flat_geometry(3, stride)
            arrs = self.flat_enc[name]
            f = cp.flat_layer_apply(
                {"wst": arrs.wst, "bias": arrs.bias, "blocks": arrs.walk(),
                 "rowtaps": rowtaps,
                 "s_list": s_list, "stride": stride, "act": "leaky_relu"},
                f, rows, wb)
            rows //= stride
            outs[name] = f
        e2 = cp.from_flat(outs["enc2_conv2"], h // 2, w // 2, 2 * c)
        e3 = cp.from_flat(outs["enc3_conv2"], h // 4, w // 4, 4 * c)
        return e2.permute(0, 3, 1, 2), e3.permute(0, 3, 1, 2)

    def forward(self, x, generator=None):
        """`generator` draws the ASPP's channel dropout in train mode."""
        e1 = self.enc1(x)
        if self.flat_enc is not None and not self.training \
                and self._flat_supported(x.shape):
            e2, e3 = self._apply_encoders_flat(e1)
        else:
            e2 = self.enc2(e1)
            e3 = self.enc3(e2)
        e4 = self.enc4(e3)
        e5 = self.enc5(e4)
        h = self.aspp(e5, generator)
        h = self.dec4(h, e4)
        h = self.dec3(h, e3)
        h = self.dec2(h, e2)
        h = torch.cat([h, self.lstm_dec2(h)], dim=1)
        return self.dec1(h, e1)
