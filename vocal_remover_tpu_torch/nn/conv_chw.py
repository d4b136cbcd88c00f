"""Fused convolution in channel-major (N, C, H, W) layout: host side.

Counterpart of vocal_remover_tpu/nn/conv_pallas.py: the same public
functions with the same layouts. `fused_conv_chw` computes
act(w2^T . im2col(x) + b) with K = taps x cin_blk over a static tap table
`(channel_block, dy, dx)`; the product itself is the hand-written kernel
behind `conv_chw_kernel.conv_call` (csrc/conv_chw.cu: tensor-core products
over the taps, cut into groups that each read one staged input box; the
im2col matrix is never built). A table of any length runs, as in the JAX
package.

  * stride 1: `prepare_weights_s1` (any kh x kw) gives the taps of one
    channel block and `pad = (kh - 1, kw - 1)`. As in the JAX package, a
    pad of (2, 2) is split one row / column on each side (3x3 'SAME');
    any other pad lies on the top / left only.
  * stride 2: `space_to_depth` moves the four pixel phases into channel
    blocks, `prepare_weights_s2` remaps a 3x3 kernel to 2x2-window taps
    over them, pad (1, 1) top / left.

What the TPU version refuses or copies and this one does not: any H and W
are taken (no lane-width rule, no row alignment), and no padded copy of x
is made: the kernel reads the unpadded tensor and takes out-of-range taps
as zero. Weights are prepared on the host in numpy. Eval / serving only:
no gradient.
"""

from __future__ import annotations

import numpy as np
import torch

from vocal_remover_tpu_torch.nn import conv_chw_kernel
from vocal_remover_tpu_torch.nn import functional as F

__all__ = ["fused_conv_chw", "prepare_folded_conv", "prepare_weights_s1",
           "prepare_weights_s2", "space_to_depth"]


def _numpy(w):
    if isinstance(w, torch.Tensor):
        return w.detach().float().cpu().numpy()
    return np.asarray(w)


def prepare_weights_s1(w):
    """HWIO (kh, kw, Cin, Cout) kernel -> ((kh*kw*Cin, Cout) im2col
    matrix, tap table, pad). Rows ordered [(dy, dx) taps x Cin]; taps are
    (channel_block, dy, dx) with one channel block covering the input."""
    w = _numpy(w)
    kh, kw, cin, cout = w.shape
    taps = tuple((0, dy, dx) for dy in range(kh) for dx in range(kw))
    return w.reshape(kh * kw * cin, cout), taps, (kh - 1, kw - 1)


def prepare_weights_s2(w):
    """HWIO (3, 3, Cin, Cout) stride-2 kernel -> im2col matrix over the
    space-to-depth input (4 phase blocks of Cin channels, ordered
    [(0,0), (0,1), (1,0), (1,1)]), 2x2-window taps, pad (1, 1).

    out(i, j) needs input rows u in {2i-1, 2i, 2i+1}; with u = 2a + p and
    a shifted by the one-row top pad, dy = 0, 1, 2 become (phase p,
    offset) = (1, 0), (0, 1), (1, 1); columns alike."""
    w = _numpy(w)
    kh, kw, cin, cout = w.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"the stride-2 remap is for 3x3 kernels, got "
                         f"{kh}x{kw}")
    po = ((1, 0), (0, 1), (1, 1))
    taps, rows = [], []
    for dy in range(3):
        for dx in range(3):
            (pr, offr), (pc, offc) = po[dy], po[dx]
            taps.append((pr * 2 + pc, offr, offc))
            rows.append(w[dy, dx])  # (Cin, Cout)
    return np.concatenate(rows, axis=0), tuple(taps), (1, 1)


def space_to_depth(x):
    """(N, C, H, W) -> (N, 4*C, H//2, W//2), phase blocks ordered
    [(0,0), (0,1), (1,0), (1,1)] to match prepare_weights_s2."""
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // 2, 2, w // 2, 2)
    x = x.permute(0, 3, 5, 1, 2, 4)  # (N, 2, 2, C, H/2, W/2)
    return x.reshape(n, 4 * c, h // 2, w // 2)


def prepare_folded_conv(block):
    """-> (w2, b, taps, pad, act) of a BN-folded `Conv2DBNActiv`
    (models/serving.fold_batch_norms: the BatchNorm is the identity and
    its bias holds the folded shift). 3x3 stride 1 / 2 with pad 1, or 1x1;
    a stride-2 block's input goes through `space_to_depth` first."""
    conv, bn = block.conv[0], block.conv[1]
    k = conv.weight.shape[2]
    if conv.dilation != 1 or (k, conv.stride, conv.pad) not in (
            (3, 1, 1), (3, 2, 1), (1, 1, 0)):
        raise ValueError(f"no channel-major form for a {k}x{k} conv with "
                         f"stride {conv.stride}, pad {conv.pad}, dilation "
                         f"{conv.dilation}")
    prepare = prepare_weights_s2 if conv.stride == 2 else prepare_weights_s1
    w2, taps, pad = prepare(conv.weight.detach().permute(2, 3, 1, 0))
    act = next(n for n, f in F.ACTIVATIONS.items() if f is block.activ)
    return w2, _numpy(bn.bias), taps, pad, act


def pad_origin(pad_hw):
    """Rows / columns of the zero padding that lie above / left of the
    image: (1, 1) of a (2, 2) pad, else all of it."""
    ph, pw = pad_hw
    return (1, 1) if (ph, pw) == (2, 2) else (ph, pw)


def fused_conv_chw(x, w2, b, taps, pad_hw, *, act="relu", out_dtype=None):
    """Fused conv + bias + activation in (N, C, H, W) layout.

    Args:
      x: (N, C, H, W) tensor, float32 or bfloat16, NOT padded.
      w2: (len(taps) * cin_blk, Cout) im2col weights from
        prepare_weights_* (array or tensor; cast to x's dtype).
      b: (Cout,) bias (the folded BatchNorm shift); added in float32.
      taps: static tap table ((channel_block, dy, dx), ...).
      pad_hw: total tap reach beyond the output grid: (2, 2) for the
        stride-1 3x3 'same' form (split 1+1), (1, 1) for the
        space-to-depth stride-2 form (top/left only).
      act: 'relu' | 'leaky_relu' | None.
      out_dtype: float32 or bfloat16; default x's.
    Returns (N, Cout, H, W) in `out_dtype`.
    """
    w2 = torch.as_tensor(w2).to(device=x.device, dtype=x.dtype).contiguous()
    b = torch.as_tensor(b).to(device=x.device,
                              dtype=torch.float32).reshape(-1).contiguous()
    return conv_chw_kernel.conv_call(
        x.contiguous(), w2, b, tuple(tuple(t) for t in taps),
        tuple(pad_hw), pad_origin(pad_hw), act, out_dtype or x.dtype)
