"""Pixel-packed flat-layout convs for the serving path.

Counterpart of vocal_remover_tpu/nn/conv_pack.py, with the same public
functions and layouts. A feature map lives as `(N, M, L)`: each flat row
packs P consecutive time-axis pixels, lane = (pixel_in_block, channel),
M = H * WB, WB = W / P. That is a pure reshape of contiguous NHWC. A
3x3 'SAME' conv (stride 1 or 2) or a 1x1 becomes, per kernel row tap,
one product of the flat rows with a packed weight matrix whose column
blocks are the block shifts s in {-1, 0, +1}; the shifted blocks are
added on the output with the `m % WB` masks that are the zero padding
along time. `build_flat_layer` compiles the HWIO kernel to those
matrices on the host (numpy, the JAX package's arithmetic exactly);
`flat_layer_apply` runs one layer flat to flat through
nn/flat_conv_kernel.py (the CUDA kernel for CUDA tensors, its plain
version for CPU tensors); `flat_conv` is the NHWC-in / NHWC-out wrapper.

`flat_conv_supported` answers as the JAX predicate does, so that both
packages take the flat path for the same convs. Of its conditions only
the geometric ones bind the CUDA kernel: the lane rules (`p_out * cout
>= 128`, `wb % 8 == 0`) and the padding of `l_in` to a multiple of 128
in the JAX `flat_layer_apply` are the TPU's (8, 128) tiling; the CUDA
kernel masks ragged widths itself and takes any `wb`, `l_in` and
`p_out * cout`.
"""

from __future__ import annotations

import numpy as np
import torch

from vocal_remover_tpu_torch.nn import flat_conv_kernel

__all__ = ["flat_conv", "flat_conv_supported", "build_flat_layer",
           "flat_layer_apply", "flat_geometry", "to_flat", "from_flat"]


# ---------------------------------------------------------------------------
# host-side layer compiler: HWIO kernel -> flat tap matrices (numpy)
# ---------------------------------------------------------------------------

def flat_geometry(kh, stride):
    """Static tap geometry for a 'SAME' conv: (rowtaps, s_list).
    Deterministic from (kh, stride) alone, so the apply side can
    reconstruct it without touching the packed weight arrays."""
    if stride == 1:
        rowtaps = tuple((None, dy) for dy in range(kh))
        s_list = (0,) if kh == 1 else (-1, 0, 1)
    else:
        rowtaps = ((1, 0), (0, 1), (1, 1))
        s_list = (-1, 0)
    return rowtaps, s_list


def build_flat_layer(w, bias, p_out, stride=1, act="leaky_relu"):
    """Compile one Conv2DBNActiv to flat-kernel operands (host numpy).

    Args:
      w: HWIO (kh, kw, cin, cout) kernel, 'SAME' geometry (3x3 or 1x1
        stride 1; 3x3 stride 2).
      bias: (cout,) folded-BN shift (or None).
      p_out: output pixels per block. Input packing is implied:
        p_in = p_out * stride.
    Returns a dict with static geometry and the stacked tap matrices:
      {"wst": (n_rowtaps, p_in*cin, |s_list|*p_out*cout) f32,
       "bias": (p_out*cout,) f32, "rowtaps": ((plane, off), ...)
       (plane None for stride 1), "s_list", "p_in", "p_out", "stride",
       "act", "cin", "cout"}.
    """
    w = np.asarray(w, np.float32)
    kh, kw, cin, cout = w.shape
    p_in = p_out * stride
    if stride == 1:
        pad = (kh - 1) // 2
        rowtaps = tuple((None, dy) for dy in range(kh))

        def src(dy, dx, p):
            q = p + dx - pad
            return dy, q // p_in, q % p_in
    else:
        assert stride == 2 and (kh, kw) == (3, 3)
        # x row 2a+dy-1 with a top pad of 2 image rows (x'[r] = x[r-2]):
        # even plane e[r] = x[2r-2], odd plane o[r] = x[2r-1] ->
        # dy=0: o[a] (plane 1, off 0); dy=1: e[a+1]; dy=2: o[a+1]
        rowtaps = ((1, 0), (0, 1), (1, 1))

        def src(dy, dx, p):
            q = 2 * p + dx - 1
            return dy, q // p_in, q % p_in

    mats = {}
    for dy in range(kh):
        for dx in range(kw):
            for p in range(p_out):
                t, s, p_src = src(dy, dx, p)
                key = (t, s)
                if key not in mats:
                    mats[key] = np.zeros(
                        (p_in * cin, p_out * cout), np.float32
                    )
                mats[key][
                    p_src * cin: (p_src + 1) * cin,
                    p * cout: (p + 1) * cout,
                ] += w[dy, dx]
    _, s_list = flat_geometry(kh, stride)
    assert {s for _, s in mats} <= set(s_list)
    nl = p_out * cout
    wst = np.zeros((kh, p_in * cin, len(s_list) * nl), np.float32)
    for (t, s), mat in mats.items():
        j = s_list.index(s)
        wst[t, :, j * nl: (j + 1) * nl] = mat
    b = np.zeros(cout, np.float32) if bias is None else np.asarray(
        bias, np.float32)
    return {
        "wst": wst, "bias": np.tile(b, p_out), "rowtaps": rowtaps,
        "s_list": s_list, "p_in": p_in, "p_out": p_out,
        "stride": stride, "act": act, "cin": cin, "cout": cout,
    }


# ---------------------------------------------------------------------------
# tensor side
# ---------------------------------------------------------------------------

def flat_layer_apply(layer, xf, h, wb_out, *, out_dtype=None):
    """Apply a build_flat_layer product to a flat tensor.

    xf: (N, H*WB, L_in) with WB == wb_out for both strides (a stride-2
    layer's input has twice the pack, so W_in / p_in == W_out / p_out).
    h: input H (rows). `layer["wst"]` / `layer["bias"]` may be numpy
    arrays or tensors. Returns (N, H_out * wb_out, p_out*cout),
    H_out = h // stride, in `out_dtype` (default: xf's).

    The input goes to the kernel as it is: the zero rows that the JAX
    `flat_layer_apply` pads on (the 'SAME' padding along frequency, and
    the reach of its tile copies) are out-of-range rows that the kernel
    reads as zero.
    """
    st = layer["stride"]
    n, mf, l_in = xf.shape
    if mf != h * wb_out:
        raise ValueError(f"flat input has {mf} rows, expected h * wb = "
                         f"{h} * {wb_out}")
    wst = torch.as_tensor(layer["wst"])
    # the walk is made at the tile of wst's dtype, and this function takes
    # a wst of either dtype and casts it to the input's: the stored walk
    # would then be refused by the wrapper (its header names the other
    # tile), so such a call passes none and the wrapper builds the cast
    # wst's own (a read-back of wst every call; the model's FlatLayers
    # keep wst in the activation dtype and never take this branch)
    blocks = layer.get("blocks") if wst.dtype == xf.dtype else None
    if blocks is not None:
        blocks = torch.as_tensor(blocks).to(xf.device)
    wst = wst.to(device=xf.device, dtype=xf.dtype)
    bias = torch.as_tensor(layer["bias"]).to(device=xf.device,
                                             dtype=torch.float32)
    return flat_conv_kernel.flat_conv_core(
        xf, wst, bias, wb=wb_out, h_out=h // st, rowtaps=layer["rowtaps"],
        s_list=layer["s_list"], act=layer["act"],
        out_dtype=out_dtype or xf.dtype, blocks=blocks)


def to_flat(x, p):
    """(N, H, W, C) -> (N, H*(W/p), p*C): a view of contiguous NHWC."""
    n, h, w, c = x.shape
    return x.reshape(n, h * (w // p), p * c)


def from_flat(xf, h, w, c):
    return xf.reshape(xf.shape[0], h, w, c)


def flat_conv_supported(x_shape, w_shape, stride=1, dilation=1):
    """Static predicate: can the flat kernel run this conv (via the
    NHWC wrapper, p_out = max(1, 128 // (cin*stride)))? Answers as the
    JAX package's predicate; see the module note for which conditions
    are the TPU's."""
    if dilation not in (1, (1, 1)):
        return False
    if stride not in (1, 2, (1, 1), (2, 2)):
        return False
    st = stride if isinstance(stride, int) else stride[0]
    kh, kw, cin, cout = w_shape
    n, h, w, c = x_shape
    if c != cin:
        return False
    if st == 1 and (kh, kw) not in ((3, 3), (1, 1)):
        return False
    if st == 2 and ((kh, kw) != (3, 3) or h % 2 or w % 2):
        return False
    p_out = max(1, 128 // (cin * st))
    p_in = p_out * st
    if w % p_in:
        return False
    if p_out * cout < 128:  # the TPU's output lane rule
        return False
    wb = (w // st) // p_out
    return wb % 8 == 0  # the TPU's sublane rule


def flat_conv(x, w, b=None, *, stride=1, act=None, out_dtype=None):
    """Fused conv + bias + activation, NHWC tensor in / NHWC out; `w` is
    an HWIO kernel and `b` a (cout,) bias, both host arrays (they are
    packed on the host). For chains use build_flat_layer +
    flat_layer_apply on flat tensors directly."""
    st = stride if isinstance(stride, int) else stride[0]
    w = np.asarray(w, np.float32)
    if not flat_conv_supported(tuple(x.shape), w.shape, stride):
        raise ValueError(f"flat_conv does not take x {tuple(x.shape)}, "
                         f"w {w.shape}, stride {stride}")
    n, h, wd, c = x.shape
    cout = w.shape[3]
    p_out = max(1, 128 // (c * st))
    layer = build_flat_layer(w, b, p_out, st, act=act)
    xf = to_flat(x.contiguous(), layer["p_in"])
    out = flat_layer_apply(layer, xf, h, (wd // st) // p_out,
                           out_dtype=out_dtype)
    return from_flat(out, h // st, wd // st, cout)
