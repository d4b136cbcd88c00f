"""The int8 serving conv: CUDA kernel wrapper and its plain version.

Counterpart of vocal_remover_tpu/nn/functional.py `conv2d_int8`, which
the JAX package leaves to XLA (`lax.conv_general_dilated` of int8
operands with `preferred_element_type=int32`). PyTorch has no int8 x
int8 -> int32 convolution on CUDA (`conv2d` of int8 tensors returns int8,
which wraps), so the port has a kernel of its own: csrc/conv_int8.cu (see
its header for the design and what bounds it). It replaces no TPU kernel.
`conv2d_int8` launches it for CUDA tensors and takes the plain PyTorch
version `conv2d_int8_plain` only for CPU tensors; on a CUDA tensor it
launches the kernel or raises.

What both compute, as JAX's `conv2d_int8` does, on NCHW `x` (float32 or
bf16) and the int8 OIHW kernel `q` with its float32 per-output-channel
scales:

    xf      = float32(x)
    a_scale = the static 0-d `a_scale`, or max(amax(|xf|) / 127, 1e-30)
    xq      = int8(clip(round_half_even(xf / a_scale), -127, 127))
    acc     = int32 conv(xq, q)
    y       = float32(acc) * (a_scale * scale[co])     (product first)
    out     = y cast to `out_dtype` (round to nearest even)

The kernel reads x itself: it quantizes each tile of x on its way into
shared memory, so no int8 copy of x is written. A static scale is one
launch; a dynamic one is two (the amax's partial maxima, which the
conv's blocks fold, then the conv), and stays on the device (no host
sync). The kernel reads the weights prepacked as (Cout, Cp/32, kh * kw,
32), Cin zero-padded to Cp, a multiple of `CHANNEL_PAD` (`pack_weights`,
done once when a model is quantized: nn/layers.py `QConv2d`). How a conv
is cut into tiles is `tile_plan`'s choice, made once per geometry and
cached.
"""

from __future__ import annotations

import ctypes

import torch

from vocal_remover_tpu_torch import build

# kernel launches made by `conv2d_int8` in this process (plain-version
# calls are not counted); one a conv, whatever the kernel's passes
launches = 0

# Cin is zero-padded to a multiple of this (the kernel's K chunk, one
# k32 int8 mma); must equal kChannelPad in csrc/conv_int8.cu
CHANNEL_PAD = 32
# the kernel's tile configurations (MI, NI, WN) (CONV_INT8_CONFIGS of
# csrc/conv_int8.cu, in its order): a block of 8 warps computes BM =
# 16*MI*(8/WN) output pixels x BN = 8*NI*WN output channels
TILE_CONFIGS = ((2, 8, 2), (2, 6, 2), (2, 4, 2), (2, 3, 2), (2, 4, 1),
                (2, 2, 1), (2, 1, 1), (1, 4, 4), (1, 2, 4), (1, 4, 1),
                (1, 2, 1), (4, 4, 2))
SM_COUNT = 132           # H100 SXM
THREADS = 256            # a block
SMEM_LIMIT = 232448      # shared memory a block can have (227 KB)
SMEM_PER_SM = 233472     # an SM's (228 KB, 1 KB of it reserved a block)
KC = 32                  # input channels a K chunk
MAX_CPS = 8              # K chunks a step, at most
AMAX_BLOCKS = 4 * SM_COUNT
# the kernel's launch plan, csrc/conv_int8.cu `struct Plan`, in order
PLAN_FIELDS = (
    "n", "cin", "h", "w", "cp", "cout", "ho", "wo",
    "kh", "kw", "sh", "sw", "ph", "pw", "dh", "dw",
    "x_bf16", "out_bf16", "cfg", "gather", "th", "tw", "tw_log2",
    "tiles_h", "tiles_w", "n_blocks", "halo_h", "halo_w",
    "a_rows", "a_cols", "raw_g", "cps", "smem", "amax_blocks")

_OUT_DTYPES = (torch.float32, torch.bfloat16)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def padded_channels(cin: int) -> int:
    return -(-cin // CHANNEL_PAD) * CHANNEL_PAD


def pack_weights(q: torch.Tensor) -> torch.Tensor:
    """int8 OIHW -> the kernel's (Cout, kh * kw * Cp) int8 layout: per
    output channel the Cp / CHANNEL_PAD chunks of input channels, each
    holding every tap's CHANNEL_PAD channels (Cin zero-padded to Cp), so
    that a K chunk's weights of one output channel are contiguous."""
    cout, cin, kh, kw = q.shape
    cp = padded_channels(cin)
    padded = q.new_zeros((cout, cp, kh, kw))
    padded[:, :cin] = q
    return (padded.reshape(cout, cp // CHANNEL_PAD, CHANNEL_PAD, kh * kw)
            .permute(0, 1, 3, 2).reshape(cout, -1).contiguous())


class Plan(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int) for name in PLAN_FIELDS]


def _pow2_at_least(v: int) -> int:
    return 1 << max(v - 1, 0).bit_length()


def config_tile(cfg: int):
    """(BM, BN) of a tile configuration."""
    mi, ni, wn = TILE_CONFIGS[cfg]
    return 16 * mi * (8 // wn), 8 * ni * wn


def plan_smem(p: dict) -> int:
    """Shared memory of a plan (csrc/conv_int8.cu `plan_smem`)."""
    bm, bn = config_tile(p["cfg"])
    nt = 1 if p["gather"] else p["kh"] * p["kw"]
    kstep = p["cps"] * KC
    b = 2 * bn * (nt * kstep + 16)
    a_px = bm if p["gather"] else p["a_rows"] * p["a_cols"]
    raw = 0 if p["gather"] else kstep * p["a_rows"] * p["raw_g"] * 16
    return max(b + (a_px + 1) * (kstep + 16) + raw, bn * (bm + 4) * 4)


def _tiled(p: dict, cfg: int, gather: bool, cps: int = 1) -> dict:
    """p with the tile of `cfg`, the route, the K step (`cps` chunks of
    KC channels) and the halo tile's sizes."""
    bm, bn = config_tile(cfg)
    ho, wo = p["ho"], p["wo"]
    tw = min(_pow2_at_least(wo), max(16, bm // _pow2_at_least(ho)), bm)
    th = bm // tw
    halo_h = (th - 1) * p["sh"] + (p["kh"] - 1) * p["dh"] + 1
    halo_w = (tw - 1) * p["sw"] + (p["kw"] - 1) * p["dw"] + 1
    cols = min(halo_w, p["w"])
    raw_g = -(-cols * (2 if p["x_bf16"] else 4) // 16) + 1
    q = dict(p, cfg=cfg, gather=int(gather), th=th, tw=tw,
             tw_log2=tw.bit_length() - 1, tiles_h=-(-ho // th),
             tiles_w=-(-wo // tw), n_blocks=-(-p["cout"] // bn),
             halo_h=halo_h, halo_w=halo_w, a_rows=min(halo_h, p["h"]),
             a_cols=cols + (cols & 1) if p["sw"] == 2 else cols,
             raw_g=raw_g, cps=cps)
    q["smem"] = plan_smem(q)
    return q


def plan_cost(q: dict) -> float:
    """The planner's estimate of a plan's time, in units of one quantized
    element: waves of blocks (as many an SM as registers and shared
    memory allow: csrc/conv_int8.cu `min_blocks`) times a block's work,
    which is the elements of its halo tile it quantizes, its int8
    products (680 MACs a unit), the weight bytes it copies (2 a unit) and
    a fixed cost a K step; the weights were fitted to H100 timings of
    every tile plan of the flagship's convs."""
    bm, bn = config_tile(q["cfg"])
    taps = q["kh"] * q["kw"]
    blocks = q["n"] * q["tiles_h"] * q["tiles_w"] * q["n_blocks"]
    mi, ni, _ = TILE_CONFIGS[q["cfg"]]
    per_sm = min(2 if mi * ni >= 12 else 3, SMEM_PER_SM // (q["smem"] + 1024))
    waves = -(-blocks // (SM_COUNT * per_sm))
    nc = q["cp"] // KC
    if q["gather"]:
        px, steps = bm * taps, nc * taps
    else:
        px, steps = q["a_rows"] * q["a_cols"], -(-nc // q["cps"])
    work = (px * q["cp"] + bm * bn * taps * q["cp"] / 680
            + bn * taps * q["cp"] / 2 + 8000 * steps)
    return waves * work


def tile_plan(x_shape, cout, kernel, stride, padding, dilation,
              x_bf16=True, out_bf16=True) -> dict:
    """The kernel's launch plan for a conv (PLAN_FIELDS). The block width
    BN is the narrowest configuration that takes Cout in the fewest
    blocks of at most 128 channels. Among the halo-route plans of that
    width that fit shared memory (every block height, 1 to MAX_CPS
    chunks a K step) the one of least `plan_cost`, then least shared
    memory. Narrower widths follow where none fits; the gather route (a
    tap a K step) is left for geometries where none does."""
    n, cin, h, w = x_shape
    kh, kw = kernel
    (sh, sw), (ph, pw), (dh, dw) = _pair(stride), _pair(padding), \
        _pair(dilation)
    ho, wo = out_size(x_shape, (cout, cin, kh, kw), (sh, sw), (ph, pw),
                      (dh, dw))
    numel = n * cin * h * w
    esz = 2 if x_bf16 else 4
    p = dict(n=n, cin=cin, h=h, w=w, cp=padded_channels(cin), cout=cout,
             ho=ho, wo=wo, kh=kh, kw=kw, sh=sh, sw=sw, ph=ph, pw=pw, dh=dh,
             dw=dw, x_bf16=int(x_bf16), out_bf16=int(out_bf16),
             amax_blocks=max(1, min(AMAX_BLOCKS,
                                    -(-numel * esz // (256 * 16 * 4)))))
    per_block = -(-cout // -(-cout // 128))
    widths = sorted({config_tile(c)[1] for c in range(len(TILE_CONFIGS))})
    width = min(b for b in widths if b >= per_block)
    nc = p["cp"] // KC
    cps_choices = [c for c in (1, 2, 4, 8) if c <= min(nc, MAX_CPS)]
    for b in sorted((b for b in widths if b <= width), reverse=True):
        fitting = [q for q in (_tiled(p, c, False, cps)
                               for c in range(len(TILE_CONFIGS))
                               if config_tile(c)[1] == b
                               for cps in cps_choices)
                   if q["smem"] <= SMEM_LIMIT and q["raw_g"] <= THREADS]
        if fitting:
            return min(fitting, key=lambda q: (plan_cost(q), q["smem"]))
    return _tiled(p, max((c for c in range(len(TILE_CONFIGS))
                          if config_tile(c)[1] == width),
                         key=lambda c: config_tile(c)[0]), True)


def out_size(x_shape, q_shape, stride, padding, dilation):
    """(Ho, Wo) of the conv."""
    (_, _, h, w), (_, _, kh, kw) = x_shape, q_shape
    return tuple((size + 2 * p - d * (k - 1) - 1) // s + 1
                 for size, k, s, p, d in zip((h, w), (kh, kw), stride,
                                             padding, dilation))


def _check(x, q, scale, a_scale, stride, padding, dilation, out_dtype):
    if x.dim() != 4 or q.dim() != 4:
        raise ValueError(f"expected NCHW x and OIHW q, got {tuple(x.shape)} "
                         f"and {tuple(q.shape)}")
    if x.dtype not in _OUT_DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if q.dtype != torch.int8:
        raise TypeError(f"q must be int8, got {q.dtype}")
    # a module cast with .to(bfloat16) casts these float buffers too
    if scale.dtype != torch.float32 or (a_scale is not None
                                        and a_scale.dtype != torch.float32):
        raise TypeError(f"scale and a_scale must be float32, got "
                        f"{scale.dtype} and "
                        f"{None if a_scale is None else a_scale.dtype}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"output dtype {out_dtype} is not float32/bfloat16")
    if q.shape[1] != x.shape[1] or scale.shape != (q.shape[0],):
        raise ValueError(f"x {tuple(x.shape)}, q {tuple(q.shape)} and scale "
                         f"{tuple(scale.shape)} do not fit")
    if a_scale is not None and a_scale.numel() != 1:
        raise ValueError(f"a_scale must hold one value, got "
                         f"{tuple(a_scale.shape)}")
    devices = {x.device, q.device, scale.device} | (
        set() if a_scale is None else {a_scale.device})
    if len(devices) != 1:
        raise ValueError(f"operands on different devices: {devices}")
    if min(stride + dilation) < 1 or min(padding) < 0:
        raise ValueError(f"bad geometry: stride {stride}, padding {padding}, "
                         f"dilation {dilation}")
    ho, wo = out_size(x.shape, q.shape, stride, padding, dilation)
    if ho < 1 or wo < 1:
        raise ValueError(f"empty output for x {tuple(x.shape)}")
    return ho, wo


def quantize_activation(x, a_scale=None):
    """-> (xq as int8 values held in float32, the 0-d a_scale used)."""
    xf = x.float()
    if a_scale is None:
        # divided by a tensor: a Python 127.0 would let PyTorch's CUDA
        # division multiply by its reciprocal, which is not IEEE division
        a_scale = torch.maximum(xf.abs().amax() / xf.new_tensor(127.0),
                                xf.new_tensor(1e-30))
    a_scale = a_scale.reshape(())
    return torch.clamp(torch.round(xf / a_scale), -127, 127), a_scale


def conv2d_int8_sums(x, q, a_scale=None, *, stride=1, padding=1,
                     dilation=1):
    """The int32 sums of the conv and the a_scale used: the quantized
    activation convolved with q in float64, which is exact (every partial
    sum is an integer below 127^2 * kh * kw * Cin < 2^53), with cuDNN off
    on the card (its FFT algorithms are not exact)."""
    xq, a_scale = quantize_activation(x, a_scale)
    with torch.backends.cudnn.flags(enabled=False):
        acc = torch.nn.functional.conv2d(
            xq.double(), q.double(), None, _pair(stride), _pair(padding),
            _pair(dilation))
    return acc.round().to(torch.int32), a_scale


def conv2d_int8_plain(x, q, scale, a_scale=None, *, stride=1, padding=1,
                      dilation=1, out_dtype=torch.float32):
    """The kernel's arithmetic in plain PyTorch (module docstring)."""
    stride, padding, dilation = _pair(stride), _pair(padding), _pair(dilation)
    _check(x, q, scale, a_scale, stride, padding, dilation, out_dtype)
    acc, a_scale = conv2d_int8_sums(x, q, a_scale, stride=stride,
                                    padding=padding, dilation=dilation)
    y = acc.float() * (a_scale * scale).reshape(1, -1, 1, 1)
    return y.to(out_dtype)


def conv2d_int8(x, q, scale, a_scale=None, *, packed, stride=1, padding=1,
                dilation=1, out_dtype=torch.float32):
    """NCHW x (float32 / bf16), int8 OIHW q, its kernel layout `packed`
    (`pack_weights(q)`), float32 (Cout,) scale and an optional 0-d
    float32 a_scale (None: dynamic) -> NCHW conv in `out_dtype`.
    `padding` / `dilation` are ints or (h, w) pairs.

    CUDA tensors: the hand-written kernel on the current stream, reading
    `packed`. CPU tensors: `conv2d_int8_plain`. The checks and the plan
    are made once per geometry, types and devices (`_plans`)."""
    global launches
    stride, padding, dilation = _pair(stride), _pair(padding), _pair(dilation)
    key = (x.shape, x.dtype, x.device, q.shape, q.dtype, q.device,
           scale.shape, scale.dtype, scale.device,
           None if a_scale is None else (a_scale.shape, a_scale.dtype,
                                         a_scale.device),
           packed.shape, packed.dtype, packed.device, stride, padding,
           dilation, out_dtype)
    plan = _plans.get(key)
    if plan is None:
        _check(x, q, scale, a_scale, stride, padding, dilation, out_dtype)
        cout, cin, kh, kw = q.shape
        cp = padded_channels(cin)
        if packed.dtype != torch.int8 or packed.shape != (cout, kh * kw * cp) \
                or packed.device != x.device:
            raise ValueError(f"packed must be pack_weights(q): int8 "
                             f"{(cout, kh * kw * cp)} on {x.device}, got "
                             f"{packed.dtype} {tuple(packed.shape)} on "
                             f"{packed.device}")
        if x.device.type == "cpu":
            return conv2d_int8_plain(x, q, scale, a_scale, stride=stride,
                                     padding=padding, dilation=dilation,
                                     out_dtype=out_dtype)
        if x.device.type != "cuda":
            raise ValueError(f"no int8 conv kernel for device {x.device}")
        p = tile_plan(x.shape, cout, (kh, kw), stride, padding, dilation,
                      x_bf16=x.dtype == torch.bfloat16,
                      out_bf16=out_dtype == torch.bfloat16)
        plan = Plan(**{f: p[f] for f in PLAN_FIELDS})
        if _lib().conv_int8_plan_smem(ctypes.byref(plan)) > plan.smem:
            raise RuntimeError("conv_int8.cu and conv_int8_kernel.py "
                               "disagree on the shared memory of a plan")
        _plans[key] = plan
    if not (x.is_contiguous() and packed.is_contiguous()
            and scale.is_contiguous()):
        raise ValueError("the int8 conv kernel takes contiguous tensors")
    out = torch.empty(plan.n, plan.cout, plan.ho, plan.wo, device=x.device,
                      dtype=out_dtype)
    partial = None if a_scale is not None else torch.empty(
        plan.amax_blocks, device=x.device, dtype=torch.float32)
    err = _lib().conv_int8(
        ctypes.byref(plan), x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
        None if a_scale is None else a_scale.data_ptr(),
        None if partial is None else partial.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream, x.device.index)
    if err != 0:
        raise RuntimeError(f"conv_int8 launch failed: CUDA error {err}")
    launches += 1
    return out


# checked geometry, types and devices of a CUDA call -> its Plan
_plans: dict = {}


def _lib() -> ctypes.CDLL:
    lib = build.load("conv_int8")
    if lib.conv_int8.argtypes is None:
        lib.conv_int8.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int]
        lib.conv_int8.restype = ctypes.c_int
        lib.conv_int8_plan_smem.argtypes = [ctypes.c_void_p]
        lib.conv_int8_plan_smem.restype = ctypes.c_int
        if lib.conv_int8_channel_pad() != CHANNEL_PAD \
                or lib.conv_int8_plan_fields() != len(PLAN_FIELDS):
            raise RuntimeError("conv_int8.cu and conv_int8_kernel.py "
                               "disagree on the channel padding or the plan")
    return lib
