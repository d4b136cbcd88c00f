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

The dynamic `a_scale` stays on the device (no host sync). The kernel
reads the weights prepacked as (Cout, kh * kw * Cp), Cin zero-padded to
Cp, a multiple of `CHANNEL_PAD` (`pack_weights`, done once when a model
is quantized: nn/layers.py `QConv2d`).
"""

from __future__ import annotations

import ctypes

import torch

from vocal_remover_tpu_torch import build

# kernel launches made by `conv2d_int8` in this process (plain-version
# calls are not counted); one a conv, whatever the kernel's passes
launches = 0

# Cin is zero-padded to a multiple of this (one 16-byte copy a pixel
# chunk in the kernel); must equal kChannelPad in csrc/conv_int8.cu
CHANNEL_PAD = 16

_OUT_DTYPES = (torch.float32, torch.bfloat16)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def padded_channels(cin: int) -> int:
    return -(-cin // CHANNEL_PAD) * CHANNEL_PAD


def pack_weights(q: torch.Tensor) -> torch.Tensor:
    """int8 OIHW -> the kernel's (Cout, kh * kw * Cp) int8 layout, tap
    major, the channels of each tap zero-padded to Cp."""
    cout, cin, kh, kw = q.shape
    packed = q.new_zeros((cout, kh, kw, padded_channels(cin)))
    packed[..., :cin] = q.permute(0, 2, 3, 1)
    return packed.reshape(cout, -1)


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
    `packed`. CPU tensors: `conv2d_int8_plain`."""
    global launches
    stride, padding, dilation = _pair(stride), _pair(padding), _pair(dilation)
    ho, wo = _check(x, q, scale, a_scale, stride, padding, dilation,
                    out_dtype)
    n, cin, h, w = x.shape
    cout, _, kh, kw = q.shape
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
    if not (x.is_contiguous() and packed.is_contiguous()
            and scale.is_contiguous()):
        raise ValueError("the int8 conv kernel takes contiguous tensors")
    out = torch.empty(n, cout, ho, wo, device=x.device, dtype=out_dtype)
    xq = torch.empty(n * h * w * cp, device=x.device, dtype=torch.int8)
    amax = torch.empty(1, device=x.device, dtype=torch.int32)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.conv_int8(
            x.data_ptr(), int(x.dtype == torch.bfloat16), packed.data_ptr(),
            scale.data_ptr(), None if a_scale is None else a_scale.data_ptr(),
            xq.data_ptr(), amax.data_ptr(), out.data_ptr(),
            int(out_dtype == torch.bfloat16),
            n, cin, h, w, cp, cout, ho, wo, kh, kw, *stride, *padding,
            *dilation, stream)
    if err != 0:
        raise RuntimeError(f"conv_int8 launch failed: CUDA error {err}")
    launches += 1
    return out


def _lib() -> ctypes.CDLL:
    lib = build.load("conv_int8")
    if lib.conv_int8.argtypes is None:
        lib.conv_int8.argtypes = (
            [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
            + [ctypes.c_int] * 17 + [ctypes.c_void_p])
        lib.conv_int8.restype = ctypes.c_int
        if lib.conv_int8_channel_pad() != CHANNEL_PAD:
            raise RuntimeError("conv_int8.cu and conv_int8_kernel.py "
                               "disagree on the channel padding")
    return lib
