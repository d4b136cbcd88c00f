"""The output-shift 3x3 conv ("variant C" of the conv kernel lab): CUDA
kernel wrapper and its plain version.

Counterpart of scripts/conv_kernel_lab.py `build_call_c`. The kernel is
csrc/conv_shift.cu (see its header for the design and what bounds it).
`conv_shift` launches it for CUDA tensors and takes the plain PyTorch
version `conv_shift_plain` only for CPU tensors; on a CUDA tensor it
launches the kernel or raises.

Operands: `x` (N, Cin, H, W) float32 or bfloat16, UNPADDED (the TPU
variant takes it padded for its tile copies); `w2` (9 * Cin, Cout) in x's
dtype with rows ordered [dx][dy][ci] (`weights_c` of the lab); `b`
(Cout,) float32. Output (N, Cout, H, W): the 3x3 stride-1 'SAME' conv +
bias + activation, accumulated in float32.
"""

from __future__ import annotations

import ctypes

import torch

from vocal_remover_tpu_torch import build
from vocal_remover_tpu_torch.nn.conv_chw_kernel import (
    ACTS,
    activate,
    check_cuda,
    check_operands,
)

# kernel launches made by `conv_shift` in this process (plain-version
# calls are not counted)
launches = 0


def check_3x3(x, w2, b, act, out_dtype):
    """Operands of a 3x3 stride-1 conv with w2 (9 * Cin, Cout); -> Cout."""
    cout = check_operands(x, w2, b, act, out_dtype)
    if w2.shape[0] != 9 * x.shape[1]:
        raise ValueError(f"w2 has {w2.shape[0]} rows, expected 9 * Cin = "
                         f"{9 * x.shape[1]}")
    return cout


def conv_shift_plain(x, w2, b, *, act, out_dtype):
    """The kernel's arithmetic in plain PyTorch: ONE stack of the three
    dy rows of the zero-padded input, three products (one per dx, K = 3 *
    Cin) on the unshifted full-width stack, and the dx alignment on the
    output side as three shifted slice-adds of the partial sums; float32
    throughout (bf16 operands are widened first), bias, activation,
    cast. The kernel multiplies on the tensor cores: bf16 products are
    exact in float32 there too, so only the order of the sum differs;
    float32 operands go as three TF32 products (3xTF32), which drops
    about 2^-21 of each product."""
    check_3x3(x, w2, b, act, out_dtype)
    n, c, h, w = x.shape
    xp = torch.nn.functional.pad(x.float(), (1, 1, 1, 1))
    stack = torch.cat([xp[:, :, dy:dy + h, :] for dy in range(3)], dim=1)
    wf = w2.float()
    acc = None
    for dx in range(3):
        part = torch.einsum("nkhw,ko->nohw", stack,
                            wf[dx * 3 * c:(dx + 1) * 3 * c])[..., dx:dx + w]
        acc = part if acc is None else acc + part
    return activate(acc + b.reshape(1, -1, 1, 1), act).to(out_dtype)


def conv_shift(x, w2, b, *, act, out_dtype):
    """x (N, Cin, H, W), w2 (9 * Cin, Cout) rows [dx][dy][ci], b (Cout,)
    f32 -> (N, Cout, H, W) in `out_dtype`.

    CUDA tensors: the hand-written kernel, on the current stream. CPU
    tensors: `conv_shift_plain`."""
    global launches
    cout = check_3x3(x, w2, b, act, out_dtype)
    if x.device.type == "cpu":
        return conv_shift_plain(x, w2, b, act=act, out_dtype=out_dtype)
    check_cuda("conv_shift", x, w2, b)
    n, c, h, w = x.shape
    out = torch.empty(n, cout, h, w, device=x.device, dtype=out_dtype)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.conv_shift(
            x.data_ptr(), w2.data_ptr(), b.data_ptr(), out.data_ptr(),
            n, c, h, w, cout, ACTS[act], int(x.dtype == torch.bfloat16),
            int(out_dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"conv_shift launch failed: CUDA error {err}")
    launches += 1
    return out


def _lib() -> ctypes.CDLL:
    lib = build.load("conv_shift")
    if lib.conv_shift.argtypes is None:
        lib.conv_shift.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        lib.conv_shift.restype = ctypes.c_int
    return lib
