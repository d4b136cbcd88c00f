"""The tap-dot 3x3 conv ("variant D" of the conv kernel lab): CUDA kernel
wrapper and its plain version.

Counterpart of scripts/conv_kernel_lab.py `build_call_d`. The kernel is
csrc/conv_tapdot.cu (see its header for the design and what bounds it):
one input tile a block staged channel-innermost in shared memory, and nine
accumulating K = Cin tensor-core products, each reading the tile at its
tap's (dy, dx) offset.
`conv_tapdot` launches it for CUDA tensors and takes the plain PyTorch
version `conv_tapdot_plain` only for CPU tensors; on a CUDA tensor it
launches the kernel or raises.

Operands: `x` (N, Cin, H, W) float32 or bfloat16, UNPADDED (the TPU
variant takes it padded for its tile copies); `w2` (9 * Cin, Cout) in x's
dtype with rows ordered [(dy, dx)][ci] (`weights_d` of the lab); `b`
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
)
from vocal_remover_tpu_torch.nn.conv_shift_kernel import check_3x3

# kernel launches made by `conv_tapdot` in this process (plain-version
# calls are not counted)
launches = 0


def conv_tapdot_plain(x, w2, b, *, act, out_dtype):
    """The kernel's arithmetic in plain PyTorch: nine accumulating K =
    Cin products, each on an offset slice of the zero-padded input, no
    stacked copy; float32 throughout (bf16 operands are widened first),
    bias, activation, cast. The kernel multiplies on the tensor cores:
    bf16 products are exact in float32 there too, so only the order of
    the sum differs; float32 operands go as three TF32 products
    (3xTF32), which drops about 2^-21 of each product."""
    check_3x3(x, w2, b, act, out_dtype)
    n, c, h, w = x.shape
    xp = torch.nn.functional.pad(x.float(), (1, 1, 1, 1))
    wf = w2.float()
    acc = None
    for t in range(9):
        dy, dx = divmod(t, 3)
        part = torch.einsum("nkhw,ko->nohw", xp[:, :, dy:dy + h, dx:dx + w],
                            wf[t * c:(t + 1) * c])
        acc = part if acc is None else acc + part
    return activate(acc + b.reshape(1, -1, 1, 1), act).to(out_dtype)


def conv_tapdot(x, w2, b, *, act, out_dtype):
    """x (N, Cin, H, W), w2 (9 * Cin, Cout) rows [(dy, dx)][ci], b (Cout,)
    f32 -> (N, Cout, H, W) in `out_dtype`.

    CUDA tensors: the hand-written kernel, on the current stream. CPU
    tensors: `conv_tapdot_plain`."""
    global launches
    cout = check_3x3(x, w2, b, act, out_dtype)
    if x.device.type == "cpu":
        return conv_tapdot_plain(x, w2, b, act=act, out_dtype=out_dtype)
    check_cuda("conv_tapdot", x, w2, b)
    n, c, h, w = x.shape
    out = torch.empty(n, cout, h, w, device=x.device, dtype=out_dtype)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.conv_tapdot(
            x.data_ptr(), w2.data_ptr(), b.data_ptr(), out.data_ptr(),
            n, c, h, w, cout, ACTS[act], int(x.dtype == torch.bfloat16),
            int(out_dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"conv_tapdot launch failed: CUDA error {err}")
    launches += 1
    return out


def _lib() -> ctypes.CDLL:
    lib = build.load("conv_tapdot")
    if lib.conv_tapdot.argtypes is None:
        lib.conv_tapdot.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        lib.conv_tapdot.restype = ctypes.c_int
    return lib
