"""The BiLSTM recurrence: CUDA kernel wrapper and its plain version.

Counterpart of vocal_remover_tpu/nn/lstm_pallas.py `_run_recurrence`.
The kernel is csrc/lstm_recurrence.cu (see its header for the design and
what bounds it). The recurrence is the custom op
`torch.ops.vocal_remover_tpu_torch.lstm_recurrence(xg, w_cols)`
(`torch.library`): its CUDA implementation launches the kernel, its CPU
implementation is the plain PyTorch loop `recurrence_plain`, and any
other device raises. `recurrence` and `recurrence_cols` call the op on
both devices, so `torch.export` records one opaque node (its fake
function gives the output's shape) whatever device it traces on, and a
loaded artifact (separate/artifact.py) reaches the kernel through it:
import this module before `torch.export.load`. The kernel takes the
recurrent weights one row per gate column (`relayout`); nn/lstm.py
stacks them so once per call and calls `recurrence_cols`.

The op has no autograd formula, as the JAX package's Pallas recurrence
has no backward kernel (training runs `recurrence_plain` under
autograd, as JAX trains through its `lax.scan`): a loss that reaches
the op raises in `backward`, on the CPU as on the card, rather than
getting no gradient through the branch.
"""

from __future__ import annotations

import ctypes

import torch

from vocal_remover_tpu_torch import build

# kernel launches made by the op's CUDA implementation in this process
# (plain-version calls are not counted)
launches = 0

def relayout(w_hh: torch.Tensor) -> torch.Tensor:
    """w_hh (2, H, 4H) -> the kernel's w_cols (2, 4H, H), contiguous: one
    row per gate column, so a thread reads its column in one stretch
    (torch's own weight_hh_l0 layout, stacked)."""
    return w_hh.transpose(1, 2).contiguous()


def undo_relayout(w_cols: torch.Tensor) -> torch.Tensor:
    """Inverse of `relayout`."""
    return w_cols.transpose(1, 2).contiguous()


def recurrence_plain(xg: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """xg (T, 2N, 4H), w_hh (2, H, 4H) -> hs (T, 2N, H); zero initial
    state, gate order i, f, g, o, in the inputs' dtype (float32; float64
    in the gradient parity tests). Same arithmetic as the kernel, and
    differentiable: training runs it under autograd (nn/lstm.py)."""
    t_len, two_n, four_h = xg.shape
    n, hidden = two_n // 2, four_h // 4
    h = xg.new_zeros(2, n, hidden)
    c = xg.new_zeros(two_n, hidden)
    out = []
    for t in range(t_len):
        gates = xg[t] + torch.bmm(h, w_hh).reshape(two_n, four_h)
        i, f, g, o = gates.split(hidden, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        ht = torch.sigmoid(o) * torch.tanh(c)
        out.append(ht)
        h = ht.reshape(2, n, hidden)
    return torch.stack(out) if out else xg.new_zeros(0, two_n, hidden)


def _check(xg: torch.Tensor, w: torch.Tensor, cols: bool):
    name = "w_cols (2, 4H, H)" if cols else "w_hh (2, H, 4H)"
    if xg.dim() != 3 or w.dim() != 3:
        raise ValueError(f"expected xg (T, 2N, 4H) and {name}, got "
                         f"{tuple(xg.shape)} and {tuple(w.shape)}")
    t_len, two_n, four_h = xg.shape
    hidden = four_h // 4
    want = (2, four_h, hidden) if cols else (2, hidden, four_h)
    if two_n % 2 or four_h % 4 or tuple(w.shape) != want:
        raise ValueError(f"expected xg (T, 2N, 4H) and {name}, got "
                         f"{tuple(xg.shape)} and {tuple(w.shape)}")
    if xg.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"the recurrence runs in float32, got {xg.dtype} "
                        f"and {w.dtype}")
    if xg.device != w.device:
        raise ValueError(f"xg on {xg.device} but the weights on {w.device}")


def recurrence(xg: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """xg (T, 2N, 4H) f32, w_hh (2, H, 4H) f32 -> hs (T, 2N, H) f32.

    The op on the `relayout` of w_hh: CUDA tensors run the hand-written
    kernel on the current stream, CPU tensors `recurrence_plain`."""
    _check(xg, w_hh, cols=False)
    return lstm_recurrence(xg, relayout(w_hh))


def recurrence_cols(xg: torch.Tensor, w_cols: torch.Tensor) -> torch.Tensor:
    """`recurrence` with the weights already in the kernel's layout,
    w_cols (2, 4H, H) = `relayout(w_hh)`.

    CUDA tensors: the hand-written kernel, on the current stream. CPU
    tensors: `recurrence_plain` on `undo_relayout(w_cols)`."""
    _check(xg, w_cols, cols=True)
    return lstm_recurrence(xg, w_cols)


@torch.library.custom_op("vocal_remover_tpu_torch::lstm_recurrence",
                         mutates_args=())
def lstm_recurrence(xg: torch.Tensor, w_cols: torch.Tensor) -> torch.Tensor:
    """The op's implementation for every device but CUDA: the plain
    version on the CPU, an error elsewhere."""
    if xg.device.type != "cpu":
        raise ValueError(f"no recurrence kernel for device {xg.device}")
    return recurrence_plain(xg, undo_relayout(w_cols))


@lstm_recurrence.register_fake
def _lstm_recurrence_fake(xg, w_cols):
    _check(xg, w_cols, cols=True)
    t_len, two_n, four_h = xg.shape
    return xg.new_empty(t_len, two_n, four_h // 4)


@lstm_recurrence.register_kernel("cuda")
def _lstm_recurrence_cuda(xg, w_cols):
    """The kernel launch, on the current stream."""
    global launches
    _check(xg, w_cols, cols=True)
    if not (xg.is_contiguous() and w_cols.is_contiguous()):
        raise ValueError("the recurrence kernel takes contiguous tensors")
    t_len, two_n, four_h = xg.shape
    hidden = four_h // 4
    hs = torch.empty(t_len, two_n, hidden, device=xg.device,
                     dtype=torch.float32)
    if t_len == 0 or two_n == 0:
        return hs
    lib = _lib()
    # a row's state lives in shared memory unless H is too large for it
    n_scratch = lib.lstm_recurrence_scratch(two_n // 2, hidden)
    scratch = torch.empty(n_scratch, device=xg.device) if n_scratch else None
    with torch.cuda.device(xg.device):
        stream = torch.cuda.current_stream(xg.device).cuda_stream
        err = lib.lstm_recurrence(
            xg.data_ptr(), w_cols.data_ptr(), hs.data_ptr(),
            scratch.data_ptr() if scratch is not None else None, t_len,
            two_n // 2, hidden, stream)
    if err != 0:
        raise RuntimeError(f"lstm_recurrence launch failed: CUDA error {err}")
    launches += 1
    return hs


def _lib() -> ctypes.CDLL:
    lib = build.load("lstm_recurrence")
    if lib.lstm_recurrence.argtypes is None:
        lib.lstm_recurrence.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.lstm_recurrence.restype = ctypes.c_int
        lib.lstm_recurrence_scratch.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.lstm_recurrence_scratch.restype = ctypes.c_longlong
    return lib
