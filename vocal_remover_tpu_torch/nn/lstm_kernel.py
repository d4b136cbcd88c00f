"""The BiLSTM recurrence: CUDA kernel wrapper and its plain version.

Counterpart of vocal_remover_tpu/nn/lstm_pallas.py `_run_recurrence`.
The kernel is csrc/lstm_recurrence.cu (see its header for the design and
what bounds it). `recurrence` launches it for CUDA tensors and takes the
plain PyTorch loop `recurrence_plain` only for CPU tensors; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from vocal_remover_tpu_torch import build

# kernel launches made by `recurrence` in this process (plain-version
# calls are not counted)
launches = 0

_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90


def recurrence_plain(xg: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """xg (T, 2N, 4H), w_hh (2, H, 4H) -> hs (T, 2N, H); zero initial
    state, gate order i, f, g, o, all f32. Same arithmetic as the kernel."""
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


def _check(xg: torch.Tensor, w_hh: torch.Tensor):
    if xg.dim() != 3 or w_hh.dim() != 3:
        raise ValueError(f"expected xg (T, 2N, 4H) and w_hh (2, H, 4H), got "
                         f"{tuple(xg.shape)} and {tuple(w_hh.shape)}")
    t_len, two_n, four_h = xg.shape
    hidden = four_h // 4
    if two_n % 2 or four_h % 4 or tuple(w_hh.shape) != (2, hidden, four_h):
        raise ValueError(f"expected xg (T, 2N, 4H) and w_hh (2, H, 4H), got "
                         f"{tuple(xg.shape)} and {tuple(w_hh.shape)}")
    if xg.dtype != torch.float32 or w_hh.dtype != torch.float32:
        raise TypeError(f"the recurrence runs in float32, got {xg.dtype} "
                        f"and {w_hh.dtype}")
    if xg.device != w_hh.device:
        raise ValueError(f"xg on {xg.device} but w_hh on {w_hh.device}")


def recurrence(xg: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """xg (T, 2N, 4H) f32, w_hh (2, H, 4H) f32 -> hs (T, 2N, H) f32.

    CUDA tensors: the hand-written kernel, on the current stream. CPU
    tensors: `recurrence_plain`."""
    global launches
    _check(xg, w_hh)
    if xg.device.type == "cpu":
        return recurrence_plain(xg, w_hh)
    if xg.device.type != "cuda":
        raise ValueError(f"no recurrence kernel for device {xg.device}")
    if not (xg.is_contiguous() and w_hh.is_contiguous()):
        raise ValueError("the recurrence kernel takes contiguous tensors")
    t_len, two_n, four_h = xg.shape
    hidden = four_h // 4
    lib = _lib()
    if four_h > 1024 or lib.lstm_recurrence_smem_bytes(hidden) > _SMEM_LIMIT:
        raise ValueError(f"hidden size {hidden} exceeds the kernel's block "
                         "(4H threads, w_hh in shared memory)")
    hs = torch.empty(t_len, two_n, hidden, device=xg.device,
                     dtype=torch.float32)
    if t_len == 0 or two_n == 0:
        return hs
    with torch.cuda.device(xg.device):
        stream = torch.cuda.current_stream(xg.device).cuda_stream
        err = lib.lstm_recurrence(xg.data_ptr(), w_hh.data_ptr(),
                                  hs.data_ptr(), t_len, two_n // 2, hidden,
                                  stream)
    if err != 0:
        raise RuntimeError(f"lstm_recurrence launch failed: CUDA error {err}")
    launches += 1
    return hs


def _lib() -> ctypes.CDLL:
    lib = build.load("lstm_recurrence")
    if lib.lstm_recurrence.argtypes is None:
        lib.lstm_recurrence.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.lstm_recurrence.restype = ctypes.c_int
        lib.lstm_recurrence_smem_bytes.argtypes = [ctypes.c_int]
        lib.lstm_recurrence_smem_bytes.restype = ctypes.c_size_t
    return lib
