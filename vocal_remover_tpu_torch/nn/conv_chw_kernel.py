"""The channel-major fused conv ("variant A"): CUDA kernel wrapper and
its plain version.

Counterpart of vocal_remover_tpu/nn/conv_pallas.py `_conv_call`. The
kernel is csrc/conv_chw.cu (tensor-core products on a channel-innermost
staged box, one box a group of taps; see its header for the design and
what bounds it). `conv_call` launches it for CUDA tensors and takes the
plain PyTorch version `conv_call_plain` only for CPU tensors; on a CUDA
tensor it launches the kernel or raises.

Operands: `x` (N, C_total, H, W) float32 or bfloat16, `w2` (taps *
cin_blk, Cout) in x's dtype with rows ordered [tap][ci], `b` (Cout,)
float32, the static tap table `(channel_block, dy, dx)`, the total tap
reach `pad_hw` and how much of it lies above / left of the image
(`origin`). One difference from the TPU kernel: `x` is the UNPADDED
tensor. Output pixel (i, j) reads, for tap (cblk, dy, dx), input pixel
(i + dy - origin[0], j + dx - origin[1]) of channels cblk * cin_blk ...,
and pixels outside the image are zero. The table may hold any number of
taps of any reach: the kernel runs it as `tap_groups`, each group one
staged box of at most GROUP_ROWS x GROUP_COLS taps of one channel block.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from vocal_remover_tpu_torch import build

# kernel launches made by `conv_call` in this process (plain-version calls
# are not counted)
launches = 0

# what a group of taps may span and the ints of its record; they must equal
# kGH, kGW and kRec in csrc/conv_chw.cu (the wrapper checks at load)
GROUP_ROWS, GROUP_COLS, GROUP_INTS = 3, 4, 20
ACTS = {None: 0, "none": 0, "identity": 0, "relu": 1, "leaky_relu": 2}
DTYPES = (torch.float32, torch.bfloat16)


def activate(y, act):
    if ACTS[act] == 1:
        return torch.relu(y)
    if ACTS[act] == 2:
        return torch.where(y >= 0, y, 0.01 * y)
    return y


def check_operands(x, w2, b, act, out_dtype):
    """What all three channel-major conv kernels ask of their operands;
    -> Cout."""
    if act not in ACTS:
        raise ValueError(f"unsupported fused activation {act!r}")
    if x.dim() != 4 or w2.dim() != 2 or b.dim() != 1:
        raise ValueError(f"expected x (N, C, H, W), w2 (K, Cout) and b "
                         f"(Cout,), got {tuple(x.shape)}, {tuple(w2.shape)}, "
                         f"{tuple(b.shape)}")
    if x.dtype not in DTYPES or w2.dtype != x.dtype:
        raise TypeError(f"x and w2 must share float32 or bfloat16, got "
                        f"{x.dtype} and {w2.dtype}")
    if b.dtype != torch.float32:
        raise TypeError(f"the bias adds in float32, got {b.dtype}")
    if out_dtype not in DTYPES:
        raise TypeError(f"output dtype {out_dtype} is not float32/bfloat16")
    if not (x.device == w2.device == b.device):
        raise ValueError(f"operands on different devices: {x.device}, "
                         f"{w2.device}, {b.device}")
    if b.shape[0] != w2.shape[1]:
        raise ValueError(f"bias has {b.shape[0]} channels, w2 "
                         f"{w2.shape[1]}")
    return w2.shape[1]


def check_cuda(name, *tensors):
    """Raise unless every tensor is a contiguous CUDA tensor."""
    if tensors[0].device.type != "cuda":
        raise ValueError(f"no {name} kernel for device {tensors[0].device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"the {name} kernel takes contiguous tensors")


def _check(x, w2, b, taps, pad_hw, origin, act, out_dtype):
    """Validate the operands; -> (cin_blk, cout)."""
    cout = check_operands(x, w2, b, act, out_dtype)
    taps = tuple(taps)
    if not taps:
        raise ValueError("the tap table is empty")
    if w2.shape[0] % len(taps):
        raise ValueError(f"w2 has {w2.shape[0]} rows: no multiple of "
                         f"{len(taps)} taps")
    cin_blk = w2.shape[0] // len(taps)
    c_total = x.shape[1]
    if cin_blk == 0 or c_total % cin_blk:
        raise ValueError(f"x has {c_total} channels: no whole number of "
                         f"blocks of {cin_blk}")
    (ph, pw), (pt, pl) = pad_hw, origin
    if not (0 <= pt <= ph and 0 <= pl <= pw):
        raise ValueError(f"origin {origin} lies outside the pad {pad_hw}")
    for cblk, dy, dx in taps:
        if not (0 <= cblk < c_total // cin_blk and 0 <= dy <= ph
                and 0 <= dx <= pw):
            raise ValueError(f"tap {(cblk, dy, dx)} lies outside "
                             f"{c_total // cin_blk} channel block(s) and the "
                             f"pad {pad_hw}")
    return cin_blk, cout


def tap_groups(taps, origin):
    """The kernel's cut of a tap table into groups -> int32 array
    (n_groups, GROUP_INTS).

    A group holds taps of one channel block whose dy lie in a band of
    GROUP_ROWS rows from the smallest dy left and whose dx lie in a band
    of GROUP_COLS columns from the smallest dx left in that band, each at
    its slot (dy - dy0, dx - dx0); a repeated tap goes to a later group.
    Record: channel block, dy0 - origin[0], dx0 - origin[1], rows gh and
    columns gw of taps, the group's first weight slab (the groups' gh x gw
    slabs lie one after another), then the table index of the tap at each
    slot (row-major over GROUP_COLS, -1 for none), zero-padded. Output
    pixel (i, j) of the group's slot (sy, sx) reads input pixel
    (i + dy0 - origin[0] + sy, j + dx0 - origin[1] + sx)."""
    (pt, pl), rows, slab0 = origin, [], 0
    left = list(enumerate(tuple(t) for t in taps))
    while left:
        cblk = left[0][1][0]
        mine = [(i, dy, dx) for i, (c, dy, dx) in left if c == cblk]
        dy0 = min(dy for _, dy, _ in mine)
        band = [m for m in mine if m[1] < dy0 + GROUP_ROWS]
        dx0 = min(dx for _, _, dx in band)
        slots = [-1] * (GROUP_ROWS * GROUP_COLS)
        for i, dy, dx in band:
            s = (dy - dy0) * GROUP_COLS + dx - dx0
            if dx < dx0 + GROUP_COLS and slots[s] < 0:
                slots[s] = i
        taken = [s for s in range(len(slots)) if slots[s] >= 0]
        gh = max(s // GROUP_COLS for s in taken) + 1
        gw = max(s % GROUP_COLS for s in taken) + 1
        rows.append([cblk, dy0 - pt, dx0 - pl, gh, gw, slab0, *slots])
        slab0 += gh * gw
        done = {slots[s] for s in taken}
        left = [m for m in left if m[0] not in done]
    table = np.zeros((len(rows), GROUP_INTS), np.int32)
    table[:, :len(rows[0])] = rows
    return table


@functools.lru_cache(maxsize=64)
def _group_table(taps, origin, device):
    """-> (`tap_groups` on `device`, its weight slabs a channel chunk),
    made once per table."""
    table = tap_groups(taps, origin)
    return (torch.from_numpy(table).to(device),
            int((table[:, 3] * table[:, 4]).sum()))


def conv_call_plain(x, w2, b, taps, pad_hw, origin, act, out_dtype):
    """The kernel's arithmetic in plain PyTorch: the taps gathered by
    slicing the zero-padded input, one product over K = taps x cin_blk in
    float32 (bf16 operands are widened first, so each product is exact),
    bias, activation, cast."""
    cin_blk, _ = _check(x, w2, b, taps, pad_hw, origin, act, out_dtype)
    n, _, h, w = x.shape
    (ph, pw), (pt, pl) = pad_hw, origin
    xp = torch.nn.functional.pad(x.float(), (pl, pw - pl, pt, ph - pt))
    cols = torch.cat([
        xp[:, cblk * cin_blk:(cblk + 1) * cin_blk, dy:dy + h, dx:dx + w]
        for cblk, dy, dx in taps], dim=1)
    y = torch.einsum("nkhw,ko->nohw", cols, w2.float())
    return activate(y + b.reshape(1, -1, 1, 1), act).to(out_dtype)


def conv_call(x, w2, b, taps, pad_hw, origin, act, out_dtype):
    """x (N, C_total, H, W), w2 (taps * cin_blk, Cout), b (Cout,) f32 ->
    (N, Cout, H, W) in `out_dtype`.

    CUDA tensors: the hand-written kernel, on the current stream. CPU
    tensors: `conv_call_plain`."""
    global launches
    cin_blk, cout = _check(x, w2, b, taps, pad_hw, origin, act, out_dtype)
    if x.device.type == "cpu":
        return conv_call_plain(x, w2, b, taps, pad_hw, origin, act,
                               out_dtype)
    check_cuda("conv_chw", x, w2, b)
    n, c_total, h, w = x.shape
    out = torch.empty(n, cout, h, w, device=x.device, dtype=out_dtype)
    if out.numel() == 0:
        return out
    lib = _lib()
    groups, n_slabs = _group_table(tuple(tuple(t) for t in taps),
                                   tuple(origin), x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.conv_chw(
            x.data_ptr(), w2.data_ptr(), b.data_ptr(), out.data_ptr(),
            groups.data_ptr(), n, c_total, h, w, cout, cin_blk, len(taps),
            groups.shape[0], n_slabs, ACTS[act],
            int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
            stream)
    if err != 0:
        raise RuntimeError(f"conv_chw launch failed: CUDA error {err}")
    launches += 1
    return out


def _lib() -> ctypes.CDLL:
    lib = build.load("conv_chw")
    if lib.conv_chw.argtypes is None:
        if (lib.conv_chw_group_rows(), lib.conv_chw_group_cols(),
                lib.conv_chw_group_ints()) != (GROUP_ROWS, GROUP_COLS,
                                               GROUP_INTS):
            raise RuntimeError("conv_chw.cu and conv_chw_kernel.py disagree "
                               "on the tap groups' records")
        lib.conv_chw.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + [ctypes.c_void_p])
        lib.conv_chw.restype = ctypes.c_int
    return lib
