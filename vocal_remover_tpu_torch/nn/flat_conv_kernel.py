"""The flat pixel-packed conv: CUDA kernel wrapper and its plain version.

Counterpart of vocal_remover_tpu/nn/conv_pack.py `_flat_conv_core`. The
kernel is csrc/flat_conv.cu (see its header for the design and what
bounds it). `flat_conv_core` launches it for CUDA tensors and takes the
plain PyTorch version `flat_conv_core_plain` only for CPU tensors; on a
CUDA tensor it launches the kernel or raises.

The kernel walks only the slices of `wst` that hold a non-zero:
`block_table` lists them once per packed layer (models/base_net.py
`FlatLayer` keeps the table beside `wst` and rebuilds it whenever `wst`
may have changed); the plain version stays the dense product. The table
opens with a header naming the tile and the `wst` shape it was made
for, and `flat_conv_core` refuses a table whose header does not match
the call, on the CPU as on the card.

Operands, as the TPU kernel's: the flat input `xf` (N, H*WB, L), the
stacked tap matrices `wst` (rowtaps, L, |s_list|*NL), the bias (NL,) in
float32, and the static geometry (`wb`, `h_out`, `rowtaps`, `s_list`,
`act`, output dtype). One difference: `xf` is the UNPADDED flat tensor.
The TPU wrapper pads zero rows on top and below (the 'SAME' padding
along frequency plus the reach of its tile copies) and, for stride 2,
takes the row-parity view of the result; here a row tap `(plane, off)`
is turned into the offset of the image row it reads (stride 1: `off -
pad`; stride 2: `2*off + plane - 2`), and rows outside the image read as
zero inside the kernel, which saves a copy of the largest tensors of the
net.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from vocal_remover_tpu_torch import build
from vocal_remover_tpu_torch.nn.conv_chw_kernel import ACTS as _ACTS
from vocal_remover_tpu_torch.nn.conv_chw_kernel import DTYPES as _DTYPES
from vocal_remover_tpu_torch.nn.conv_chw_kernel import activate as _activate

# kernel launches made by `flat_conv_core` in this process (plain-version
# calls are not counted)
launches = 0

_S_LISTS = ((0,), (-1, 0, 1), (-1, 0))

# the kernel's tile per input type, (K, N): a step of its walk is one
# (row tap, K-deep slice of L) for one N-wide tile of output lanes
TILES = {torch.float32: (16, 64), torch.bfloat16: (32, 128)}

# ints of a walk table's header (flat_conv_table_header in the source)
HEADER = 5


def walk_header(wst, dtype=None):
    """The header of the walk that the kernel takes for `wst` at the
    tile of `dtype` (default wst's): (BK, BN, taps, L, S*NL)."""
    return (*TILES[dtype or wst.dtype], *wst.shape)


def storage_key(t):
    """(data pointer, version) of a tensor: a new storage or an in-place
    edit changes it. An inference tensor keeps no version (None)."""
    return t.data_ptr(), None if t.is_inference() else t._version


def block_table(wst, s_list):
    """The kernel's walk over the non-zero blocks of `wst` (taps, L,
    S*NL) at the tile of wst's dtype (`TILES`): int32 tensor on wst's
    device, the `HEADER` ints of `walk_header(wst)`, then `n_tiles + 1`
    offsets (lane tile j owns codes [off[j], off[j+1])), then the step
    codes, each `tap | k_slice << 2 | shifts << 29`, where bit b of
    `shifts` says that block shift b - 1 has a non-zero in that (tap, K
    slice, lane tile). Steps run in (tap, K slice) order."""
    s_list = tuple(s_list)
    header = walk_header(wst)
    bk, bn = header[:2]
    n_rt, l_in, nst = wst.shape
    ns = len(s_list)
    nl = nst // ns
    n_ks, n_tiles = -(-l_in // bk), -(-nl // bn)
    if n_ks >= 1 << 27:
        raise ValueError(f"L = {l_in} is too deep for the step code")
    nz = (wst.detach().cpu() != 0).reshape(n_rt, l_in, ns, nl).numpy()
    nz = np.pad(nz, ((0, 0), (0, n_ks * bk - l_in), (0, 0),
                     (0, n_tiles * bn - nl)))
    nz = nz.reshape(n_rt, n_ks, bk, ns, n_tiles, bn).any(
        axis=(2, 5))  # (taps, K slices, shifts, lane tiles)
    shifts = sum(nz[:, :, j].astype(np.int64) << (s + 1)
                 for j, s in enumerate(s_list))  # (taps, K slices, tiles)
    t, ks = np.meshgrid(np.arange(n_rt), np.arange(n_ks), indexing="ij")
    codes, offsets = [], [0]
    for j in range(n_tiles):
        live = shifts[:, :, j] != 0
        codes.append(t[live] | ks[live] << 2 | shifts[:, :, j][live] << 29)
        offsets.append(offsets[-1] + int(live.sum()))
    table = np.concatenate([np.asarray(header + tuple(offsets), np.int64)]
                           + codes)
    table = torch.from_numpy(table.astype(np.int32)).to(wst.device)
    table._walk_memo = (*storage_key(table), header)
    return table


def _read_header(blocks):
    """The header of a walk table. A table on the card is read back once
    (that waits for its stream) and remembered for this tensor while
    its storage and version stay the same (the memo is an attribute of
    the tensor); `block_table` records its own."""
    key = storage_key(blocks)
    memo = getattr(blocks, "_walk_memo", None)
    if memo is None or memo[:2] != key:
        memo = blocks._walk_memo = (*key, tuple(blocks[:HEADER].tolist()))
    return memo[2]


def _check_walk(blocks, xf, wst):
    """Refuse a walk table that was not made for this wst at the tile of
    xf's dtype."""
    if blocks.dtype != torch.int32 or blocks.dim() != 1 or \
            blocks.device != xf.device or blocks.numel() < HEADER or \
            not blocks.is_contiguous():
        raise ValueError(f"blocks must be the contiguous int32 block_table "
                         f"of wst on {xf.device}, got {blocks.dtype} "
                         f"{tuple(blocks.shape)} on {blocks.device}")
    want, got = walk_header(wst, xf.dtype), _read_header(blocks)
    if got != want:
        raise ValueError(f"blocks is a block_table made for (tile, wst "
                         f"shape) {got[:2]}, {got[2:]}, but this call needs "
                         f"{want[:2]}, {want[2:]}")


def _geometry(rowtaps, s_list):
    """-> (stride, image-row offset of each row tap). Raises on a tap
    table that `flat_geometry` does not make."""
    rowtaps = tuple(tuple(rt) for rt in rowtaps)
    s_list = tuple(s_list)
    if s_list not in _S_LISTS:
        raise ValueError(f"s_list {s_list} is not one of {_S_LISTS}")
    if all(plane is None for plane, _ in rowtaps):
        kh = len(rowtaps)
        if rowtaps != tuple((None, dy) for dy in range(kh)) or \
                (kh, s_list) not in ((1, (0,)), (3, (-1, 0, 1))):
            raise ValueError(f"inconsistent stride-1 geometry: rowtaps "
                             f"{rowtaps}, s_list {s_list}")
        pad = (kh - 1) // 2
        return 1, tuple(off - pad for _, off in rowtaps)
    if rowtaps != ((1, 0), (0, 1), (1, 1)) or s_list != (-1, 0):
        raise ValueError(f"inconsistent stride-2 geometry: rowtaps "
                         f"{rowtaps}, s_list {s_list}")
    return 2, tuple(2 * off + plane - 2 for plane, off in rowtaps)


def _check(xf, wst, bias, wb, h_out, rowtaps, s_list, act, out_dtype):
    """Validate the operands; -> (stride, row offsets, h_in, nl)."""
    stride, roffs = _geometry(rowtaps, s_list)
    if act not in _ACTS:
        raise ValueError(f"unsupported fused activation {act!r}")
    if xf.dim() != 3 or wst.dim() != 3 or bias.dim() != 1:
        raise ValueError(f"expected xf (N, H*WB, L), wst (taps, L, S*NL) "
                         f"and bias (NL,), got {tuple(xf.shape)}, "
                         f"{tuple(wst.shape)}, {tuple(bias.shape)}")
    if xf.dtype not in _DTYPES or wst.dtype != xf.dtype:
        raise TypeError(f"xf and wst must share float32 or bfloat16, got "
                        f"{xf.dtype} and {wst.dtype}")
    if bias.dtype != torch.float32:
        raise TypeError(f"the bias adds in float32, got {bias.dtype}")
    if out_dtype not in _DTYPES:
        raise TypeError(f"output dtype {out_dtype} is not float32/bfloat16")
    if not (xf.device == wst.device == bias.device):
        raise ValueError(f"operands on different devices: {xf.device}, "
                         f"{wst.device}, {bias.device}")
    n, mf, l_in = xf.shape
    n_rt, klw, nst = wst.shape
    if n_rt != len(roffs) or klw != l_in or nst % len(s_list):
        raise ValueError(f"wst {tuple(wst.shape)} does not fit {len(roffs)} "
                         f"row taps, L = {l_in}, {len(s_list)} shifts")
    nl = nst // len(s_list)
    if bias.shape[0] != nl:
        raise ValueError(f"bias has {bias.shape[0]} lanes, expected {nl}")
    if wb <= 0 or h_out < 0 or mf != stride * h_out * wb:
        raise ValueError(f"flat input has {mf} rows, expected stride * h_out"
                         f" * wb = {stride} * {h_out} * {wb}")
    return stride, roffs, stride * h_out, nl


def flat_conv_core_plain(xf, wst, bias, *, wb, h_out, rowtaps, s_list, act,
                         out_dtype):
    """The kernel's arithmetic in plain PyTorch: per row tap one product
    of the (zero-padded) flat rows with `wst[t]`, accumulated in
    float32; the +-1 block shifts added on the accumulator under the
    `m % wb` masks; bias; activation; cast. bf16 operands are multiplied
    exactly (a product of two bf16 values is exact in float32)."""
    stride, roffs, h_in, nl = _check(xf, wst, bias, wb, h_out, rowtaps,
                                     s_list, act, out_dtype)
    n, _, l_in = xf.shape
    m = h_out * wb
    x = xf.float().reshape(n, h_in, wb, l_in)
    lo, hi = -min(roffs), max(0, stride * (h_out - 1) + max(roffs) - h_in + 1)
    xp = torch.nn.functional.pad(x, (0, 0, 0, 0, lo, hi))
    acc = xf.new_zeros((n, m, wst.shape[2]), dtype=torch.float32)
    for t, roff in enumerate(roffs):
        rows = xp[:, lo + roff: lo + roff + stride * h_out: stride]
        acc = acc + rows.reshape(n, m, l_in) @ wst[t].float()
    g = torch.arange(m, device=xf.device).remainder(wb).reshape(1, m, 1)
    zero = acc.new_zeros((n, 1, nl))
    y = acc.new_zeros((n, m, nl))
    for j, s in enumerate(s_list):
        blk = acc[:, :, j * nl: (j + 1) * nl]
        if s == 0:
            y = y + blk
        elif s == 1:  # out[m] += acc[m + 1] unless m ends an image row
            y = y + torch.where(g != wb - 1,
                                torch.cat([blk[:, 1:], zero], 1), 0.0)
        else:  # out[m] += acc[m - 1] unless m starts an image row
            y = y + torch.where(g != 0,
                                torch.cat([zero, blk[:, :-1]], 1), 0.0)
    return _activate(y + bias, act).to(out_dtype)


def flat_conv_core(xf, wst, bias, *, wb, h_out, rowtaps, s_list, act,
                   out_dtype, blocks=None):
    """xf (N, stride*h_out*wb, L), wst (taps, L, S*NL), bias (NL,) f32
    -> (N, h_out*wb, NL) in `out_dtype`.

    CUDA tensors: the hand-written kernel, on the current stream, walking
    `blocks` (`block_table(wst, s_list)` on the card; built here, which
    reads wst back to the host, when not given). CPU tensors:
    `flat_conv_core_plain`."""
    global launches
    stride, roffs, h_in, nl = _check(xf, wst, bias, wb, h_out, rowtaps,
                                     s_list, act, out_dtype)
    if blocks is not None:
        _check_walk(blocks, xf, wst)
    if xf.device.type == "cpu":
        return flat_conv_core_plain(
            xf, wst, bias, wb=wb, h_out=h_out, rowtaps=rowtaps,
            s_list=s_list, act=act, out_dtype=out_dtype)
    if xf.device.type != "cuda":
        raise ValueError(f"no flat-conv kernel for device {xf.device}")
    if not (xf.is_contiguous() and wst.is_contiguous()
            and bias.is_contiguous()):
        raise ValueError("the flat-conv kernel takes contiguous tensors")
    n, _, l_in = xf.shape
    out = torch.empty(n, h_out * wb, nl, device=xf.device, dtype=out_dtype)
    if out.numel() == 0:
        return out
    if blocks is None:
        blocks = block_table(wst, s_list)
    lib = _lib()
    roffs = roffs + (0,) * (3 - len(roffs))
    with torch.cuda.device(xf.device):
        stream = torch.cuda.current_stream(xf.device).cuda_stream
        err = lib.flat_conv(
            xf.data_ptr(), wst.data_ptr(), bias.data_ptr(), blocks.data_ptr(),
            out.data_ptr(),
            n, h_in, h_out, wb, l_in, nl, stride, len(rowtaps), *roffs,
            s_list[0], len(s_list), _ACTS[act],
            int(xf.dtype == torch.bfloat16),
            int(out_dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"flat_conv launch failed: CUDA error {err}")
    launches += 1
    return out


def _lib() -> ctypes.CDLL:
    lib = build.load("flat_conv")
    if lib.flat_conv.argtypes is None:
        lib.flat_conv.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 16 + [ctypes.c_void_p])
        lib.flat_conv.restype = ctypes.c_int
        for dtype, tile in TILES.items():
            bf16 = int(dtype == torch.bfloat16)
            if (lib.flat_conv_block_k(bf16), lib.flat_conv_block_n(bf16)) \
                    != tile:
                raise RuntimeError("flat_conv.cu and flat_conv_kernel.py "
                                   "disagree on the kernel's tile")
        if lib.flat_conv_table_header() != HEADER:
            raise RuntimeError("flat_conv.cu and flat_conv_kernel.py "
                               "disagree on the walk table's header")
    return lib
