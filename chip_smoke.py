#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vocal_remover_tpu_torch) on one
NVIDIA Hopper card.

    python3 chip_smoke.py [--seed 0] [--profile]

Phases (each prints a line; any failure exits non-zero):
  1. card: name, capability (9, 0), nvidia-smi name and power limit;
  2. build: every CUDA kernel of the port, from csrc/, in parallel (one
     nvcc per source); then the native audio decoders (native/), timed
     on a line of their own, so that [spec]'s FLAC run decodes warm;
  3. kernels: each kernel against its plain PyTorch version on the card
     at the main paths' shapes (max abs error against a stated
     tolerance, kernel / plain / library times from CUDA events,
     roofline bound from the useful work, the share of the bound and the
     ratio to the library time; A, C and D in f32 also the bound at the
     3xTF32 rate): the BiLSTM recurrence (also at H = 256, its wide
     path), and the flat conv at all four layers of stg3_full_band_net and of
     stg1_high_band_net in f32 and bf16, both at directory mode's
     shapes too (crop 1024, batch 24: T = 512, 2N = 48; enc2 of
     stg3_full_band_net at N = 24, W = 1024 / 512), plus ragged cases; the three
     channel-major conv kernels (variant A = conv_chw, C = conv_shift,
     D = conv_tapdot) at the conv kernel lab's shapes, (8, 32, 1024, 256)
     and (8, 64, 512, 128), in f32 and bf16, all three at ragged shapes,
     on an unaligned input and at Cin 512, A also at stride 2 (also with
     ragged channel blocks), 1x1 and 7x7;
  4. main paths: the flagship CascadedNet(2048, 1024, 32, 128) with random
     weights from a seeded torch.Generator, saved as a .vrt.npz, separates
     a 60 s stereo 44.1 kHz synthetic song through the CLI, with every
     kernel's launch count set to 0 before and read after each run (first
     a packed copy, moved to the card and cast to bf16 as a module, is
     held to carry block_table(wst) on every FlatLayer):
       plain       (first, warm, --tta): recurrence 30 / 60 launches;
       --flat_conv (first, warm, --tta): flat conv 120 / 240, recurrence
                   30 / 60; stems within 1 LSB of the plain path's;
       --flat_conv --precision bfloat16 (first, warm): same counts; SNR of
                   the stems against the `highest` stems held to a floor;
       on both --flat_conv paths one more warm run under torch.profiler
       gives the flat conv's kernel time summed over the song's launches;
     every run's stems are checked for shape, dtype and the residual
     invariant Instruments + Vocals == mixture (within 2 PCM16 LSB);
  5. reference: a 4 s song through the CLI on the card and on the CPU
     (plain versions of both kernels), plain and --flat_conv: stems
     within 1 LSB;
  5b. spectrogram path ([spec]): the 60 s song through the CLI's host
     STFT / iSTFT path with masks on the card: --output_image (stems
     within 1 LSB of the device pipeline with --exact_length, both
     images of (1025, frames, 3), not constant: JPEGs where PIL is
     installed, then PNGs from the stdlib writer with PIL hidden),
     --postprocess with
     and without --tta (against --stream --postprocess within
     SPEC_VS_STREAM_LSB), --postprocess --flat_conv --precision bfloat16
     (SNR floor, 20 flat conv launches a chunk), a .pth of the same
     weights and the song as FLAC (both bit-identical to the .vrt.npz WAV
     run), --profile (a Chrome trace naming the recurrence kernel); each
     run with its stage walls, launches (recurrence 30 a song, 60 with
     --tta), residual, peak device memory and the card's power limit;
  6. directory mode ([dir]): 10 songs (8 x 60 s, 45 s, 95 s: one group of
     8 and two songs alone) through --input_dir at its defaults (bf16,
     crop 1024, batch 24, group 8) first, warm and under torch.profiler
     (busy share, top kernels), then with --flat_conv and with --precision
     highest: launch counts, stems and residual of every song, peak device
     memory, xRT and songs/s; every song against the same song
     through Separator.separate_wave (1 LSB in highest, the SNR floor in
     bf16); the same songs one by one through the single-file bf16 path;
  7. streaming ([stream]): a 150 s song with -i --stream in highest
     against the monolithic --exact_length stems (1 LSB), the same with
     --tta, --stream --postprocess and --stream in bf16, each with its
     launch counts, residual and xRT;
  7b. export ([export]): the flagship checkpoint through the export CLI
     on the card in bfloat16 and highest at crops 256 and 1024 (export
     seconds, file size, load seconds); the recurrence's custom op under
     torch.library.opcheck and against its plain version on the card;
     the 60 s song through -P model.vrtx, first and warm, in both
     precisions: 30 recurrence launches a run, stems within 1 LSB of the
     .vrt.npz run at the same precision, walls side by side; the 1024
     entry at batch 24 against the .vrt.npz run (1 LSB); [dir]'s songs
     through --input_dir on the bf16 artifact against [dir]'s .vrt.npz
     stems (0 LSB); the file written on the card loaded on the CPU, and
     the card's programs moved to the CPU: one chunk of masks each
     against the card's (CROSS_DEVICE_TOL);
  8. lab path: the port's two conv tools at their default shapes and dtype
     (scripts/conv_kernel_lab.py: variants A, C, D chained and checked
     against conv2d; scripts/bench_conv_kernel.py: variant A against the
     library's routes), with every launch count set to 0 before and held
     to what the flags imply after;
  then the kernels' JSON line, and the device line last.
--profile adds a torch.profiler breakdown of one warm separation on each
of the three paths, with the flat conv's and the recurrence's share of
the kernel time.

Exits non-zero without printing a result when no CUDA card is present or
when the port's package is not beside this script.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import gc
import importlib.util
import io
import json
import os
import struct
import subprocess
import sys
import tempfile
import time
import wave as wav_io
import zlib

import numpy as np
import torch

# Published peaks of one H100 SXM at 700 W (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

FLAGSHIP_PARAMS = 14_740_882
SONG_SECONDS = 60
SR = 44100
# stems of --precision bfloat16 against the highest stems: 83.2 dB seen on
# an H100 with this script's random weights; the floor leaves 20 dB
BF16_SNR_FLOOR_DB = 60.0


def fail(msg: str):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of `fn()` over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def share(row) -> str:
    """A kernel row's share of its bound and its ratio to the library."""
    return (f"{100 * row['bound_ms'] / row['ms']:.1f}% of bound, "
            f"{row['ms'] / row['library_ms']:.2f}x the library time")


def walked_share(blocks, wst_shape, ns, dtype) -> float:
    """Share of the dense wst products that the flat conv's walk
    multiplies: listed (tap, K slice, shift) blocks of its tiles over
    all of them."""
    from vocal_remover_tpu_torch.nn import flat_conv_kernel as fk

    n_rt, l_in, nst = wst_shape
    bk, bn = fk.TILES[dtype]
    n_tiles = -(-(nst // ns) // bn)
    codes = blocks[fk.HEADER + n_tiles + 1:].cpu().numpy().astype(np.int64)
    live = sum(int(((codes >> 29) >> b & 1).sum()) for b in range(3))
    return live / (n_rt * -(-l_in // bk) * ns * n_tiles)


def phase_card():
    """-> (the card's name, nvidia-smi's name and power limit)."""
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[card] {name} capability {cap[0]}.{cap[1]} torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)
    print(smi, flush=True)
    check(cap == (9, 0), f"needs a Hopper card (sm_90), got {cap}")
    return name, smi


def phase_build(kernels):
    from vocal_remover_tpu_torch import build

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(kernels)) as pool:
        paths = list(pool.map(build.build, [k["name"] for k in kernels]))
    for k in kernels:
        build.load(k["name"])
    print(f"[build] {len(paths)} kernel(s) in "
          f"{time.perf_counter() - t0:.2f}s: "
          + ", ".join(os.path.basename(p) for p in paths), flush=True)


def phase_native_build():
    """The native audio decoders, built before [spec]: its FLAC run's
    `load audio` stage is then a warm decode."""
    from vocal_remover_tpu_torch.native import build as native_build

    t0 = time.perf_counter()
    native_build.load()
    print(f"[build] native decoders: {time.perf_counter() - t0:.2f} s "
          f"({os.path.basename(native_build.build())}, "
          f"{native_build.compiler()} {' '.join(native_build.CFLAGS)})",
          flush=True)


def recurrence_cases():
    """(T, 2N, H, input size) of the main path's launches, flagship at
    crop 256 and batch 4: T = crop / 2, 2N = 2 directions x 4 patches;
    H = 64 (low and full nets; input 256 / 512 bins), 32 (high nets);
    directory mode's, at crop 1024 and batch 24: T = 512, 2N = 48; plus
    cases no path makes: a ragged one, and H = 256 (a checkpoint with
    nout_lstm = 512: the kernel's wide path)."""
    return [(128, 8, 64, 256), (128, 8, 32, 256), (128, 8, 64, 512),
            (512, 48, 64, 512), (512, 48, 32, 256),
            (37, 10, 32, 48), (128, 8, 256, 512)]


def phase_recurrence(gen):
    from vocal_remover_tpu_torch.nn import lstm_kernel

    rows = []
    for t_len, two_n, hidden, n_in in recurrence_cases():
        xg = torch.randn(t_len, two_n, 4 * hidden, device="cuda",
                         generator=gen)
        w_hh = torch.randn(2, hidden, 4 * hidden, device="cuda",
                           generator=gen) / hidden ** 0.5
        # the model path hands the kernel its weight layout (nn/lstm.py)
        w_cols = lstm_kernel.relayout(w_hh)
        out = lstm_kernel.recurrence_cols(xg, w_cols)
        torch.cuda.synchronize()
        ref = lstm_kernel.recurrence_plain(xg, w_hh)
        err = (out - ref).abs().max().item()
        check(err <= 2e-5, f"recurrence {t_len}x{two_n}x{hidden}: max abs "
                           f"err {err} > 2e-5")
        ms = cuda_ms(lambda: lstm_kernel.recurrence_cols(xg, w_cols), 200)
        plain_ms = cuda_ms(lambda: lstm_kernel.recurrence_plain(xg, w_hh), 5)
        # yardstick only (never called by the port): cuDNN's BiLSTM at
        # the same (T, N, H), which also runs its own input projection
        lstm = torch.nn.LSTM(n_in, hidden, bidirectional=True).cuda()
        x = torch.randn(t_len, two_n // 2, n_in, device="cuda", generator=gen)
        with torch.inference_mode():
            library_ms = cuda_ms(lambda: lstm(x), 50)
        n_bytes = 4 * (xg.numel() + w_hh.numel() + out.numel())
        # matrix products and gate adds; the transcendentals are excluded
        n_ops = t_len * two_n * 4 * hidden * (2 * hidden + 1)
        t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, n_ops / PEAK_F32_FLOPS * 1e3
        row = {
            "shape": [t_len, two_n, hidden], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        }
        rows.append(row)
        print(f"[kernel] lstm_recurrence T={t_len} 2N={two_n} H={hidden}: "
              f"max_abs_err {err:.3g} (tol 2e-5), kernel {ms:.4f} ms "
              f"({1e3 * ms / t_len:.3f} us a step), plain {plain_ms:.4f} ms, "
              f"torch.nn.LSTM bidirectional {library_ms:.4f} ms (incl. its "
              f"input GEMM), bound {row['bound_ms']:.6f} ms ({row['bound_by']}"
              f"); {share(row)}", flush=True)
    return rows


def flat_conv_cases():
    """(label, N, H, W, cin, cout, k, stride, p_out) of the flat conv's
    launches on the --flat_conv path, flagship at crop 256 and batch 4:
    the four layers of stg3_full_band_net (F = 1024, c1 = 32, p1 = 4: the
    widest) and of stg1_high_band_net (F = 512, c1 = 8, p1 = 16: the most
    packed); enc2 of stg3_full_band_net at directory mode's crop 1024 and
    batch 24; then cases no path makes: a 1x1 whose row count is no
    multiple of the kernel's 64-row tile, and a stride-2 conv with ragged
    lanes (L = 120, NL = 120)."""
    cases = []
    for net, bins, c1, p1 in (("stg3_full", 1024, 32, 4),
                              ("stg1_high", 512, 8, 16)):
        cases += [
            (f"{net} enc2_conv1", 4, bins, 256, c1, 2 * c1, 3, 2, p1 // 2),
            (f"{net} enc2_conv2", 4, bins // 2, 128, 2 * c1, 2 * c1, 3, 1,
             p1 // 2),
            (f"{net} enc3_conv1", 4, bins // 2, 128, 2 * c1, 4 * c1, 3, 2,
             p1 // 4),
            (f"{net} enc3_conv2", 4, bins // 4, 64, 4 * c1, 4 * c1, 3, 1,
             p1 // 4),
        ]
    # directory mode (crop 1024, batch 24): stg3_full_band_net's enc2,
    # whose stride-2 conv reads the full 1024-frame width
    cases += [("dir stg3_full enc2_conv1", 24, 1024, 1024, 32, 64, 3, 2, 2),
              ("dir stg3_full enc2_conv2", 24, 512, 512, 64, 64, 3, 1, 2)]
    cases += [("ragged 1x1", 3, 21, 96, 32, 48, 1, 1, 4),
              ("ragged s2", 2, 10, 48, 20, 40, 3, 2, 3)]
    return cases


def phase_flat_conv(seed):
    """The flat-conv kernel against `flat_conv_core_plain` on the card.

    Tolerances: f32 in and out 1e-4 absolute (the same f32 products,
    summed in another order, outputs of order 1); bf16 in and out,
    compared in the working type: 2^-7 of the largest output (one bf16
    step there: kernel and plain version round the same f32 sum, which
    they reach in another order).
    Bound: the conv's USEFUL work, whatever computes it: FLOPs = 2 N
    H_out W_out Cout k k Cin over the bf16 tensor-core peak (bf16), or
    three times that over the TF32 peak (f32, which the kernel multiplies
    as three TF32 products, 3xTF32), bytes = input + output + the HWIO
    weights + the bias once. Library yardstick (never called by the
    port): one torch.nn.functional.conv2d with bias on the same tensor in
    channels_last, plus the activation."""
    from vocal_remover_tpu_torch.nn import conv_pack as cp
    from vocal_remover_tpu_torch.nn import flat_conv_kernel as fk

    rng = np.random.default_rng(seed)
    rows = []
    for label, n, h, w, cin, cout, k, stride, p_out in flat_conv_cases():
        wk = (rng.standard_normal((k, k, cin, cout))
              / np.sqrt(k * k * cin)).astype(np.float32)
        b = (0.1 * rng.standard_normal(cout)).astype(np.float32)
        layer = cp.build_flat_layer(wk, b, p_out, stride, act="leaky_relu")
        x32 = torch.from_numpy(
            rng.standard_normal((n, h, w, cin), dtype=np.float32)).cuda()
        h_out, w_out = h // stride, w // stride
        flops = 2 * n * h_out * w_out * cout * k * k * cin
        for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            x = x32.to(dtype)
            args = dict(
                xf=cp.to_flat(x, layer["p_in"]),
                wst=torch.from_numpy(layer["wst"]).cuda().to(dtype),
                bias=torch.from_numpy(layer["bias"]).cuda(),
                wb=w_out // p_out, h_out=h_out, rowtaps=layer["rowtaps"],
                s_list=layer["s_list"], act="leaky_relu", out_dtype=dtype)
            # the walk, built once per packed layer as the model path does
            blocks = fk.block_table(args["wst"], layer["s_list"])
            out = fk.flat_conv_core(**args, blocks=blocks)
            torch.cuda.synchronize()
            ref = fk.flat_conv_core_plain(**args)
            check(out.shape == ref.shape and out.dtype == dtype,
                  f"flat_conv {label} {name}: output {tuple(out.shape)} "
                  f"{out.dtype}")
            err = (out.float() - ref.float()).abs().max().item()
            tol = 1e-4 if dtype == torch.float32 else \
                2.0 ** -7 * ref.float().abs().max().item()
            check(err <= tol, f"flat_conv {label} {name}: max abs err {err} "
                              f"> {tol}")
            ms = cuda_ms(lambda: fk.flat_conv_core(**args, blocks=blocks), 20)
            plain_ms = cuda_ms(lambda: fk.flat_conv_core_plain(**args), 3, 1)
            xc = x.permute(0, 3, 1, 2)  # NCHW view, channels_last strides
            wc = torch.from_numpy(wk).cuda().to(dtype).permute(
                3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            bc = torch.from_numpy(b).cuda().to(dtype)
            with torch.inference_mode():
                library_ms = cuda_ms(
                    lambda: torch.nn.functional.leaky_relu(
                        torch.nn.functional.conv2d(
                            xc, wc, bc, stride, (k - 1) // 2), 0.01), 10)
            size = 4 if dtype == torch.float32 else 2
            n_bytes = size * (x.numel() + out.numel() + wk.size) + 4 * b.size
            t_ops = (3 * flops / PEAK_TF32_FLOPS if dtype == torch.float32
                     else flops / PEAK_BF16_FLOPS) * 1e3
            t_bytes = n_bytes / PEAK_BYTES * 1e3
            dense = 2 * n * h_out * (w_out // p_out) * layer["wst"].size
            walked = dense * walked_share(blocks, layer["wst"].shape,
                                          len(layer["s_list"]), dtype)
            row = {
                "label": label, "dtype": name, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            }
            rows.append(row)
            print(f"[kernel] flat_conv {label} {name} x{tuple(args['xf'].shape)}"
                  f" wst{tuple(args['wst'].shape)}: max_abs_err {err:.3g} (tol "
                  f"{tol:.3g}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"conv2d channels_last {library_ms:.4f} ms, bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}; useful "
                  f"{flops / 1e9:.3f} GFLOP, walked {walked / 1e9:.3f} "
                  f"GFLOP of dense wst {dense / 1e9:.3f}, {n_bytes / 1e6:.2f}"
                  f" MB); {share(row)}", flush=True)
            del args, out, ref, x, xc, blocks
        del x32
    return rows

# the conv kernel lab's shapes (N, C, H, W): the flagship's full-width
# shallow levels at batch 8
LAB_SHAPES = ((8, 32, 1024, 256), (8, 64, 512, 128))


def chw_conv_cases():
    """(label, N, Cin, Cout, H, W, k, stride, variants): the lab's two
    shapes for all three variants; for A also a stride-2 conv through
    space_to_depth (four tap groups of 1, 2, 2 and 4 taps), the same with
    Cin 5 (channel blocks no multiple of a chunk), a 1x1 and a 7x7 (49
    taps in six groups, its whole pad on the top / left); ragged shapes:
    one wider than C's 256-lane tile, Cin no multiple of a channel chunk
    (40; 200, whose weights are streamed), Cout 7, H no multiple of a row
    tile, W no whole staging load (302), an input one element into its
    storage ("unaligned": not 16-byte aligned), and Cin 512 (the longest
    sums, where a float32 error would grow most)."""
    cases = [(f"lab {c}ch", n, c, c, h, w, 3, 1, "ACD")
             for n, c, h, w in LAB_SHAPES]
    cases += [("stride 2", 8, 32, 64, 1024, 256, 3, 2, "A"),
              ("stride 2 cin 5", 2, 5, 7, 66, 300, 3, 2, "A"),
              ("1x1", 4, 64, 32, 256, 128, 1, 1, "A"),
              ("7x7", 1, 32, 32, 256, 256, 7, 1, "A"),
              ("ragged", 2, 26, 32, 33, 40, 3, 1, "ACD"),
              ("ragged wide", 2, 5, 7, 9, 300, 3, 1, "CD"),
              ("ragged cin 40", 1, 40, 7, 13, 302, 3, 1, "ACD"),
              ("ragged cin 200", 2, 200, 7, 11, 300, 3, 1, "ACD"),
              ("unaligned", 2, 24, 20, 19, 64, 3, 1, "ACD"),
              ("deep cin 512", 1, 512, 32, 16, 64, 3, 1, "ACD")]
    return cases


def phase_chw_convs(seed):
    """The three channel-major conv kernels against their plain versions
    on the card.

    Tolerances, as for the flat conv: f32 in and out 1e-4 absolute (the
    same f32 products, summed in another order, outputs of order 1); bf16
    in and out, compared in the working type: 2^-7 of the largest output
    (one bf16 step there: kernel and plain version round the same f32
    sum, which they reach in another order).
    Bound: the conv's USEFUL work, whatever computes it: FLOPs = 2 N H_out
    W_out Cout k k Cin over the f32 FFMA peak (f32) or the bf16
    tensor-core peak (bf16), bytes = input + output + weights + bias once;
    the f32 lines, whose kernels all multiply as three TF32 products
    (3xTF32), also give the bound at that rate (three times the FLOPs
    over the TF32 peak).
    Library yardstick (never called by the port's kernels' wrappers): one
    torch.nn.functional.conv2d with bias on the NCHW tensor, plus the
    activation, in contiguous and in channels_last memory format; the
    faster of the two is reported and named. It pads (k - 1) / 2 on each
    side where A puts a 5x5's or 7x7's whole pad on the top / left: the
    same work on shifted outputs."""
    from vocal_remover_tpu_torch.nn import (
        conv_chw,
        conv_chw_kernel,
        conv_shift_kernel,
        conv_tapdot_kernel,
    )
    from vocal_remover_tpu_torch.scripts import conv_kernel_lab as lab

    rng = np.random.default_rng(seed)
    rows = []
    for label, n, cin, cout, h, w, k, stride, variants in chw_conv_cases():
        wk = (rng.standard_normal((k, k, cin, cout))
              / np.sqrt(k * k * cin)).astype(np.float32)
        b = torch.from_numpy(
            (0.1 * rng.standard_normal(cout)).astype(np.float32)).cuda()
        x32 = torch.from_numpy(
            rng.standard_normal((n, cin, h, w), dtype=np.float32)).cuda()
        h_out, w_out = h // stride, w // stride
        flops = 2 * n * h_out * w_out * cout * k * k * cin
        big = n * cin * h * w >= 1 << 24
        for dtype, tname in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            x = x32.to(dtype)
            if label == "unaligned":  # a view one element into its storage
                x = torch.zeros(x.numel() + 1, dtype=dtype,
                                device="cuda")[1:].view(x.shape).copy_(x)
                check(x.is_contiguous() and x.data_ptr() % 16 != 0,
                      "unaligned case: the input is aligned")
            size = x.element_size()
            n_bytes = size * (x.numel() + n * cout * h_out * w_out
                              + wk.size) + 4 * cout
            peak = PEAK_F32_FLOPS if dtype == torch.float32 \
                else PEAK_BF16_FLOPS
            t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, flops / peak * 1e3
            wl = torch.from_numpy(wk).cuda().to(dtype).permute(3, 2, 0, 1)
            formats = {"contiguous": torch.contiguous_format,
                       "channels_last": torch.channels_last}
            lib = {}
            with torch.inference_mode():
                for fname, fmt in formats.items():
                    xc, wc = x.contiguous(memory_format=fmt), \
                        wl.contiguous(memory_format=fmt)
                    lib[fname] = cuda_ms(
                        lambda: torch.nn.functional.leaky_relu(
                            torch.nn.functional.conv2d(
                                xc, wc, b.to(dtype), stride, (k - 1) // 2),
                            0.01), 10 if big else 50)
                    del xc, wc
            lib_fmt = min(lib, key=lib.get)
            for v in variants:
                if v == "A":
                    name = "conv_chw"
                    if stride == 2:
                        xin = conv_chw.space_to_depth(x).contiguous()
                        w2, taps, pad = conv_chw.prepare_weights_s2(wk)
                    else:
                        xin = x
                        w2, taps, pad = conv_chw.prepare_weights_s1(wk)
                    args = (xin, torch.from_numpy(w2).cuda().to(dtype), b,
                            taps, pad, conv_chw.pad_origin(pad),
                            "leaky_relu", dtype)
                    kernel = lambda: conv_chw_kernel.conv_call(*args)
                    plain = lambda: conv_chw_kernel.conv_call_plain(*args)
                else:
                    name, mod, wfn = {
                        "C": ("conv_shift", conv_shift_kernel, lab.weights_c),
                        "D": ("conv_tapdot", conv_tapdot_kernel,
                              lab.weights_d)}[v]
                    w2 = wfn(wk, dtype).cuda()
                    kw = dict(act="leaky_relu", out_dtype=dtype)
                    kernel = lambda: getattr(mod, name)(x, w2, b, **kw)
                    plain = lambda: getattr(mod, name + "_plain")(
                        x, w2, b, **kw)
                out = kernel()
                torch.cuda.synchronize()
                ref = plain()
                check(out.shape == ref.shape == (n, cout, h_out, w_out)
                      and out.dtype == dtype, f"{name} {label} {tname}: "
                      f"output {tuple(out.shape)} {out.dtype}")
                err = (out.float() - ref.float()).abs().max().item()
                tol = 1e-4 if dtype == torch.float32 else \
                    2.0 ** -7 * ref.float().abs().max().item()
                check(err <= tol, f"{name} {label} {tname}: max abs err "
                                  f"{err} > {tol}")
                del out, ref
                ms = cuda_ms(kernel, 10 if big else 50)
                plain_ms = cuda_ms(plain, 3, 1)
                row = {
                    "name": name, "label": label, "dtype": tname,
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": lib[lib_fmt], "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                }
                rows.append(row)
                tf32 = ""
                if dtype == torch.float32:
                    tf32 = (f"; 3xTF32 rate "
                            f"{max(t_bytes, 3e3 * flops / PEAK_TF32_FLOPS):.4f}"
                            " ms")
                print(f"[kernel] {name} {label} {tname} x{(n, cin, h, w)} "
                      f"{k}x{k} s{stride} -> {cout}ch: max_abs_err {err:.3g} "
                      f"(tol {tol:.3g}), kernel {ms:.4f} ms, plain "
                      f"{plain_ms:.4f} ms, conv2d {lib_fmt} "
                      f"{lib[lib_fmt]:.4f} ms (contiguous "
                      f"{lib['contiguous']:.4f}, channels_last "
                      f"{lib['channels_last']:.4f}), bound "
                      f"{row['bound_ms']:.4f} ms ({row['bound_by']}; "
                      f"{flops / 1e9:.3f} GFLOP, {n_bytes / 1e6:.2f} MB"
                      f"{tf32}); {share(row)}", flush=True)
            del x
        del x32
        torch.cuda.empty_cache()
    return rows


LAB_LEN, LAB_REPEAT = 4, 2


def phase_lab(counters):
    """This slice's path at full width: the port's two conv tools at
    their default shapes and dtype (bf16), chains cut to LAB_LEN layers
    and LAB_REPEAT timed repeats. Each tool checks or times what it
    prints; here the launch counts are held to what the flags imply: a
    chain runs once to warm up and LAB_REPEAT times on the clock, and
    the lab checks one single layer per variant first."""
    from vocal_remover_tpu_torch.scripts import bench_conv_kernel, conv_kernel_lab

    for wrapper in counters.values():
        wrapper.launches = 0
    flags = ["--len", str(LAB_LEN), "--repeat", str(LAB_REPEAT)]
    said = io.StringIO()
    try:  # the tools' own lines, each behind the phase's tag
        with contextlib.redirect_stdout(said):
            lab_rows = conv_kernel_lab.main(flags)
            bench_rows = bench_conv_kernel.main(flags)
    finally:
        for line in said.getvalue().splitlines():
            print(f"[lab] {line}", flush=True)
    torch.cuda.synchronize()
    launches = {k: wrapper.launches for k, wrapper in counters.items()}
    chains = LAB_LEN * (1 + LAB_REPEAT)
    want = {"conv_chw": len(LAB_SHAPES) * (1 + chains + chains),
            "conv_shift": len(LAB_SHAPES) * (1 + chains),
            "conv_tapdot": len(LAB_SHAPES) * (1 + chains)}
    for k, n in launches.items():
        check(n == want.get(k, 0), f"lab path: {k} launched {n} times, want "
                                   f"{want.get(k, 0)}")
    check(len(lab_rows) == 3 * len(LAB_SHAPES)
          and len(bench_rows) == 4 * len(LAB_SHAPES),
          f"lab path: {len(lab_rows)} lab rows, {len(bench_rows)} bench rows")
    for r in lab_rows + bench_rows:
        check(np.isfinite(r["ms"]) and r["ms"] > 0, f"lab path: {r}")
    print(f"[lab] conv_kernel_lab + bench_conv_kernel {' '.join(flags)} at "
          f"their default shapes in bfloat16: launches {launches}", flush=True)
    return launches


def synth_song(seconds: float, seed: int) -> np.ndarray:
    """Stereo test song: a few tones, a vibrato voice-like partial series
    and noise, at about -10 dBFS."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * seconds)) / SR
    voice = sum(np.sin(2 * np.pi * k * 220 * (t + 0.002 * np.sin(
        2 * np.pi * 5 * t))) / k for k in range(1, 6))
    bass = np.sin(2 * np.pi * 55 * t)
    left = 0.12 * voice + 0.1 * bass + 0.03 * rng.standard_normal(t.size)
    right = 0.12 * voice + 0.08 * np.sin(2 * np.pi * 330 * t) \
        + 0.03 * rng.standard_normal(t.size)
    return np.stack([left, right]).astype(np.float32)


def kernel_summary(kernels):
    """(device busy us: the union of the kernels' intervals, {kernel name:
    (us, launches)})."""
    busy, last = 0.0, float("-inf")
    for start, end in sorted((k.time_range.start, k.time_range.end)
                             for k in kernels):
        busy += max(0.0, end - max(start, last))
        last = max(last, end)
    by_name = {}
    for k in kernels:
        t, n = by_name.get(k.name, (0.0, 0))
        by_name[k.name] = (t + k.time_range.elapsed_us(), n + 1)
    return busy, by_name


def device_kernels(prof):
    """The device kernels of a torch.profiler run (CPU ops and the
    profiler's own buffer activities also carry device time)."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.name not in ("Buffer Flush", "Activity Buffer Request")]


# a kernel's device symbol carries its entry function's name
KERNEL_SYMBOLS = {"flat_conv": "flat_conv_mma",
                  "lstm_recurrence": "lstm_recurrence_kernel"}


def run_cli(argv, counters):
    """One CLI run with every kernel wrapper's `launches` count reset just
    before and read just after; -> (wall seconds, {kernel: launches})."""
    from vocal_remover_tpu_torch.cli import inference as cli

    for wrapper in counters.values():
        wrapper.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return wall, {k: wrapper.launches for k, wrapper in counters.items()}


def read_stems(out_dir, name):
    """A song's two stems as int32 PCM16 values, checked to be 16-bit
    PCM at SR."""
    from vocal_remover_tpu_torch.utils import audio

    stems = []
    for stem in ("Instruments", "Vocals"):
        path = os.path.join(out_dir, f"{name}_{stem}.wav")
        with wav_io.open(path, "rb") as f:
            check(f.getsampwidth() == 2, f"{path}: {8 * f.getsampwidth()}"
                                         "-bit samples, want 16")
        w, sr = audio.read_wav(path)
        check(sr == SR, f"{stem}: sample rate {sr}")
        stems.append(np.round(w * 32768.0).astype(np.int32))
    return stems


def read_mix(path):
    from vocal_remover_tpu_torch.utils import audio

    return np.round(audio.read_wav(path)[0] * 32768.0).astype(np.int32)


def residual_lsb(y, v, mix) -> int:
    """|Instruments + Vocals - mixture| on the samples the iSTFT covers
    (hop * (length // hop))."""
    n_cov = 1024 * (mix.shape[-1] // 1024)
    return int(np.abs(y + v - mix)[:, :n_cov].max())


def snr_db(ref, test) -> float:
    num = float(np.sum(ref.astype(np.float64) ** 2))
    den = float(np.sum((ref - test).astype(np.float64) ** 2))
    return float("inf") if den == 0 else 10.0 * np.log10(num / den)


# the three paths of the CLI that this script drives: flags, the runs of
# each, and which kernels the path goes through
PATHS = {
    "plain": {"flags": [], "runs": ("first", "warm", "tta"),
              "kernels": ("lstm_recurrence",)},
    "flat": {"flags": ["--flat_conv"], "runs": ("first", "warm", "tta"),
             "kernels": ("lstm_recurrence", "flat_conv")},
    "flat_bf16": {"flags": ["--flat_conv", "--precision", "bfloat16"],
                  "runs": ("first", "warm"),
                  "kernels": ("lstm_recurrence", "flat_conv")},
}


def check_cast_walks(model):
    """A packed flagship moved to the card and cast to bf16 as a whole
    module (nn.Module.to) carries, on every FlatLayer, the walk that
    block_table gives for its cast wst, and a float32 bias."""
    from vocal_remover_tpu_torch.models import serving
    from vocal_remover_tpu_torch.models.base_net import FlatLayer
    from vocal_remover_tpu_torch.nn import flat_conv_kernel as fk

    packed = serving.serving_variables(model, None, flat=True)
    packed = packed.to("cuda").to(torch.bfloat16)
    layers = [m for m in packed.modules() if isinstance(m, FlatLayer)]
    check(len(layers) == 20, f"packed flagship has {len(layers)} flat layers")
    for lay in layers:
        check(lay.wst.dtype == torch.bfloat16 and lay.bias.dtype ==
              torch.float32 and lay.blocks.is_cuda and torch.equal(
                  lay.blocks, fk.block_table(lay.wst, lay.s_list)),
              "a FlatLayer cast to bf16 kept a walk made for another wst")
    print(f"[main] packed flagship .to('cuda').to(bfloat16): all "
          f"{len(layers)} FlatLayers carry block_table(wst) at the bf16 "
          "tile", flush=True)
    del packed


def phase_main_path(tmp, seed, counters, per_chunk):
    from vocal_remover_tpu_torch.models import convert
    from vocal_remover_tpu_torch.models.cascaded import (
        CascadedNet,
        param_count,
    )
    from vocal_remover_tpu_torch.ops import stft as stft_ops
    from vocal_remover_tpu_torch.ops.windowing import make_padding, num_patches
    from vocal_remover_tpu_torch.utils import audio

    model = CascadedNet(2048, 1024, 32, 128,
                        generator=torch.Generator().manual_seed(seed))
    n_params = param_count(model)
    check(n_params == FLAGSHIP_PARAMS, f"flagship has {n_params} params")
    check_cast_walks(model)
    ckpt = os.path.join(tmp, "flagship.vrt.npz")
    convert.save_native(ckpt, convert.to_jax_variables(model),
                        convert.model_config(model))
    song = os.path.join(tmp, "song.wav")
    audio.write_wav(song, synth_song(SONG_SECONDS, seed), SR)
    mix = np.round(audio.read_wav(song)[0] * 32768.0).astype(np.int32)
    print(f"[main] flagship CascadedNet(2048, 1024, 32, 128): {n_params} "
          f"params, {SONG_SECONDS} s stereo {SR} Hz song", flush=True)

    # chunks of 4 patches for the 30 s-bucketed song, without / with TTA
    n_frame = stft_ops.num_frames(mix.shape[-1], 2048, 1024)
    pad_l, pad_r, roi = make_padding(n_frame, 256, 64)

    def chunks(extra):
        n = num_patches(pad_l + n_frame + pad_r + 2 * extra, roi, 64)
        return -(-n // 4)

    want = {False: chunks(0), True: chunks(0) + chunks(roi // 2)}
    out_dir = os.path.join(tmp, "out")
    results, stems = {}, {}
    for path, spec in PATHS.items():
        argv = ["-P", ckpt, "-i", song, "-o", out_dir] + spec["flags"]
        # the card must not run a conv in TF32 on the f32 paths: start
        # every path from the library's defaults, so that what the CLI
        # sets is what is tested
        torch.backends.cudnn.allow_tf32 = True
        for label in spec["runs"]:
            tta = label == "tta"
            wall, launches = run_cli(argv + (["--tta"] if tta else []),
                                     counters)
            y, v = read_stems(out_dir, "song")
            check(y.shape == v.shape == mix.shape, f"{path} {label}: stem "
                  f"shape {y.shape} vs {mix.shape}")
            n_cov = 1024 * (mix.shape[-1] // 1024)  # samples the iSTFT covers
            resid = int(np.abs(y + v - mix)[:, :n_cov].max())
            tail = int(np.abs(np.concatenate([y, v])[:, n_cov:]).max(initial=0))
            check(resid <= 2, f"{path} {label}: |Instruments + Vocals - "
                              f"mixture| = {resid} LSB > 2")
            check(tail == 0, f"{path} {label}: uncovered tail is not silent")
            for k, n in launches.items():
                expect = per_chunk[k] * want[tta] if k in spec["kernels"] else 0
                check(n == expect, f"{path} {label}: {k} launched {n} times, "
                                   f"want {expect} ({want[tta]} chunks)")
            results[path, label] = {"wall_s": wall, "launches": launches}
            stems[path, label] = (y, v)
            line = (f"[main] {path} {label}: {wall:.3f} s wall, "
                    f"{SONG_SECONDS / wall:.2f} x real time, launches "
                    f"{launches} ({want[tta]} chunks), residual {resid} LSB on "
                    f"the {n_cov} covered samples, {mix.shape[-1] - n_cov} "
                    "uncovered tail samples silent")
            if path == "flat":  # f32 throughout: the plain path's stems
                ref = stems["plain", "tta" if tta else "warm"]
                diff = max(int(np.abs(a - b).max()) for a, b in zip(ref, (y, v)))
                check(diff <= 1, f"flat {label}: stems differ from the plain "
                                 f"path's by {diff} LSB > 1")
                line += f"; vs plain path max {diff} LSB (tol 1)"
            if path == "flat_bf16":
                snr = [snr_db(a, b)
                       for a, b in zip(stems["flat", "warm"], (y, v))]
                check(min(snr) >= BF16_SNR_FLOOR_DB,
                      f"bf16 {label}: stem SNR {snr} dB against highest, "
                      f"floor {BF16_SNR_FLOOR_DB}")
                line += (f"; SNR vs highest: Instruments {snr[0]:.2f} dB, "
                         f"Vocals {snr[1]:.2f} dB (floor {BF16_SNR_FLOOR_DB})")
            print(line, flush=True)
        if "flat_conv" in spec["kernels"]:
            # the flat conv's own kernel time over a whole song: one more
            # warm run under the profiler, every launch summed
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                _, launches = run_cli(argv, counters)
            mine = [e for e in device_kernels(prof)
                    if KERNEL_SYMBOLS["flat_conv"] in e.name]
            ms = sum(e.time_range.elapsed_us() for e in mine) / 1e3
            expect = per_chunk["flat_conv"] * want[False]
            check(len(mine) == launches["flat_conv"] == expect,
                  f"{path} profiled: {len(mine)} flat_conv kernels traced, "
                  f"{launches['flat_conv']} counted, want {expect}")
            results[path, "flat_conv_song_ms"] = ms
            print(f"[main] {path}: flat_conv kernel time over the song's "
                  f"{len(mine)} launches {ms:.3f} ms ({ms / len(mine):.4f} "
                  "ms a launch; torch.profiler, one more warm run)",
                  flush=True)
            # the trace holds millions of objects: left alive, the garbage
            # collector's full passes over it land in the next path's timed
            # stages (a second and more each); free it here, untimed
            del prof, mine
            gc.collect()
    return ckpt, results


def phase_reference(tmp, ckpt, seed):
    """The same CLI on a 4 s song on the card and on the CPU."""
    from vocal_remover_tpu_torch.cli import inference as cli
    from vocal_remover_tpu_torch.utils import audio

    song = os.path.join(tmp, "short.wav")
    audio.write_wav(song, synth_song(4.0, seed + 1), SR)
    for path in ("plain", "flat"):
        stems = {}
        for gpu in ("0", "-1"):
            out_dir = os.path.join(tmp, f"ref-{path}{gpu}")
            cli.main(["-P", ckpt, "-i", song, "-o", out_dir, "--gpu", gpu,
                      "--exact_length"] + PATHS[path]["flags"])
            stems[gpu] = read_stems(out_dir, "short")
        diff = max(int(np.abs(a - b).max())
                   for a, b in zip(stems["0"], stems["-1"]))
        check(diff <= 1, f"{path}: card vs CPU stems differ by {diff} LSB > 1")
        print(f"[reference] {path}: 4 s song, card vs CPU (plain versions of "
              f"the kernels): max {diff} LSB (tol 1)", flush=True)


# directory mode: eight 60 s songs (one full group of 8 at the CLI's
# defaults) and a 45 s and a 95 s song (30 s buckets of 60 and 120 s:
# each runs alone)
DIR_SECONDS = (60,) * 8 + (45, 95)
DIR_BATCHES = (tuple(range(8)), (8,), (9,))  # the service's dispatches
DIR_CROP, DIR_BATCH = 1024, 24  # the CLI's directory-mode defaults


def patch_count(n_samples: int, crop: int, extra: int = 0) -> int:
    """Patches of a song of n_samples at `crop` (flagship STFT, offset
    64), its padding widened by `extra` frames a side (TTA's shift)."""
    from vocal_remover_tpu_torch.ops import stft as stft_ops
    from vocal_remover_tpu_torch.ops.windowing import make_padding, num_patches

    n_frame = stft_ops.num_frames(n_samples, 2048, 1024)
    pad_l, pad_r, roi = make_padding(n_frame, crop, 64)
    return num_patches(pad_l + n_frame + pad_r + 2 * extra, roi, 64)


def alone_stems(ckpt, precision, paths, crop, batch):
    """Each song through `Separator.separate_wave` (30 s bucket), built as
    the CLI builds its model; vocals as the directory mode makes them,
    clip(mixture - instruments). -> [(instruments, vocals)] a song."""
    from vocal_remover_tpu_torch.models import convert, serving
    from vocal_remover_tpu_torch.separate.separator import Separator
    from vocal_remover_tpu_torch.utils import audio

    model = convert.load_model(ckpt, 2048, 1024)
    if precision == "bfloat16":
        model = serving.serving_variables(model, "bfloat16")
    sp = Separator(model, batchsize=batch, cropsize=crop, device="cuda",
                   precision=precision)
    stems = []
    for path in paths:
        y, _ = sp.separate_wave(audio.load(path, sr=SR)[0], pcm16_io=True,
                                bucket=30 * SR, only_instruments=True)
        y = y.astype(np.int32)
        stems.append((y, np.clip(read_mix(path) - y, -32768, 32767)))
    return stems


def quiet(fn, *args):
    """fn(*args) with its standard output kept off the log; -> (result,
    the CLI's stage lines as one string)."""
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        result = fn(*args)
    stages = [line.strip() for line in said.getvalue().splitlines()
              if line.startswith("  ")]
    return result, "; ".join(stages)


def phase_dir(tmp, ckpt, seed, counters, per_chunk):
    """Directory mode through the CLI at its defaults (bf16, crop 1024,
    batch 24, group 8): first, warm and profiled; then with --flat_conv
    and with --precision highest. Every run's launch counts, stems and
    residual are checked; every song against the same song alone;
    the same songs one by one through the single-file bf16 path beside
    it."""
    from torch.profiler import ProfilerActivity, profile

    from vocal_remover_tpu_torch.cli import inference as cli
    from vocal_remover_tpu_torch.utils import audio

    song_dir = os.path.join(tmp, "songs")
    os.makedirs(song_dir)
    names = [f"song{i:02d}" for i in range(len(DIR_SECONDS))]
    paths = [os.path.join(song_dir, f"{n}.wav") for n in names]
    for i, (path, sec) in enumerate(zip(paths, DIR_SECONDS)):
        audio.write_wav(path, synth_song(sec, seed + 10 + i), SR)
    mixes = [read_mix(path) for path in paths]
    total_s = sum(m.shape[-1] for m in mixes) / SR
    bucket = 30 * SR
    padded = [-(-m.shape[-1] // bucket) * bucket for m in mixes]
    chunks = sum(-(-len(b) * patch_count(padded[b[0]], DIR_CROP) // DIR_BATCH)
                 for b in DIR_BATCHES)
    print(f"[dir] {len(paths)} songs, {total_s:.0f} s of audio "
          f"({'/'.join(str(s) for s in DIR_SECONDS)} s); directory defaults "
          f"crop {DIR_CROP}, batch {DIR_BATCH}, group 8: dispatches "
          f"{[len(b) for b in DIR_BATCHES]} songs, {chunks} chunks",
          flush=True)

    def run(label, flags, kernels):
        out_dir = os.path.join(tmp, f"dir-{label}")
        argv = ["-P", ckpt, "--input_dir", song_dir, "-o", out_dir] + flags
        torch.cuda.reset_peak_memory_stats()
        (wall, launches), stages = quiet(run_cli, argv, counters)
        peak = torch.cuda.max_memory_allocated()
        for k, n in launches.items():
            want = per_chunk[k] * chunks if k in kernels else 0
            check(n == want, f"dir {label}: {k} launched {n} times, want "
                             f"{want} ({chunks} chunks)")
        worst = 0
        for name, mix in zip(names, mixes):
            y, v = read_stems(out_dir, name)
            check(y.shape == v.shape == mix.shape,
                  f"dir {label} {name}: stem shape {y.shape} vs {mix.shape}")
            worst = max(worst, residual_lsb(y, v, mix))
        check(worst <= 2, f"dir {label}: |Instruments + Vocals - mixture| "
                          f"= {worst} LSB > 2")
        print(f"[dir] {label}: {wall:.3f} s wall, {total_s / wall:.2f} x real "
              f"time, {len(paths) / wall:.3f} songs/s, launches {launches}, "
              f"peak device memory {peak / 2**30:.2f} GiB, residual <= "
              f"{worst} LSB on every song; CLI stages: {stages}", flush=True)
        return out_dir, wall

    def profiled(label, flags, kernels):
        """One more warm run under torch.profiler: busy share, top
        kernels."""
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, wall = run(f"{label} profiled", flags, kernels)
        busy, by_name = kernel_summary(device_kernels(prof))
        total = sum(t for t, _ in by_name.values())
        n_kernels = sum(n for _, n in by_name.values())
        print(f"[dir] {label} profiled: {n_kernels} kernel launches, kernel "
              f"time {total / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms "
              f"= {100 * busy / 1e6 / wall:.1f}% of the {wall:.3f} s wall",
              flush=True)
        for kname, (t, n) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:8]:
            print(f"[dir]   {t / 1e3:9.2f} ms {n:6d}x  {kname[:100]}",
                  flush=True)
        del prof, by_name
        gc.collect()  # the trace, outside the next run's timings

    rec = ("lstm_recurrence",)
    run("bf16 first", [], rec)
    bf16_dir, wall = run("bf16 warm", [], rec)
    profiled("bf16", [], rec)
    run("flat bf16", ["--flat_conv"], ("lstm_recurrence", "flat_conv"))
    highest_dir, _ = run("highest", ["--precision", "highest"], rec)
    profiled("highest", ["--precision", "highest"], rec)

    # songs 0-7 ran as one group of 8, 8 and 9 alone: each against the
    # same song alone
    for precision, out_dir in (("bfloat16", bf16_dir), ("highest", highest_dir)):
        alone = alone_stems(ckpt, precision, paths, DIR_CROP, DIR_BATCH)
        diff, snr = 0, [np.inf, np.inf]
        for name, ref in zip(names, alone):
            grouped = read_stems(out_dir, name)
            d = max(int(np.abs(a - b).max()) for a, b in zip(grouped, ref))
            song_snr = [snr_db(a, b) for a, b in zip(ref, grouped)]
            if precision == "highest":
                check(d <= 1, f"dir highest {name}: grouped vs alone {d} LSB "
                              "> 1")
            else:
                check(min(song_snr) >= BF16_SNR_FLOOR_DB, f"dir bf16 {name}: "
                      f"grouped vs alone SNR {song_snr} dB, floor "
                      f"{BF16_SNR_FLOOR_DB}")
            diff, snr = max(diff, d), [min(a, b) for a, b in zip(snr, song_snr)]
        print(f"[dir] {precision}: all {len(names)} songs from the directory "
              "run vs the same song alone (Separator.separate_wave, same "
              f"crop, batch, precision): max {diff} LSB, least SNR "
              f"Instruments {snr[0]:.2f} dB, Vocals {snr[1]:.2f} dB",
              flush=True)

    # beside it: the same songs one by one through the single-file path
    out_dir = os.path.join(tmp, "dir-single")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for path in paths:
        quiet(cli.main, ["-P", ckpt, "-i", path, "-o", out_dir,
                         "--precision", "bfloat16"])
    torch.cuda.synchronize()
    single = time.perf_counter() - t0
    print(f"[dir] the same {len(paths)} songs one by one through the "
          f"single-file bf16 path (crop 256, batch 4): {single:.3f} s wall, "
          f"{total_s / single:.2f} x real time, {len(paths) / single:.3f} "
          f"songs/s; directory mode warm {single / wall:.2f}x faster",
          flush=True)
    return {"song_dir": song_dir, "names": names, "mixes": mixes,
            "chunks": chunks, "bf16_dir": bf16_dir}


STREAM_SECONDS = 150  # two streamed segments plus a tail
STREAM_OWNED = 34  # the CLI's batch 4: owned patches a segment, 36 with the halo


def stream_chunks(n_samples: int):
    """(segments, 4-patch chunks) of a streamed song at the flagship STFT
    (roi 128)."""
    from vocal_remover_tpu_torch.ops import stft as stft_ops

    n_frame = stft_ops.num_frames(n_samples, 2048, 1024)
    n_seg = -(-(-(-n_frame // 128) * 128) // (STREAM_OWNED * 128))
    return n_seg, n_seg * (STREAM_OWNED + 2) // 4


def phase_stream(tmp, ckpt, seed, counters, per_chunk):
    """`-i --stream` on a 150 s song against the monolithic path with
    --exact_length (highest, with and without TTA), then --postprocess
    and bf16, each with its launch counts, residual and xRT."""
    from vocal_remover_tpu_torch.ops import stft as stft_ops
    from vocal_remover_tpu_torch.utils import audio

    song = os.path.join(tmp, "long.wav")
    audio.write_wav(song, synth_song(STREAM_SECONDS, seed + 3), SR)
    mix = read_mix(song)
    n = mix.shape[-1]
    n_seg, seg_chunks = stream_chunks(n)
    k_own, roi = STREAM_OWNED, 128
    n_frame = stft_ops.num_frames(n, 2048, 1024)
    mono = {False: -(-patch_count(n, 256) // 4),
            True: -(-patch_count(n, 256) // 4)
            + -(-patch_count(n, 256, roi // 2) // 4)}
    natural = 1024 * (n_frame - 1)
    runs = [("stream", ["--stream"], seg_chunks),
            ("mono", ["--exact_length"], mono[False]),
            ("stream tta", ["--stream", "--tta"], 2 * seg_chunks),
            ("mono tta", ["--tta", "--exact_length"], mono[True]),
            # the model runs in the mask phase only
            ("stream postprocess", ["--stream", "--postprocess"], seg_chunks),
            ("stream bf16", ["--stream", "--precision", "bfloat16"],
             seg_chunks)]
    print(f"[stream] {STREAM_SECONDS} s song: {n_seg} segments of "
          f"{k_own + 2} patches ({seg_chunks} chunks of 4)", flush=True)
    stems = {}
    for label, flags, chunks in runs:
        out_dir = os.path.join(tmp, label.replace(" ", "-"))
        (wall, launches), stages = quiet(
            run_cli, ["-P", ckpt, "-i", song, "-o", out_dir] + flags, counters)
        for k, got in launches.items():
            want = per_chunk[k] * chunks if k == "lstm_recurrence" else 0
            check(got == want, f"stream {label}: {k} launched {got} times, "
                               f"want {want} ({chunks} chunks)")
        y, v = stems[label] = read_stems(out_dir, "long")
        check(y.shape == v.shape == mix.shape,
              f"stream {label}: stem shape {y.shape}")
        resid = residual_lsb(y, v, mix)
        check(resid <= 2, f"stream {label}: |Instruments + Vocals - "
                          f"mixture| = {resid} LSB > 2")
        line = (f"[stream] {label}: {wall:.3f} s wall, "
                f"{STREAM_SECONDS / wall:.2f} x real time, launches "
                f"{launches}, residual {resid} LSB; CLI stages: {stages}")
        if label.startswith("mono"):
            # the streamed vocals past the iSTFT's natural length are the
            # mixture (vocals by residual), the monolithic path's zeros
            y_s, v_s = stems[label.replace("mono", "stream")]
            diff = max(int(np.abs(y - y_s).max()),
                       int(np.abs(v - v_s)[:, :natural].max()))
            check(diff <= 1, f"stream vs {label}: {diff} LSB > 1")
            line += f"; streamed stems vs this: max {diff} LSB (tol 1)"
        if label == "stream bf16":
            snr = [snr_db(a, b) for a, b in zip(stems["stream"], (y, v))]
            check(min(snr) >= BF16_SNR_FLOOR_DB, f"stream bf16: SNR {snr} "
                  f"dB against highest, floor {BF16_SNR_FLOOR_DB}")
            line += (f"; SNR vs highest: Instruments {snr[0]:.2f} dB, "
                     f"Vocals {snr[1]:.2f} dB")
        print(line, flush=True)



# the spectrogram path's stems against --stream --postprocess's: the
# bound the port's CPU test holds the same pair to (JAX's 4e-4 of full
# scale = 13.1 LSB, plus the PCM16 rounding of both stems)
SPEC_VS_STREAM_LSB = 14


def read_png(path):
    """(height, width, channels) uint8 pixels of a PNG that the port's
    stdlib writer made (8-bit, filter 0 on every row)."""
    with open(path, "rb") as f:
        data = f.read()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path}: not a PNG")
    width, height, depth, ctype = struct.unpack(">IIBB", data[16:26])
    check(depth == 8 and ctype in (0, 2, 6), f"{path}: depth {depth}, "
                                             f"colour type {ctype}")
    channels = {0: 1, 2: 3, 6: 4}[ctype]
    idat, pos = b"", 8
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += n + 12
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        height, 1 + width * channels)
    check(not rows[:, 0].any(), f"{path}: a row filter other than 0")
    return rows[:, 1:].reshape(height, width, channels)


@contextlib.contextmanager
def pil_hidden():
    """PIL unimportable inside the block: the CLI's stdlib PNG writer
    takes over from it."""
    saved = sys.modules.get("PIL")
    sys.modules["PIL"] = None
    try:
        yield
    finally:
        if saved is None:
            del sys.modules["PIL"]
        else:
            sys.modules["PIL"] = saved


def read_image(path):
    """(height, width, channels) pixels of the CLI's image: a PNG by this
    script's reader, a JPEG (PIL present) by PIL."""
    if path.endswith(".png"):
        return read_png(path)
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im)


def phase_spec(tmp, ckpt, seed, counters, per_chunk, smi):
    """The spectrogram path (host STFT, `Separator.separate` /
    `separate_tta` with masks on the card, host iSTFT) through the CLI on
    the main path's 60 s song: --output_image against the device
    pipeline with --exact_length (JPEGs when PIL is installed, then PNGs
    with PIL hidden), --postprocess (with and without TTA)
    against --stream --postprocess, bf16 + --flat_conv, a .pth of the
    same weights, FLAC input and --profile."""
    from vocal_remover_tpu_torch.models import convert
    from vocal_remover_tpu_torch.utils import flac

    song = os.path.join(tmp, "song.wav")
    mix = read_mix(song)
    n = mix.shape[-1]
    n_cov = 1024 * (n // 1024)  # the spectrogram path's stem length
    chunks = {False: -(-patch_count(n, 256) // 4),
              True: -(-patch_count(n, 256) // 4)
              + -(-patch_count(n, 256, 64) // 4)}
    _, seg_chunks = stream_chunks(n)

    pth = os.path.join(tmp, "flagship.pth")
    torch.save(convert.load_model(ckpt, 2048, 1024).state_dict(), pth)
    flac_song = os.path.join(tmp, "song.flac")
    t0 = time.perf_counter()
    flac.write_flac(flac_song, mix / 32768.0, SR)
    print(f"[spec] {SONG_SECONDS} s song as 16-bit FLAC (utils/flac.py): "
          f"{os.path.getsize(flac_song)} bytes in "
          f"{time.perf_counter() - t0:.2f} s; flagship as .pth "
          f"(torch.save of the state_dict): {os.path.getsize(pth)} bytes",
          flush=True)
    trace_dir = os.path.join(tmp, "spec-trace")
    pp = ["--postprocess"]
    # label, checkpoint, input, flags, kernels, model chunks
    runs = [
        ("pipeline exact", ckpt, song, ["--exact_length"],
         ("lstm_recurrence",), chunks[False]),
        ("image", ckpt, song, ["--output_image"], ("lstm_recurrence",),
         chunks[False]),
        ("image png", ckpt, song, ["--output_image"], ("lstm_recurrence",),
         chunks[False]),
        ("postprocess", ckpt, song, pp, ("lstm_recurrence",), chunks[False]),
        ("postprocess tta", ckpt, song, pp + ["--tta"], ("lstm_recurrence",),
         chunks[True]),
        ("stream postprocess", ckpt, song, pp + ["--stream"],
         ("lstm_recurrence",), seg_chunks),
        ("stream postprocess tta", ckpt, song, pp + ["--stream", "--tta"],
         ("lstm_recurrence",), 2 * seg_chunks),
        ("postprocess flat bf16", ckpt, song,
         pp + ["--flat_conv", "--precision", "bfloat16"],
         ("lstm_recurrence", "flat_conv"), chunks[False]),
        ("pth", pth, song, pp, ("lstm_recurrence",), chunks[False]),
        ("flac", ckpt, flac_song, pp, ("lstm_recurrence",), chunks[False]),
        ("profile", ckpt, song, pp + ["--profile", trace_dir],
         ("lstm_recurrence",), chunks[False]),
    ]
    stems = {}
    for label, model, src, flags, kernels, n_chunks in runs:
        out_dir = os.path.join(tmp, "spec-" + label.replace(" ", "-"))
        torch.cuda.reset_peak_memory_stats()
        with pil_hidden() if label == "image png" else contextlib.nullcontext():
            (wall, launches), stages = quiet(
                run_cli, ["-P", model, "-i", src, "-o", out_dir] + flags,
                counters)
        peak = torch.cuda.max_memory_allocated()
        for k, got in launches.items():
            want = per_chunk[k] * n_chunks if k in kernels else 0
            check(got == want, f"spec {label}: {k} launched {got} times, "
                               f"want {want} ({n_chunks} chunks)")
        y, v = stems[label] = read_stems(out_dir, "song")
        spectrogram = "--stream" not in flags and label != "pipeline exact"
        want_len = n_cov if spectrogram else n
        check(y.shape == v.shape == (2, want_len),
              f"spec {label}: stem shape {y.shape}, want (2, {want_len})")
        resid = residual_lsb(y[:, :n_cov], v[:, :n_cov], mix[:, :n_cov])
        check(resid <= 2, f"spec {label}: |Instruments + Vocals - mixture| "
                          f"= {resid} LSB > 2")
        line = (f"[spec] {label}: {wall:.3f} s wall, CLI stages: {stages}; "
                f"launches {launches} ({n_chunks} chunks); residual {resid} "
                f"LSB; peak device memory {peak / 2**30:.2f} GiB; {smi}")
        if spectrogram:
            walls = dict(
                (part.rsplit(": ", 1)[0], float(part.rsplit(": ", 1)[1][:-1]))
                for part in stages.split("; ") if part.endswith("s"))
            host = sum(t for k, t in walls.items()
                       if k == "stft" or k.startswith("istft"))
            line += (f"; host STFT + iSTFT + writes {host:.2f} s = "
                     f"{100 * host / wall:.1f}% of wall")
        if label.startswith("image"):
            ref = stems["pipeline exact"]
            diff = max(int(np.abs(a - b[:, :n_cov]).max())
                       for a, b in zip((y, v), ref))
            check(diff <= 1, f"spec {label}: stems vs the device pipeline "
                             f"(--exact_length) {diff} LSB > 1")
            line += f"; vs the device pipeline (--exact_length) max {diff} LSB"
            png = label == "image png" or importlib.util.find_spec(
                "PIL") is None
            ext, other = (".png", ".jpg") if png else (".jpg", ".png")
            for stem in ("Instruments", "Vocals"):
                path = os.path.join(out_dir, f"song_{stem}{ext}")
                check(os.path.exists(path) and not os.path.exists(
                    path[:-4] + other), f"spec {label}: no {path} alone")
                img = read_image(path)
                check(img.shape == (1025, n_cov // 1024 + 1, 3),
                      f"spec {label}: {stem} image {img.shape}")
                check(img.min() != img.max(),
                      f"spec {label}: {stem} image constant")
                line += f"; {stem}{ext} {img.shape}"
        if label.startswith("stream postprocess"):
            ref = stems[label.replace("stream ", "")]
            diff = max(int(np.abs(a[:, :n_cov] - b).max())
                       for a, b in zip((y, v), ref))
            check(diff <= SPEC_VS_STREAM_LSB,
                  f"spec {label}: vs the spectrogram path {diff} LSB > "
                  f"{SPEC_VS_STREAM_LSB}")
            line += (f"; vs the spectrogram path max {diff} LSB (tol "
                     f"{SPEC_VS_STREAM_LSB})")
        if label == "postprocess flat bf16":
            snr = [snr_db(a, b) for a, b in zip(stems["postprocess"], (y, v))]
            check(min(snr) >= BF16_SNR_FLOOR_DB, f"spec {label}: SNR {snr} "
                  f"dB against highest, floor {BF16_SNR_FLOOR_DB}")
            line += (f"; SNR vs highest: Instruments {snr[0]:.2f} dB, "
                     f"Vocals {snr[1]:.2f} dB")
        if label in ("pth", "flac"):
            same = all(np.array_equal(a, b)
                       for a, b in zip(stems["postprocess"], (y, v)))
            check(same, f"spec {label}: stems differ from the .vrt.npz WAV "
                        "run's")
            line += "; bit-identical to the .vrt.npz WAV run"
        if label == "profile":
            traces = os.listdir(trace_dir)
            check(len(traces) == 1, f"spec profile: {traces} in {trace_dir}")
            with open(os.path.join(trace_dir, traces[0])) as f:
                text = f.read()
            check(KERNEL_SYMBOLS["lstm_recurrence"] in text,
                  "spec profile: the trace does not name the recurrence "
                  "kernel")
            line += (f"; trace {traces[0]}, {len(text)} bytes, names "
                     f"{KERNEL_SYMBOLS['lstm_recurrence']}")
        print(line, flush=True)


EXPORT_PRECISIONS = ("bfloat16", "highest")  # the export CLI's default first
EXPORT_CROPS = (256, 1024)
# one chunk of masks of the card's artifact against the same file on the
# CPU, in highest (the port's forward against JAX's on the CPU: 5e-5)
CROSS_DEVICE_TOL = 5e-5


def phase_export(tmp, ckpt, seed, counters, per_chunk, smi, dir_run):
    """The export slice: the flagship checkpoint through the export CLI
    on the card in bf16 and highest at crops 256 and 1024; the
    recurrence op checked on the card; the 60 s song through `-P
    model.vrtx` (first, warm) against the `.vrt.npz` run at the same
    precision; the 1024 entry at batch 24; [dir]'s songs through
    --input_dir on the bf16 artifact against [dir]'s `.vrt.npz` stems;
    the card's file loaded on the CPU, and the card's programs moved
    there. -> the warm artifact runs' launches, by precision."""
    from vocal_remover_tpu_torch.cli import export as export_cli
    from vocal_remover_tpu_torch.nn import lstm_kernel
    from vocal_remover_tpu_torch.separate import artifact

    arts = {}
    for prec in EXPORT_PRECISIONS:
        path = os.path.join(tmp, f"flagship-{prec}.vrtx")
        t0 = time.perf_counter()
        quiet(export_cli.main, [ckpt, path, "--precision", prec,
                                "--cropsizes",
                                ",".join(map(str, EXPORT_CROPS))])
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        am = artifact.load_artifact(path, device="cuda")
        for crop in EXPORT_CROPS:
            am.program(crop)
        load_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        check(am.meta["precision"] == prec and am.meta["platforms"] ==
              ["cuda"] and am.cropsizes == list(EXPORT_CROPS),
              f"export {prec}: meta {am.meta}")
        arts[prec] = (path, am)
        print(f"[export] {prec}: export CLI on the card {export_s:.2f} s "
              f"(crops {list(EXPORT_CROPS)}, batch symbolic), file {size} "
              f"bytes ({size / 2**20:.1f} MiB, weights "
              f"{am.meta['weights_dtype']}), load_artifact + both entries "
              f"onto the card {load_s:.2f} s; torch "
              f"{am.meta['torch_version']}; {smi}", flush=True)

    op = torch.ops.vocal_remover_tpu_torch.lstm_recurrence.default
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    for t_len, two_n, hidden in ((128, 8, 64), (512, 48, 64)):
        xg = torch.randn(t_len, two_n, 4 * hidden, device="cuda",
                         generator=gen)
        w_hh = torch.randn(2, hidden, 4 * hidden, device="cuda",
                           generator=gen) / hidden ** 0.5
        w_cols = lstm_kernel.relayout(w_hh)
        torch.library.opcheck(op, (xg, w_cols),
                              test_utils=("test_schema", "test_faketensor"))
        out = op(xg, w_cols)
        torch.cuda.synchronize()
        err = (out - lstm_kernel.recurrence_plain(xg, w_hh)).abs().max().item()
        check(err <= 2e-5, f"op T={t_len}: max abs err {err} > 2e-5")
        print(f"[export] op vocal_remover_tpu_torch::lstm_recurrence on the "
              f"card: opcheck (schema, fake tensor) passed; T={t_len} "
              f"2N={two_n} H={hidden} vs recurrence_plain max_abs_err "
              f"{err:.3g} (tol 2e-5)", flush=True)

    song = os.path.join(tmp, "song.wav")
    mix = read_mix(song)

    def serve(label, model, src, flags, n_chunks, names=("song",)):
        """One CLI run, from the library's TF32 default as [main] does
        (what the artifact sets is what is tested); launch counts,
        stems' shape and residual checked. -> (wall, launches, stages,
        peak GiB, {name: stems})."""
        out_dir = os.path.join(tmp, "export-" + label.replace(" ", "-"))
        torch.backends.cudnn.allow_tf32 = True
        torch.cuda.reset_peak_memory_stats()
        src_flag = "--input_dir" if os.path.isdir(src) else "-i"
        (wall, launches), stages = quiet(
            run_cli, ["-P", model, src_flag, src, "-o", out_dir] + flags,
            counters)
        peak = torch.cuda.max_memory_allocated() / 2**30
        for k, got in launches.items():
            want = per_chunk[k] * n_chunks if k == "lstm_recurrence" else 0
            check(got == want, f"export {label}: {k} launched {got} times, "
                               f"want {want} ({n_chunks} chunks)")
        stems = {}
        for name in names:
            y, v = stems[name] = read_stems(out_dir, name)
            ref = read_mix(os.path.join(src, f"{name}.wav")
                           if os.path.isdir(src) else src)
            check(y.shape == v.shape == ref.shape,
                  f"export {label} {name}: stem shape {y.shape}")
            resid = residual_lsb(y, v, ref)
            check(resid <= 2, f"export {label} {name}: |Instruments + "
                              f"Vocals - mixture| = {resid} LSB > 2")
        return wall, launches, stages, peak, stems

    def lsb(a, b):
        return max(int(np.abs(x - y).max()) for x, y in zip(a, b))

    chunks = -(-patch_count(mix.shape[-1], 256) // 4)
    warm = {}
    for prec in EXPORT_PRECISIONS:
        path = arts[prec][0]
        w0, _, st0, _, ref = serve(f"npz {prec}", ckpt, song,
                                   ["--precision", prec], chunks)
        for run in ("first", "warm"):
            # no --precision: the artifact runs in its own mode
            w, launches, st, peak, got = serve(f"vrtx {prec} {run}", path,
                                               song, [], chunks)
            d = lsb(got["song"], ref["song"])
            check(d <= 1, f"export {prec} {run}: stems vs the .vrt.npz run "
                          f"{d} LSB > 1")
            warm[prec] = launches
            print(f"[export] {prec} -P flagship-{prec}.vrtx {run}: {w:.3f} s "
                  f"wall ({SONG_SECONDS / w:.2f} x real time; stages {st}), "
                  f".vrt.npz --precision {prec} {w0:.3f} s (stages {st0}); "
                  f"launches {launches} ({chunks} chunks); vs the .vrt.npz "
                  f"run max {d} LSB (tol 1); peak device memory {peak:.2f} "
                  f"GiB", flush=True)

    wide = ["--cropsize", "1024", "--batchsize", "24"]
    n_wide = -(-patch_count(mix.shape[-1], 1024) // 24)
    w0, _, _, _, ref = serve("npz 1024", ckpt, song, wide, n_wide)
    w, launches, st, peak, got = serve("vrtx 1024", arts["highest"][0], song,
                                       wide, n_wide)
    d = lsb(got["song"], ref["song"])
    check(d <= 1, f"export crop 1024: stems vs the .vrt.npz run {d} LSB > 1")
    print(f"[export] highest -P flagship-highest.vrtx {' '.join(wide)}: "
          f"{w:.3f} s wall (stages {st}), .vrt.npz {w0:.3f} s; launches "
          f"{launches} ({n_wide} chunk); vs the .vrt.npz run max {d} LSB "
          f"(tol 1); peak device memory {peak:.2f} GiB", flush=True)

    names = dir_run["names"]
    w, launches, st, peak, got = serve(
        "vrtx dir", arts["bfloat16"][0], dir_run["song_dir"], [],
        dir_run["chunks"], names)
    d = max(lsb(got[name], read_stems(dir_run["bf16_dir"], name))
            for name in names)
    check(d == 0, f"export dir: stems vs [dir]'s .vrt.npz run {d} LSB > 0")
    print(f"[export] bf16 artifact --input_dir ({len(names)} songs, "
          f"directory defaults): {w:.3f} s wall (stages {st}); launches "
          f"{launches} ({dir_run['chunks']} chunks); every song vs [dir]'s "
          f".vrt.npz run max {d} LSB (tol 0); peak device memory "
          f"{peak:.2f} GiB", flush=True)

    path, am = arts["highest"]
    x = torch.rand(4, 2, 1025, 256,
                   generator=torch.Generator().manual_seed(seed + 8))
    with torch.inference_mode():
        card = am(x.cuda()).cpu()
        t0 = time.perf_counter()
        loaded = artifact.load_artifact(path, device="cpu")(x)
        cpu_s = time.perf_counter() - t0
        moved = am.to("cpu")(x)  # the card's programs moved back
    err = [(card - m).abs().max().item() for m in (loaded, moved)]
    check(max(err) <= CROSS_DEVICE_TOL, f"export cross-device: card vs CPU "
          f"masks max abs err {err} > {CROSS_DEVICE_TOL}")
    print(f"[export] flagship-highest.vrtx written on the card: one chunk of "
          f"masks (4, 2, 1025, 256) on the card vs the file loaded on the "
          f"CPU (load + chunk {cpu_s:.2f} s) max_abs_err {err[0]:.3g}, vs "
          f"the card's programs moved to the CPU {err[1]:.3g} (tol "
          f"{CROSS_DEVICE_TOL})", flush=True)
    del arts, am
    gc.collect()
    return warm


def phase_profile(ckpt, seed):
    """Device time by kernel name for one warm 60 s separation on each
    path."""
    from torch.profiler import ProfilerActivity, profile

    from vocal_remover_tpu_torch.models import convert, serving
    from vocal_remover_tpu_torch.separate.separator import Separator

    wave = synth_song(SONG_SECONDS, seed)
    for path, spec in PATHS.items():
        model = convert.load_model(ckpt, 2048, 1024)
        bf16 = "bfloat16" in spec["flags"]
        if path != "plain":
            model = serving.serving_variables(
                model, "bfloat16" if bf16 else None, flat=True)
        sp = Separator(model, device="cuda",
                       precision="bfloat16" if bf16 else "highest")
        sp.separate_wave(wave, pcm16_io=True, bucket=30 * SR)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sp.separate_wave(wave, pcm16_io=True, bucket=30 * SR)
        torch.cuda.synchronize()
        wall_off = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sp.separate_wave(wave, pcm16_io=True, bucket=30 * SR)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = device_kernels(prof)
        busy, by_name = kernel_summary(kernels)
        total = sum(t for t, _ in by_name.values())
        print(f"[profile] {path}: warm 60 s separation {wall_off:.3f} s wall "
              f"with the profiler off, {wall:.3f} s with it on, "
              f"{len(kernels)} kernel launches, kernel time "
              f"{total / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms = "
              f"{100 * busy / 1e6 / wall:.1f}% of wall", flush=True)
        for k, sym in KERNEL_SYMBOLS.items():
            t = sum(v[0] for name, v in by_name.items() if sym in name)
            n = sum(v[1] for name, v in by_name.items() if sym in name)
            print(f"[profile] {path}: {k} {t / 1e3:.2f} ms in {n} launches"
                  f" = {100 * t / total:.1f}% of kernel time", flush=True)
        for kname, (t, n) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:12]:
            print(f"[profile]   {t / 1e3:9.2f} ms {n:7d}x  {kname[:100]}",
                  flush=True)
        del sp, model, prof, kernels
        gc.collect()  # the trace, outside the next path's timings


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--profile", action="store_true")
    args = p.parse_args()

    if not torch.cuda.is_available():
        fail("no CUDA device")
    try:
        from vocal_remover_tpu_torch.nn import (
            config,
            conv_chw_kernel,
            conv_shift_kernel,
            conv_tapdot_kernel,
            flat_conv_kernel,
            lstm_kernel,
        )
    except ImportError as e:
        fail(f"the port's package is not beside this script ({e})")

    # every kernel of the port (name = its csrc/ source): the wrapper
    # module holding its `launches` count, and its launches per 4-patch
    # chunk of the CLI's paths (5 band nets x 1 BiLSTM; 5 band nets x 4
    # packed convs; none for the three channel-major conv kernels, which
    # no model path reaches: the lab path drives them)
    kernels = [{
        "name": "lstm_recurrence",
        "route": "cuda",
        "source": "vocal_remover_tpu_torch/csrc/lstm_recurrence.cu",
        "replaces": "vocal_remover_tpu/nn/lstm_pallas.py:75",
        "wrapper": lstm_kernel,
        "per_chunk": 5,
    }, {
        "name": "flat_conv",
        "route": "cuda",
        "source": "vocal_remover_tpu_torch/csrc/flat_conv.cu",
        "replaces": "vocal_remover_tpu/nn/conv_pack.py:171",
        "wrapper": flat_conv_kernel,
        "per_chunk": 20,
    }, {
        "name": "conv_chw",
        "route": "cuda",
        "source": "vocal_remover_tpu_torch/csrc/conv_chw.cu",
        "replaces": "vocal_remover_tpu/nn/conv_pallas.py:115",
        "wrapper": conv_chw_kernel,
        "per_chunk": 0,
    }, {
        "name": "conv_shift",
        "route": "cuda",
        "source": "vocal_remover_tpu_torch/csrc/conv_shift.cu",
        "replaces": "scripts/conv_kernel_lab.py:70",
        "wrapper": conv_shift_kernel,
        "per_chunk": 0,
    }, {
        "name": "conv_tapdot",
        "route": "cuda",
        "source": "vocal_remover_tpu_torch/csrc/conv_tapdot.cu",
        "replaces": "scripts/conv_kernel_lab.py:178",
        "wrapper": conv_tapdot_kernel,
        "per_chunk": 0,
    }]
    counters = {k["name"]: k["wrapper"] for k in kernels}

    name, smi = phase_card()
    config.set_precision("highest")
    phase_build(kernels)
    phase_native_build()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rec_rows = phase_recurrence(gen)
    flat_rows = phase_flat_conv(args.seed)
    torch.cuda.empty_cache()
    chw_rows = phase_chw_convs(args.seed)

    with tempfile.TemporaryDirectory() as tmp:
        per_chunk = {k["name"]: k["per_chunk"] for k in kernels}
        ckpt, results = phase_main_path(tmp, args.seed, counters, per_chunk)
        phase_reference(tmp, ckpt, args.seed)
        phase_spec(tmp, ckpt, args.seed, counters, per_chunk, smi)
        dir_run = phase_dir(tmp, ckpt, args.seed, counters, per_chunk)
        phase_stream(tmp, ckpt, args.seed, counters, per_chunk)
        export_launches = phase_export(tmp, ckpt, args.seed, counters,
                                       per_chunk, smi, dir_run)
        if args.profile:
            phase_profile(ckpt, args.seed)
    lab_launches = phase_lab(counters)

    # one record per kernel. The two kernels of the model: launches of
    # the recurrence on this slice's path (-P model.vrtx, the highest
    # artifact's warm run) and of the flat conv on the --flat_conv path
    # (warm run), largest error over the f32 cases, times at the
    # flagship's largest launch (recurrence T = 128, 2N = 8, H = 64; flat
    # conv stg3_full_band_net enc2_conv2 in f32). The three channel-major
    # conv kernels: launches on the lab path, error and times at the
    # lab's first shape in its default dtype (bf16).
    launches = dict(results["flat", "warm"]["launches"])
    launches["lstm_recurrence"] = export_launches["highest"]["lstm_recurrence"]
    shown = {
        "lstm_recurrence": (rec_rows[0], rec_rows),
        "flat_conv": (
            next(r for r in flat_rows
                 if r["label"] == "stg3_full enc2_conv2" and r["dtype"] == "f32"),
            [r for r in flat_rows if r["dtype"] == "f32"]),
    }
    for kname in ("conv_chw", "conv_shift", "conv_tapdot"):
        mine = [r for r in chw_rows
                if r["name"] == kname and r["dtype"] == "bf16"]
        shown[kname] = (next(r for r in mine if r["label"] == "lab 32ch"),
                        mine)
        launches[kname] = lab_launches[kname]
    record = [{
        "name": k["name"], "route": k["route"], "source": k["source"],
        "replaces": k["replaces"],
        "launches": launches[k["name"]],
        "max_abs_err": max(r["max_abs_err"] for r in shown[k["name"]][1]),
        "ms": shown[k["name"]][0]["ms"],
        "plain_ms": shown[k["name"]][0]["plain_ms"],
        "bound_ms": shown[k["name"]][0]["bound_ms"],
        "bound_by": shown[k["name"]][0]["bound_by"],
        "library_ms": shown[k["name"]][0]["library_ms"],
    } for k in kernels]
    print(json.dumps({"kernels": record}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
