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
     ragged channel blocks), 1x1 and 7x7; the int8 conv (conv_int8) at
     every distinct geometry of one chunk of the int8 flagship at crop
     256, batch 4 and at crop 1024, batch 24, on the activations the
     chunk hands it, held to its plain version bit for bit (bf16 and f32
     out, dynamic and static scales), beside the bf16 conv2d of the same
     conv and torch._int_mm on its im2col, timed with dynamic and with
     static scales, with a profiled chunk splitting its two passes;
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
  5b. spectrogram path ([spec]): a 10 s song through the CLI's host
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
  7. streaming ([stream]): a 110 s song with -i --stream in highest
     against the monolithic --exact_length stems (1 LSB), the same with
     --tta, --stream --postprocess and --stream in bf16, each with its
     launch counts, residual and xRT;
  7a. int8 serving ([int8]): the 60 s song through the CLI with
     --precision int8 (first, warm, warm again and --tta, in turns with
     --precision bfloat16): conv_int8 97 launches a chunk, recurrence 5,
     residual, SNR against the highest stems (INT8_SNR_FLOOR_DB) and the
     bf16 stems, warm xRT beside bf16's; the calibrated static path
     (Separator on a model whose a_scale came from two chunks of the
     song); --input_dir on [dir]'s songs and --stream on [stream]'s song
     in int8, each song held to the same mode's bf16 stems by SNR
     (dynamic scales depend on which patches share a chunk, so not by
     LSB); a 4 s song on the card and on the CPU (max LSB and SNR);
  7b. export ([export]): the flagship checkpoint through the export CLI
     on the card in bfloat16 and highest at crops 256 and 1024 (export
     seconds, file size, load seconds); the recurrence's custom op under
     torch.library.opcheck and against its plain version on the card;
     the 60 s song through -P model.vrtx once, in both
     precisions: 30 recurrence launches a run, stems within 1 LSB of the
     .vrt.npz run at the same precision, walls side by side; the 1024
     entry at batch 24 against the .vrt.npz run (1 LSB); [dir]'s songs
     through --input_dir on the bf16 artifact against [dir]'s .vrt.npz
     stems (0 LSB); the file written on the card loaded on the CPU, and
     the card's programs moved to the CPU: one chunk of masks each
     against the card's (CROSS_DEVICE_TOL);
  7c. training ([train]): four seeded 20 s stereo songs (instrumental stem
     plus a voice-like partial series) through the training CLI on the
     card at its full width and defaults (-C 256 -B 4 -v 0.25, -p 4,
     highest), one epoch, then a second with --resume: every loss finite,
     the recurrence kernel launched 5 x validation chunks a validation
     and never in the train step (the plain loop under autograd); the
     best checkpoint separates a 10 s song through the inference CLI
     (residual 2 LSB); compute_grads of CascadedNet(256, 128, 8, 16) in
     float64 card vs CPU (GRAD_RTOL) and one batch's full-width train-mode
     loss in float32 card vs CPU (TRAIN_LOSS_RTOL); then the warm step
     time and samples/s, peak memory, the plain recurrence's forward +
     backward share of the step (alone, and the step's wall with it
     replaced by its forward kernel and zero gradients), validation ms a
     patch, an epoch from the loader with the steps' wait on it, and one
     profiled step (busy share, launches, top kernels). The rest
     of training: the state of the first run's last epoch written as the
     JAX package's train_state.msgpack by the port's writer (seconds,
     size; read back, parameters equal to the .pt's bit for bit) and
     cli.train --resume from it for one epoch; cli.train -E 1 with each
     of --remat, --precision bfloat16, --transfer_dtype int8,
     --device_data_cache (highest) and --device_data_cache --precision
     default (finite losses, the recurrence kernel 5 x validation chunks
     and never in the step); remat on the card (float64 compute_grads of
     CascadedNet(256, 128, 8, 16) with dropout and the aux head, with vs
     without remat, and every BN buffer and parameter after two steps,
     GRAD_RTOL); then beside the plain step of the run: the remat step and
     peak at batch 4 and at batch BIG_BATCH, the bf16 step, samples/s,
     peak and one batch's loss gap, int8 staging's bytes a step, loader
     wait and step, and the device-resident dataset in float32 and bf16
     (resident MB, bytes uploaded a step, loader wait, step, validation
     ms a patch; the first float32 batch equal to the host path's bit for
     bit); then the complex-mask run: cli.train --is_complex --wave_loss sdr, one epoch
     at the same defaults on the same songs (finite losses, the
     recurrence kernel 5 x validation chunks and never in the step), its
     checkpoint through cli.evaluate on the card, compute_grads of the
     complex CascadedNet(256, 128, 8, 16) with the wave term in float64
     card vs CPU (GRAD_RTOL), and the warm complex step without and with
     the wave term beside the magnitude step (ms, samples/s, peak);
  7c'. library ([library], after [train], on its songs and caches): the
     native host kernels (load_crop_abs at full width against numpy's
     |z| / coef: the share of values that differ and ms a crop each way;
     pcm16_encode / pcm16_decode round trip on [main]'s instruments stem;
     quantize_u8 against the numpy quantizer byte for byte);
     make_training_set / make_validation_set(progress=); one epoch of the
     flagship through Loader(epoch_multiplier=2, drop_last=True,
     prefetch=3) and Trainer(prefetch=3), then a fresh Trainer(prefetch=0)
     from the same weights and seed (host batches bit for bit, losses
     within LIB_LOSS_RTOL); validate_epoch on a ValidationSet (the
     recurrence kernel 5 x chunks); DeviceLoader(drop_last=True) through
     train_epoch_device (its step count; its first batch the host
     loader's bit for bit); resize_bilinear(lerp2x=True) against the interp
     matrix at the decoders' input shapes (RESIZE_TOL), hann_window(float64)
     on the card; write_wav(subtype="FLOAT") read back exactly and
     load(mono=True, dtype=float64);
  7d. tools ([tools]): one seeded 10 s pair through cli.evaluate with
     the flagship checkpoint (the device pipeline first and warm, then
     --postprocess --tta: wall, xRT, peak memory, the mean metrics) and
     cli.pseudo (s a song, (2, 1025, T) complex64 outputs), the
     recurrence kernel held to 5 launches a chunk; a 4 s pair through
     both on the card and on the CPU at -B 2 (EVAL_CROSS_DB,
     PSEUDO_CROSS_TOL); on the host augment -p -1 on one pair (s a
     song), spec_debug and dataset_images (their WAVs and images
     checked), and plot_log on [train]'s loss log (the summary line, then
     the PNG, or where matplotlib cannot be imported a non-zero exit
     naming it);
  7e. parallel ([parallel], run between [train] and [tools]): this
     script again as `--parallel-child` under `python -m torch.distributed.run
     --standalone --nproc_per_node 1`, a world of one NCCL rank (the
     machine has one card): the 60 s song through cli.inference
     --data_parallel 0 (stems within 1 LSB of [main]'s plain run, 30
     recurrence launches, wall), two 15 s songs through --input_dir
     --data_parallel 0 against --group 1 without a mesh (1 LSB), one
     epoch of cli.train --data_parallel 0 at [train]'s settings on its
     songs (finite losses, recurrence 5 x validation chunks, none in the
     step), and float64 compute_grads of CascadedNet(256, 128, 8, 16) on
     a one-rank mesh against the same trainer without one (GRAD_RTOL of
     each leaf's max |g|);
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
import copy
import gc
import glob
import importlib.util
import io
import json
import os
import random
import shutil
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
    results["stems"], results["want"] = stems, want
    results["flat_bf16_warm_s"] = results["flat_bf16", "warm"]["wall_s"]
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


STREAM_SECONDS = 110  # two streamed segments, the second short
STREAM_OWNED = 34  # the CLI's batch 4: owned patches a segment, 36 with the halo


def stream_chunks(n_samples: int):
    """(segments, 4-patch chunks) of a streamed song at the flagship STFT
    (roi 128)."""
    from vocal_remover_tpu_torch.ops import stft as stft_ops

    n_frame = stft_ops.num_frames(n_samples, 2048, 1024)
    n_seg = -(-(-(-n_frame // 128) * 128) // (STREAM_OWNED * 128))
    return n_seg, n_seg * (STREAM_OWNED + 2) // 4


def phase_stream(tmp, ckpt, seed, counters, per_chunk):
    """`-i --stream` on a 110 s song against the monolithic path with
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


SPEC_SECONDS = 10  # [spec]'s song: the path, not the length, is the check


def phase_spec(tmp, ckpt, seed, counters, per_chunk, smi):
    """The spectrogram path (host STFT, `Separator.separate` /
    `separate_tta` with masks on the card, host iSTFT) through the CLI on
    a SPEC_SECONDS song: --output_image against the device
    pipeline with --exact_length (JPEGs when PIL is installed, then PNGs
    with PIL hidden), --postprocess (with and without TTA)
    against --stream --postprocess, bf16 + --flat_conv, a .pth of the
    same weights, FLAC input and --profile."""
    from vocal_remover_tpu_torch.models import convert
    from vocal_remover_tpu_torch.utils import flac

    from vocal_remover_tpu_torch.utils import audio

    song = os.path.join(tmp, "spec", "song.wav")
    os.makedirs(os.path.dirname(song))
    audio.write_wav(song, synth_song(SPEC_SECONDS, seed + 30), SR)
    mix = read_mix(song)
    n = mix.shape[-1]
    n_cov = 1024 * (n // 1024)  # the spectrogram path's stem length
    chunks = {False: -(-patch_count(n, 256) // 4),
              True: -(-patch_count(n, 256) // 4)
              + -(-patch_count(n, 256, 64) // 4)}
    _, seg_chunks = stream_chunks(n)

    pth = os.path.join(tmp, "flagship.pth")
    torch.save(convert.load_model(ckpt, 2048, 1024).state_dict(), pth)
    flac_song = os.path.join(tmp, "spec", "song.flac")
    t0 = time.perf_counter()
    flac.write_flac(flac_song, mix / 32768.0, SR)
    print(f"[spec] {SPEC_SECONDS} s song as 16-bit FLAC (utils/flac.py): "
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


PEAK_INT8_OPS = 1979e12  # dense int8 tensor-core peak
# int8 stems against the highest stems: JAX's int8 quality gate
# (tests/test_serving_transforms.py: mask and stem SNR >= 40 dB)
INT8_SNR_FLOOR_DB = 40.0
INT8_CROPS = ((256, 4), (1024, 24))  # single-song and directory chunks
INT8_PLAIN_PATCHES = 2  # patches a call of the plain version takes
INT_MM_ROWS = 1 << 22  # largest im2col row block timed by torch._int_mm


def int8_flagship(seed):
    """The flagship with random weights from `seed`, as the CLI's
    `--precision int8` makes it (fold, quantize with dynamic activation
    scales, bf16 for the rest), on the card."""
    from vocal_remover_tpu_torch.models import serving
    from vocal_remover_tpu_torch.models.cascaded import CascadedNet

    model = CascadedNet(2048, 1024, 32, 128,
                        generator=torch.Generator().manual_seed(seed))
    return serving.serving_variables(model, "int8").to("cuda")


def int_mm_ms(x, q, a_scale, stride, padding, dilation) -> float:
    """torch._int_mm of the conv's im2col matrix (int8 activations, made
    outside the clock, K and Cout padded to multiples of 8) with the int8
    weights. The matrix is made for the first patches that give at most
    INT_MM_ROWS rows (all of a crop-256 chunk), and their time is scaled
    to the whole batch."""
    from vocal_remover_tpu_torch.nn import conv_int8_kernel as ck

    cout, cin, kh, kw = q.shape
    (sh, sw), (ph, pw), (dh, dw) = stride, padding, dilation
    ho, wo = ck.out_size(x.shape, q.shape, stride, padding, dilation)
    nb = max(1, min(x.shape[0], INT_MM_ROWS // (ho * wo)))
    xq = ck.quantize_activation(x[:nb], a_scale)[0].to(torch.int8)
    xp = torch.nn.functional.pad(xq.permute(0, 2, 3, 1),
                                 (0, 0, pw, pw, ph, ph))  # NHWC, zero pad
    taps = [xp[:, dy * dh: dy * dh + sh * (ho - 1) + 1: sh,
               dx * dw: dx * dw + sw * (wo - 1) + 1: sw]
            for dy in range(kh) for dx in range(kw)]
    k = kh * kw * cin
    kp, np_ = -(-k // 8) * 8, -(-cout // 8) * 8
    a = torch.nn.functional.pad(torch.cat(taps, dim=-1).reshape(-1, k),
                                (0, kp - k)).contiguous()
    del taps, xp, xq
    b = torch.zeros(kp, np_, dtype=torch.int8, device=a.device)
    b[:k, :cout] = q.permute(2, 3, 1, 0).reshape(k, cout)
    return cuda_ms(lambda: torch._int_mm(a, b), 5, warmup=1) * x.shape[0] / nb


def phase_int8_kernel(model, seed):
    """conv_int8 against its plain version on the card at every distinct
    geometry of one chunk of the int8 flagship (crop 256, batch 4, the
    single-song defaults; crop 1024, batch 24, directory mode's), on the
    inputs the chunk hands each conv (bf16 activations). Tolerance 0: the
    sums are exact integers, so the kernel and the plain version agree
    bit for bit, in bf16 out as in f32 out. The kernel runs on the whole
    batch, with its dynamic scale and with that batch's scale given as a
    static one; the plain version takes the batch INT8_PLAIN_PATCHES
    patches at a time (its float64 copies of a batch-24 input do not fit
    beside the forward) at the scale of the whole batch, so every patch
    is held to it, and so is the kernel's scale. Times (CUDA events): the
    kernel (dynamic, as the model runs it, and static), the plain
    version, the bf16 conv2d (cuDNN) of the dequantized weights at the
    same shape (what int8 replaces; the library yardstick) and
    torch._int_mm on the im2col matrix; bound: the larger of the bytes
    (input, weights, scales and output once) over 3.35 TB/s and the
    useful int8 operations over 1,979 TOP/s. Per chunk: each geometry's
    numbers times its calls."""
    from vocal_remover_tpu_torch.nn import config
    from vocal_remover_tpu_torch.nn import conv_int8_kernel as ck
    from vocal_remover_tpu_torch.nn.layers import QConv2d

    gen = torch.Generator(device="cuda").manual_seed(seed)
    summary = {}
    for crop, batch in INT8_CROPS:
        rows = {}

        def measure(mod, args):
            x = args[0].contiguous()
            key = (tuple(x.shape), tuple(mod.q.shape), mod.stride, mod.pad,
                   mod.dilation)
            if key in rows:
                rows[key]["calls"] += 1
                return
            st, pd, dl = (ck._pair(v) for v in (mod.stride, mod.pad,
                                                 mod.dilation))

            def kernel(xin, dtype=torch.bfloat16, a_scale=mod.a_scale):
                return ck.conv2d_int8(xin, mod.q, mod.scale, a_scale,
                                      packed=mod.packed, stride=st,
                                      padding=pd, dilation=dl,
                                      out_dtype=dtype)

            def plain(xin, dtype, a_scale):
                return ck.conv2d_int8_plain(
                    xin, mod.q, mod.scale, a_scale, stride=st,
                    padding=pd, dilation=dl, out_dtype=dtype)

            slices = [slice(i, i + INT8_PLAIN_PATCHES)
                      for i in range(0, x.shape[0], INT8_PLAIN_PATCHES)]
            a_scale = mod.a_scale
            if a_scale is None:
                # quantize_activation's scale of the whole batch, from its
                # max |x| (exact in bf16), taken a slice at a time
                absmax = torch.stack([x[sl].abs().amax() for sl in slices])
                a_scale = ck.quantize_activation(absmax)[1]
            err = 0.0
            for dtype in (torch.bfloat16, torch.float32):
                got = (kernel(x, dtype), kernel(x, dtype, a_scale))
                for sl in slices:
                    want = plain(x[sl], dtype, a_scale)
                    torch.cuda.synchronize()
                    for g in got:
                        err = max(err, (g[sl].float() - want.float())
                                  .abs().max().item())
                    del want
                del got
            out = kernel(x)
            ms = cuda_ms(lambda: kernel(x), 10)
            ms_static = cuda_ms(lambda: kernel(x, a_scale=a_scale), 10)
            plain_ms = cuda_ms(lambda: plain(x[slices[0]], torch.bfloat16,
                                             a_scale), 1, warmup=0)
            w16 = (mod.q.float() * mod.scale.reshape(-1, 1, 1, 1)).bfloat16()
            lib_ms = cuda_ms(lambda: torch.nn.functional.conv2d(
                x, w16, None, st, pd, dl), 10)
            try:
                mm_ms = int_mm_ms(x, mod.q, a_scale, st, pd, dl)
            except RuntimeError as e:  # a shape _int_mm refuses
                mm_ms = float("nan")
                print(f"[kernel] conv_int8 {key}: torch._int_mm refused: "
                      f"{str(e).splitlines()[0][:120]}", flush=True)
            n, cin = x.shape[:2]
            cout, _, kh, kw = mod.q.shape
            ops = 2 * out.numel() * cin * kh * kw
            n_bytes = (x.numel() * x.element_size() + mod.q.numel()
                       + 4 * (cout + 1) + out.numel() * out.element_size())
            rows[key] = {"calls": 1, "err": err, "ms": ms,
                         "ms_static": ms_static,
                         "plain_ms": plain_ms * len(slices),
                         "library_ms": lib_ms, "int_mm_ms": mm_ms,
                         "t_bytes": n_bytes / PEAK_BYTES * 1e3,
                         "t_ops": ops / PEAK_INT8_OPS * 1e3}
            del out
            check(err == 0.0, f"conv_int8 {key}: max abs err {err} against "
                              "the plain version, want 0")

        hooks = [m.register_forward_pre_hook(measure) for m in model.modules()
                 if isinstance(m, QConv2d)]
        x = torch.rand(batch, 2, model.output_bin, crop, device="cuda",
                       generator=gen)
        try:
            with torch.inference_mode(), config.precision("bfloat16"):
                model(x)
        finally:
            for h in hooks:
                h.remove()
        # one more forward under the profiler: the kernel's two passes
        # and everything else a chunk launches
        from torch.profiler import ProfilerActivity, profile

        with torch.inference_mode(), config.precision("bfloat16"):
            model(x)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                model(x)
                torch.cuda.synchronize()
        busy, by_name = kernel_summary(device_kernels(prof))
        passes = {p: sum(t for name, (t, _) in by_name.items() if p in name)
                  for p in ("amax_partial", "conv_int8_tile")}
        total_us = sum(t for t, _ in by_name.values())
        print(f"[kernel] conv_int8 crop {crop} batch {batch}, one chunk's "
              f"forward profiled: kernel time {total_us / 1e3:.3f} ms, of it "
              + ", ".join(f"{p} {t / 1e3:.3f} ms" for p, t in passes.items())
              + f"; device busy {busy / 1e3:.3f} ms", flush=True)
        del x, prof, by_name
        torch.cuda.empty_cache()
        calls = sum(r["calls"] for r in rows.values())
        check(calls == 97, f"int8 chunk at crop {crop}: {calls} int8 convs, "
                           "want 97")
        tot = {k: sum(r[k] * r["calls"] for r in rows.values())
               for k in ("ms", "ms_static", "plain_ms", "library_ms",
                         "int_mm_ms", "t_bytes", "t_ops")}
        tot["bound_ms"] = sum(max(r["t_bytes"], r["t_ops"]) * r["calls"]
                              for r in rows.values())
        tot["bound_by"] = "bytes" if tot["t_bytes"] >= tot["t_ops"] \
            else "operations"
        tot["max_abs_err"] = max(r["err"] for r in rows.values())
        big = max(rows, key=lambda k: rows[k]["ms"] * rows[k]["calls"])
        for key, r in sorted(rows.items(), key=lambda kv: -kv[1]["ms"]
                             * kv[1]["calls"])[:6]:
            print(f"[kernel] conv_int8 crop {crop} batch {batch} x "
                  f"{key[0]} q {key[1]} stride {key[2]} pad {key[3]} "
                  f"dilation {key[4]} ({r['calls']} a chunk): kernel "
                  f"{r['ms']:.4f} ms (static {r['ms_static']:.4f}, "
                  f"{100 * max(r['t_bytes'], r['t_ops']) / r['ms']:.1f}% of "
                  f"bound), bound {max(r['t_bytes'], r['t_ops']):.4f}"
                  f" ms ({'bytes' if r['t_bytes'] >= r['t_ops'] else 'ops'}), "
                  f"plain {r['plain_ms']:.3f} ms, bf16 conv2d {r['library_ms']:.4f}"
                  f" ms, _int_mm {r['int_mm_ms']:.4f} ms", flush=True)
        print(f"[kernel] conv_int8 a chunk at crop {crop}, batch {batch} "
              f"({len(rows)} distinct geometries, {calls} convs; largest "
              f"{big[0]} -> {big[1][0]}): max_abs_err {tot['max_abs_err']} "
              f"(tol 0, bf16 and f32 out, dynamic and static scales, all "
              f"{batch} patches), kernel {tot['ms']:.3f} ms (static scales "
              f"{tot['ms_static']:.3f} ms), bound {tot['bound_ms']:.4f} ms "
              f"({tot['bound_by']}; bytes {tot['t_bytes']:.4f}, operations "
              f"{tot['t_ops']:.4f}), plain {tot['plain_ms']:.2f} ms, bf16 "
              f"conv2d (cuDNN) {tot['library_ms']:.3f} ms, torch._int_mm on "
              f"the im2col {tot['int_mm_ms']:.3f} ms; kernel "
              f"{100 * tot['bound_ms'] / tot['ms']:.1f}% of bound, "
              f"{tot['ms'] / tot['library_ms']:.2f}x the bf16 conv2d",
              flush=True)
        summary[crop] = tot
    return summary


def int8_calibrated(ckpt, song, counters, want):
    """The calibrated static path through the library: two chunks of the
    song's own patches (captured from a dynamic run) calibrate a_scale;
    the song then separates with static scales. -> (wall, launches,
    stems)."""
    from vocal_remover_tpu_torch.models import convert, serving
    from vocal_remover_tpu_torch.nn import config
    from vocal_remover_tpu_torch.nn.layers import QConv2d
    from vocal_remover_tpu_torch.separate.separator import Separator
    from vocal_remover_tpu_torch.utils import audio

    wave = audio.load(song, sr=SR)[0]
    f32 = convert.load_model(ckpt, 2048, 1024).to("cuda").eval()
    batches = []
    hook = f32.register_forward_pre_hook(
        lambda m, a: batches.append(a[0].clone()) if len(batches) < 2 else None)
    Separator(f32, batchsize=4, cropsize=256, device="cuda",
              precision="highest").separate_wave(wave, pcm16_io=True)
    hook.remove()
    t0 = time.perf_counter()
    with config.precision("highest"):
        static = serving.serving_variables(f32, "int8",
                                           calibration_batches=batches)
    cal_s = time.perf_counter() - t0
    qconvs = [m for m in static.modules() if isinstance(m, QConv2d)]
    check(len(qconvs) == 97 and all(m.a_scale is not None for m in qconvs),
          "calibrated int8 flagship: not every int8 conv has a static scale")
    sp = Separator(static, batchsize=4, cropsize=256, device="cuda",
                   precision="bfloat16")
    runs = []
    for _ in range(2):  # first, warm
        for wrapper in counters.values():
            wrapper.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, v = sp.separate_wave(wave, pcm16_io=True, bucket=30 * SR)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0,
                     {k: w.launches for k, w in counters.items()}))
    return cal_s, runs, (y.astype(np.int32), v.astype(np.int32))


def phase_int8(tmp, ckpt, seed, counters, per_chunk, main, dir_run):
    """--precision int8 through the CLI: the 60 s song (first, warm and
    --tta, each bf16 run beside it in turns), the calibrated static path,
    --input_dir on [dir]'s songs and --stream on [stream]'s song, a 4 s
    song on the card and on the CPU."""
    from vocal_remover_tpu_torch.cli import inference as cli
    from vocal_remover_tpu_torch.utils import audio

    phase_t0 = time.perf_counter()
    song = os.path.join(tmp, "song.wav")
    mix = read_mix(song)
    want, highest = main["want"], main["stems"]
    int8_k = ("lstm_recurrence", "conv_int8")

    def held(label, wall, launches, stems, kernels, chunks, mix, ref=None,
             floor=None, tag="[int8]"):
        """Launch counts, residual, SNR against `ref`; one line."""
        for k, n in launches.items():
            expect = per_chunk[k] * chunks if k in kernels else 0
            check(n == expect, f"int8 {label}: {k} launched {n} times, want "
                               f"{expect} ({chunks} chunks)")
        y, v = stems
        check(y.shape == v.shape == mix.shape, f"int8 {label}: stem shape")
        resid = residual_lsb(y, v, mix)
        check(resid <= 2, f"int8 {label}: |Instruments + Vocals - mixture| "
                          f"= {resid} LSB > 2")
        line = (f"{tag} {label}: {wall:.3f} s wall, launches {launches} "
                f"({chunks} chunks), residual {resid} LSB")
        if ref is not None:
            snr = [snr_db(a, b) for a, b in zip(ref, stems)]
            if floor is not None:
                check(min(snr) >= floor, f"int8 {label}: SNR {snr} dB, floor "
                                         f"{floor}")
            line += (f"; SNR Instruments {snr[0]:.2f} dB, Vocals "
                     f"{snr[1]:.2f} dB")
        return line

    out_dir = os.path.join(tmp, "int8-out")
    walls = {}
    for label, flags in (("bf16 first", ["--precision", "bfloat16"]),
                         ("int8 first", ["--precision", "int8"]),
                         ("bf16 warm", ["--precision", "bfloat16"]),
                         ("int8 warm", ["--precision", "int8"]),
                         ("int8 warm 2", ["--precision", "int8"]),
                         ("bf16 warm 2", ["--precision", "bfloat16"]),
                         ("int8 tta", ["--precision", "int8", "--tta"])):
        (wall, launches), stages = quiet(
            run_cli, ["-P", ckpt, "-i", song, "-o", out_dir] + flags,
            counters)
        tta = "tta" in label
        stems = read_stems(out_dir, "song")
        walls[label] = wall
        is8 = label.startswith("int8")
        line = held(label, wall, launches, stems,
                    int8_k if is8 else ("lstm_recurrence",), want[tta], mix,
                    highest["plain", "tta" if tta else "warm"],
                    INT8_SNR_FLOOR_DB if is8 else BF16_SNR_FLOOR_DB)
        print(f"{line} vs highest; {SONG_SECONDS / wall:.2f} x real time; "
              f"CLI stages: {stages}", flush=True)
        if label == "int8 warm":
            int8_warm, warm_launches = stems, launches["conv_int8"]
        if label == "bf16 warm":
            bf16_warm = stems
    snr = [snr_db(a, b) for a, b in zip(bf16_warm, int8_warm)]
    print(f"[int8] warm xRT: int8 {SONG_SECONDS / walls['int8 warm']:.2f} / "
          f"{SONG_SECONDS / walls['int8 warm 2']:.2f}, bf16 "
          f"{SONG_SECONDS / walls['bf16 warm']:.2f} / "
          f"{SONG_SECONDS / walls['bf16 warm 2']:.2f} (flat_bf16 warm "
          f"{SONG_SECONDS / main['flat_bf16_warm_s']:.2f} in [main]); int8 "
          f"stems vs bf16 stems: SNR {snr[0]:.2f} / {snr[1]:.2f} dB",
          flush=True)

    cal_s, runs, stems = int8_calibrated(ckpt, song, counters, want)
    for label, (wall, launches) in zip(("first", "warm"), runs):
        line = held(f"calibrated {label}", wall, launches, stems, int8_k,
                    want[False], mix, highest["plain", "warm"],
                    INT8_SNR_FLOOR_DB)
        print(f"{line} vs highest (Separator.separate_wave, static a_scale "
              f"from 2 chunks of the song, calibration {cal_s:.2f} s); "
              f"{SONG_SECONDS / wall:.2f} x real time", flush=True)

    # directory mode on [dir]'s songs, against its bf16 run
    names, mixes = dir_run["names"], dir_run["mixes"]
    d_out = os.path.join(tmp, "dir-int8")
    torch.cuda.reset_peak_memory_stats()
    (wall, launches), stages = quiet(
        run_cli, ["-P", ckpt, "--input_dir", dir_run["song_dir"], "-o", d_out,
                  "--precision", "int8"], counters)
    peak = torch.cuda.max_memory_allocated()
    least = [np.inf, np.inf]
    for name, m in zip(names, mixes):
        stems, ref = read_stems(d_out, name), read_stems(dir_run["bf16_dir"],
                                                          name)
        held(f"dir {name}", wall, launches, stems, int8_k, dir_run["chunks"],
             m, ref, INT8_SNR_FLOOR_DB)
        least = [min(a, snr_db(r, b)) for a, r, b in zip(least, ref, stems)]
    total_s = sum(m.shape[-1] for m in mixes) / SR
    print(f"[int8] --input_dir {len(names)} songs ({total_s:.0f} s): "
          f"{wall:.3f} s wall, {total_s / wall:.2f} x real time, launches "
          f"{launches} ({dir_run['chunks']} chunks), peak {peak / 2**30:.2f} "
          f"GiB, residual <= 2 LSB on every song, least SNR vs the bf16 "
          f"directory run Instruments {least[0]:.2f} dB, Vocals "
          f"{least[1]:.2f} dB (floor {INT8_SNR_FLOOR_DB}); CLI stages: "
          f"{stages}", flush=True)

    # streaming on [stream]'s song, against its bf16 stream
    long_song = os.path.join(tmp, "long.wav")
    _, seg_chunks = stream_chunks(read_mix(long_song).shape[-1])
    s_out = os.path.join(tmp, "stream-int8")
    (wall, launches), stages = quiet(
        run_cli, ["-P", ckpt, "-i", long_song, "-o", s_out, "--stream",
                  "--precision", "int8"], counters)
    line = held("stream", wall, launches, read_stems(s_out, "long"), int8_k,
                seg_chunks, read_mix(long_song),
                read_stems(os.path.join(tmp, "stream-bf16"), "long"),
                INT8_SNR_FLOOR_DB)
    print(f"{line} vs the bf16 stream; {STREAM_SECONDS / wall:.2f} x real "
          f"time; CLI stages: {stages}", flush=True)

    # card vs the port's CPU on a 4 s song
    short = os.path.join(tmp, "short.wav")
    stems = {}
    for gpu in ("0", "-1"):
        o = os.path.join(tmp, f"int8-ref{gpu}")
        quiet(cli.main, ["-P", ckpt, "-i", short, "-o", o, "--gpu", gpu,
                         "--exact_length", "--precision", "int8"])
        stems[gpu] = read_stems(o, "short")
    diff = max(int(np.abs(a - b).max()) for a, b in zip(stems["0"],
                                                        stems["-1"]))
    snr = [snr_db(a, b) for a, b in zip(stems["-1"], stems["0"])]
    print(f"[int8] 4 s song card vs CPU (the kernel vs its plain version, "
          f"cuDNN vs CPU bf16 around it): max {diff} LSB, SNR Instruments "
          f"{snr[0]:.2f} dB, Vocals {snr[1]:.2f} dB", flush=True)
    print(f"[int8] phase: {time.perf_counter() - phase_t0:.1f} s", flush=True)
    return warm_launches


EXPORT_PRECISIONS = ("bfloat16", "highest")  # the export CLI's default first
EXPORT_CROPS = (256, 1024)
# one chunk of masks of the card's artifact against the same file on the
# CPU, in highest (the port's forward against JAX's on the CPU: 5e-5)
CROSS_DEVICE_TOL = 5e-5


def phase_export(tmp, ckpt, seed, counters, per_chunk, smi, dir_run):
    """The export slice: the flagship checkpoint through the export CLI
    on the card in bf16 and highest at crops 256 and 1024; the
    recurrence op checked on the card; the 60 s song through `-P
    model.vrtx` (once) against the `.vrt.npz` run at the same
    precision; the 1024 entry at batch 24; [dir]'s songs through
    --input_dir on the bf16 artifact against [dir]'s `.vrt.npz` stems;
    the card's file loaded on the CPU, and the card's programs moved
    there."""
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
        # the highest artifact's entries serve the CPU checks below; the
        # bf16 one's are loaded by its -P runs (their `load model` stage)
        if prec == "highest":
            for crop in EXPORT_CROPS:
                am.program(crop)
        load_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        check(am.meta["precision"] == prec and am.meta["platforms"] ==
              ["cuda"] and am.cropsizes == list(EXPORT_CROPS),
              f"export {prec}: meta {am.meta}")
        arts[prec] = (path, am)
        loaded = ("load_artifact + both entries onto the card" if prec ==
                  "highest" else "load_artifact (its meta)")
        print(f"[export] {prec}: export CLI on the card {export_s:.2f} s "
              f"(crops {list(EXPORT_CROPS)}, batch symbolic), file {size} "
              f"bytes ({size / 2**20:.1f} MiB, weights "
              f"{am.meta['weights_dtype']}), {loaded} {load_s:.2f} s; torch "
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
    for prec in EXPORT_PRECISIONS:
        path = arts[prec][0]
        w0, _, st0, _, ref = serve(f"npz {prec}", ckpt, song,
                                   ["--precision", prec], chunks)
        # once (a warm repeat was dropped for time: the artifact's load
        # dominates either run); no --precision: it runs in its own mode
        w, launches, st, peak, got = serve(f"vrtx {prec}", path, song, [],
                                           chunks)
        d = lsb(got["song"], ref["song"])
        check(d <= 1, f"export {prec}: stems vs the .vrt.npz run {d} LSB > 1")
        print(f"[export] {prec} -P flagship-{prec}.vrtx: {w:.3f} s wall "
              f"({SONG_SECONDS / w:.2f} x real time; stages {st}), .vrt.npz "
              f"--precision {prec} {w0:.3f} s (stages {st0}); launches "
              f"{launches} ({chunks} chunks); vs the .vrt.npz run max {d} LSB "
              f"(tol 1); peak device memory {peak:.2f} GiB", flush=True)

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


TRAIN_SONGS = 4  # 3 train, 1 validation at -v 0.25
TRAIN_NFFT, TRAIN_HOP = 2048, 1024  # the training CLI's defaults
TRAIN_SECONDS = 20
TRAIN_PATCHES = 4  # -p: 12 items, 3 steps an epoch
TRAIN_ARGS = ["-C", "256", "-B", "4", "-p", str(TRAIN_PATCHES), "-v",
              "0.25"]
TRAIN_EPOCHS = 1  # then one more with --resume
TRAIN_BATCH = 4
VAL_BATCH = 4  # the CLI's default --val_batchsize
STEP_REPEAT = 2  # warm steps on the clock
# the CLI runs of this slice's flags, one epoch each at TRAIN_ARGS:
# (label, flags, the precision the run leaves the process in)
FLAG_RUNS = (
    ("remat", ["--remat"]),
    ("bf16", ["--precision", "bfloat16"]),
    ("int8", ["--transfer_dtype", "int8"]),
    ("device_cache", ["--device_data_cache"]),
    ("device_cache_default", ["--device_data_cache", "--precision",
                              "default"]),
)
# remat's own configuration: the plain step's peak passes half the card
BIG_BATCH = 8
BIG_STEPS = 2
# one batch's train-mode loss at full width, card vs CPU, float32
TRAIN_LOSS_RTOL = 1e-4
# compute_grads of the reduced model, card vs CPU, float64: each gradient
# leaf against its largest |g| (leaves that are zero in exact arithmetic
# against 1e-12 of the model's largest |g|), the loss relative
GRAD_RTOL = 1e-9
SMALL_NET = (256, 128, 8, 16)


def train_pair(seconds: float, seed: int):
    """(mixture, instrumental) stereo 44.1 kHz pair: the instrumental is
    bass, three chord tones and noise; the mixture adds a vibrato
    voice-like partial series that sings in phrases."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * seconds)) / SR
    f0 = rng.uniform(180.0, 300.0)
    voice = sum(np.sin(2 * np.pi * k * f0 * (t + 0.002 * np.sin(
        2 * np.pi * 5 * t))) / k for k in range(1, 6))
    voice = voice * (np.sin(2 * np.pi * 0.25 * t) > -0.3)
    bass = np.sin(2 * np.pi * rng.uniform(40.0, 80.0) * t)
    chord = sum(np.sin(2 * np.pi * f * t) for f in rng.uniform(200, 800, 3))
    inst = np.stack([0.1 * bass + 0.05 * chord, 0.1 * bass + 0.04 * chord])
    inst = inst + 0.02 * rng.standard_normal(inst.shape)
    mix = inst + 0.1 * np.stack([voice, 0.9 * voice])
    return mix.astype(np.float32), inst.astype(np.float32)


def write_train_songs(root, seed) -> str:
    """TRAIN_SONGS seeded pairs as root/dataset/{mixtures,instruments}/
    song<i>.wav; -> the dataset directory."""
    from vocal_remover_tpu_torch.utils import audio

    data = os.path.join(root, "dataset")
    for sub in ("mixtures", "instruments"):
        os.makedirs(os.path.join(data, sub))
    for i in range(TRAIN_SONGS):
        mix, inst = train_pair(TRAIN_SECONDS, seed + i)
        audio.write_wav(os.path.join(data, "mixtures", f"song{i}.wav"),
                        mix, SR)
        audio.write_wav(os.path.join(data, "instruments", f"song{i}.wav"),
                        inst, SR)
    return data


def run_train_cli(argv, counters, cwd):
    """One in-process run of the training CLI with every launch count
    reset just before and read just after; -> (wall s, {kernel:
    launches}, the run's loss log)."""
    from vocal_remover_tpu_torch.cli import train as train_cli

    for wrapper in counters.values():
        wrapper.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    logs = sorted(glob.glob(os.path.join(cwd, "loss_*.json")),
                  key=os.path.getmtime)
    with open(logs[-1]) as f:
        log = json.load(f)
    return wall, {k: w.launches for k, w in counters.items()}, log


def recurrence_train_ms(shapes) -> float:
    """Device ms of the plain recurrence's forward and backward (the train
    step's BiLSTM recurrence) summed over `shapes` (T, 2N, H), one per
    band net, on random inputs (CUDA events)."""
    from vocal_remover_tpu_torch.nn import lstm_kernel

    gen = torch.Generator(device="cuda").manual_seed(7)
    total = 0.0
    for t_len, two_n, hidden in shapes:
        xg = (0.5 * torch.randn(t_len, two_n, 4 * hidden, device="cuda",
                                generator=gen)).requires_grad_()
        w = (0.1 * torch.randn(2, hidden, 4 * hidden, device="cuda",
                               generator=gen)).requires_grad_()
        up = torch.randn(t_len, two_n, hidden, device="cuda", generator=gen)

        def fwd_bwd():
            torch.autograd.backward(lstm_kernel.recurrence_plain(xg, w), up)

        total += cuda_ms(fwd_bwd, iters=5, warmup=1)
    return total


class _RecurrenceKernelNoGrad(torch.autograd.Function):
    """Timing stand-in for the plain recurrence in the train step: the
    forward kernel, and zero gradients for its inputs. The step's other
    work (the backward of every op around it included) is unchanged, so
    the step's wall with and without it is the plain recurrence's share
    of the step as the step runs it."""

    @staticmethod
    def forward(ctx, xg, w_hh):
        from vocal_remover_tpu_torch.nn import lstm_kernel

        ctx.shapes = xg.shape, w_hh.shape
        return lstm_kernel.recurrence(xg, w_hh)

    @staticmethod
    def backward(ctx, grad):
        xs, ws = ctx.shapes
        return grad.new_zeros(xs), grad.new_zeros(ws)


def step_ms_without_plain_recurrence(trainer, steps) -> float:
    """Wall ms a step of `steps` with the plain recurrence replaced by
    `_RecurrenceKernelNoGrad` (timing only: the gradients are not the
    model's)."""
    from vocal_remover_tpu_torch.nn import lstm_kernel

    plain = lstm_kernel.recurrence_plain
    lstm_kernel.recurrence_plain = _RecurrenceKernelNoGrad.apply
    try:
        trainer.train_epoch(steps[:1])  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_epoch(steps)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / len(steps)
    finally:
        lstm_kernel.recurrence_plain = plain


def grads_card_vs_cpu(seed, is_complex=False, wave_loss=None):
    """compute_grads of SMALL_NET (complex-mask with `is_complex`, the
    wave term with `wave_loss`) in float64 on the card and on the CPU;
    -> (loss relative difference, worst gradient leaf difference over
    its tolerance scale, leaves)."""
    from vocal_remover_tpu_torch.models.cascaded import CascadedNet
    from vocal_remover_tpu_torch.nn import config
    from vocal_remover_tpu_torch.train.step import Trainer

    rng = np.random.default_rng(seed)
    # magnitudes, or signed [real; imaginary] channel stacks
    X = rng.standard_normal((2, 4 if is_complex else 2,
                             SMALL_NET[0] // 2 + 1, 256))
    X = X if is_complex else np.abs(X)
    y = X * rng.uniform(0.0, 1.0, X.shape)
    config.set_compute_dtype(torch.float64)
    try:
        model = CascadedNet(*SMALL_NET, is_complex=is_complex,
                            generator=torch.Generator().manual_seed(seed)
                            ).double()
        res = {}
        for dev in ("cpu", "cuda"):
            t = Trainer(copy.deepcopy(model), 1e-3, dropout=False,
                        wave_loss=wave_loss, device=dev)
            loss, grads = t.compute_grads(X, y)
            res[dev] = loss, {k: g.cpu().numpy() for k, g in grads.items()}
    finally:
        config.set_compute_dtype(torch.float32)
    (lc, gc_), (lg, gg) = res["cpu"], res["cuda"]
    scale = max(np.abs(g).max() for g in gc_.values())
    worst = max(np.abs(gg[k] - g).max()
                / max(np.abs(g).max(), 1e-3 * scale) for k, g in gc_.items())
    return abs(lg - lc) / abs(lc), worst, len(gc_)


def train_complex(root, data, seed, counters, smi, mag_step_ms, mag_peak):
    """The complex-mask run of [train]: cli.train --is_complex --wave_loss
    sdr for one epoch at the CLI's defaults on [train]'s songs (the
    recurrence kernel 5 x validation chunks, none in the step); its
    checkpoint through cli.evaluate on the card; float64 compute_grads of
    the complex SMALL_NET with the wave term, card vs CPU; the warm
    complex step without and with the wave term."""
    from vocal_remover_tpu_torch.cli import evaluate
    from vocal_remover_tpu_torch.cli import train as train_cli
    from vocal_remover_tpu_torch.data import cache, dataset, pairing
    from vocal_remover_tpu_torch.data.loader import Loader
    from vocal_remover_tpu_torch.models.cascaded import CascadedNet
    from vocal_remover_tpu_torch.nn import config
    from vocal_remover_tpu_torch.train.step import Trainer

    out = os.path.join(root, "models_complex")
    argv = (["-d", data, "--output_dir", out, "-E", "1"] + TRAIN_ARGS
            + ["--is_complex", "--wave_loss", "sdr"])
    cwd = os.getcwd()
    os.chdir(root)
    try:
        wall, launches, log = run_train_cli(argv, counters, root)
    finally:
        os.chdir(cwd)
    patches = glob.glob(os.path.join(
        root, f"cs256_sr{SR}_hl{TRAIN_HOP}_nf{TRAIN_NFFT}_of64", "*.npz"))
    chunks = -(-len(patches) // VAL_BATCH)
    check(len(log) == 1 and np.isfinite(log).all(),
          f"train --is_complex: loss log {log}")
    check_launches("train --is_complex", launches, 5 * chunks)
    print(f"[train] cli.train --is_complex --wave_loss sdr -E 1 "
          f"{' '.join(TRAIN_ARGS)}: {wall:.3f} s wall, losses (train, val) "
          f"{log}, launches {launches} = 5 x {chunks} validation chunks, "
          f"none in the steps; {smi}", flush=True)

    # the checkpoint through cli.evaluate on the first song's pair
    ckpt = glob.glob(os.path.join(out, "model_iter*.vrt.npz"))[0]
    mix, inst = (os.path.join(root, "eval_complex", sub)
                 for sub in ("mixtures", "instruments"))
    for sub, dst in (("mixtures", mix), ("instruments", inst)):
        os.makedirs(dst)
        os.link(os.path.join(data, sub, "song0.wav"),
                os.path.join(dst, "song0.wav"))
    want = sep_chunks(aligned_lengths(mix, inst), EVAL_BATCH, False)
    wall, launches, peak, res = evaluate_json(
        ckpt, mix, inst, os.path.join(root, "eval_complex.json"), counters)
    check(len(res["songs"]) == 1, f"evaluate complex: {res}")
    check_launches("evaluate complex", launches, 5 * want)
    print(f"[train] {os.path.basename(ckpt)} (complex) through cli.evaluate "
          f"on the card, one {TRAIN_SECONDS} s pair: {wall:.3f} s wall, "
          f"launches {launches} (5 x {want} chunks), SDR inst "
          f"{res['mean']['instrumental_sdr']:.4f} / vocal "
          f"{res['mean']['vocal_sdr']:.4f} dB", flush=True)

    rel, worst, leaves = grads_card_vs_cpu(seed, is_complex=True,
                                           wave_loss="sdr")
    check(rel <= GRAD_RTOL and worst <= GRAD_RTOL,
          f"train: complex float64 compute_grads card vs CPU: loss "
          f"{rel:.3g}, worst leaf {worst:.3g} (tol {GRAD_RTOL})")
    print(f"[train] compute_grads CascadedNet{SMALL_NET} is_complex "
          f"wave_loss sdr, float64, card vs CPU: loss {rel:.3g} relative, "
          f"worst of {leaves} gradient leaves {worst:.3g} of its max |g| "
          f"(tol {GRAD_RTOL})", flush=True)

    cli_seed = train_cli.build_parser().get_default("seed")
    random.seed(cli_seed)
    train_files, _ = pairing.train_val_split(data, "random", 0.25, [])
    tset = cache.make_training_set(train_files, SR, TRAIN_HOP, TRAIN_NFFT)
    ramp = train_cli.reduction_weight_ramp(TRAIN_NFFT, SR, 0.2)
    batches = list(Loader(dataset.TrainingSet(
        tset * TRAIN_PATCHES, 256, 0.0, ramp, 0.0, 1.0, seed=cli_seed,
        is_complex=True),
        TRAIN_BATCH, shuffle=True, seed=cli_seed))
    check(batches[0][0].shape == (TRAIN_BATCH, 4, 1025, 256),
          f"complex batch {batches[0][0].shape}")
    steps = (batches * STEP_REPEAT)[:STEP_REPEAT]
    with config.precision("highest"):
        for wave_loss in (None, "sdr"):
            model = CascadedNet(TRAIN_NFFT, TRAIN_HOP, 32, 128,
                                is_complex=True, generator=torch.Generator()
                                .manual_seed(seed))
            trainer = Trainer(model, 1e-3, seed=seed, wave_loss=wave_loss)
            trainer.train_epoch(batches[:2])  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss = trainer.train_epoch(steps)
            torch.cuda.synchronize()
            step_ms = 1e3 * (time.perf_counter() - t0) / len(steps)
            peak = torch.cuda.max_memory_allocated() / 2**30
            check(np.isfinite(loss), f"complex step {wave_loss}: {loss}")
            print(f"[train] warm complex step (is_complex, wave_loss "
                  f"{wave_loss}), batch {TRAIN_BATCH} crop 256 highest: "
                  f"{step_ms:.2f} ms ({len(steps)} steps, batches in "
                  f"memory), {1e3 * TRAIN_BATCH / step_ms:.2f} samples/s, "
                  f"peak {peak:.2f} GiB; the magnitude step in this run "
                  f"{mag_step_ms:.2f} ms, peak {mag_peak:.2f} GiB "
                  f"({step_ms / mag_step_ms:.3f}x); {smi}", flush=True)
            del trainer, model
            gc.collect()
            torch.cuda.empty_cache()


def resume_from_msgpack(root, argv, pt_first, out, counters, chunks, smi):
    """The state of [train]'s first run (epoch TRAIN_EPOCHS - 1) written
    in the JAX package's flax layout by the port's writer, read back
    (seconds, size; parameters equal to the .pt's bit for bit), then
    cli.train --resume from it for one epoch."""
    from vocal_remover_tpu_torch.models.cascaded import CascadedNet
    from vocal_remover_tpu_torch.train import checkpoint
    from vocal_remover_tpu_torch.train.plateau import ReduceLROnPlateau
    from vocal_remover_tpu_torch.train.step import Trainer

    def trainer():
        return Trainer(CascadedNet(TRAIN_NFFT, TRAIN_HOP, 32, 128), 1e-3)

    from_pt, sched = trainer(), ReduceLROnPlateau(lr=1e-3)
    epoch, best = checkpoint.load_train_state(pt_first, from_pt, sched)
    mp_dir = os.path.join(root, "models_msgpack")
    shutil.copytree(out, mp_dir)
    mp = os.path.join(mp_dir, "train_state.msgpack")
    t0 = time.perf_counter()
    checkpoint.save_train_state(mp, from_pt, sched, epoch, best)
    write_s = time.perf_counter() - t0
    from_mp = trainer()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.load_train_state(mp, from_mp, ReduceLROnPlateau(lr=1e-3))
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    params = list(from_pt.model.named_parameters())
    same = all(torch.equal(p, q) for (_, p), q in
               zip(params, from_mp.model.parameters()))
    check(len(params) == 368, f"train: {len(params)} parameters")
    check(same, "train: parameters loaded from the .msgpack differ from the "
                ".pt's")
    size = os.path.getsize(mp)
    del from_pt, from_mp
    wall, launches, log = run_train_cli(
        argv + ["--output_dir", mp_dir, "-E", str(epoch + 2), "--resume", mp],
        counters, root)
    check(len(log) == 1 and np.isfinite(log).all()
          and launches["lstm_recurrence"] == 5 * chunks,
          f"train --resume msgpack: log {log}, launches {launches}")
    print(f"[train] msgpack: the full-width state of epoch {epoch} written "
          f"in the JAX package's flax layout {write_s:.3f} s, {size} bytes "
          f"({size / 2**20:.1f} MiB), read into a Trainer on the card "
          f"{read_s:.3f} s, its {len(params)} parameters equal to the .pt's "
          f"bit for bit; cli.train --resume train_state.msgpack, epoch "
          f"{epoch + 1}: {wall:.3f} s wall, losses {log}, launches "
          f"{launches}; {smi}", flush=True)


def flag_run(root, argv, label, flags, counters, chunks, smi):
    """cli.train -E 1 with one of this slice's flags on [train]'s songs:
    finite losses, the recurrence kernel 5 x validation chunks and never
    in the step."""
    out = os.path.join(root, f"models_{label}")
    wall, launches, log = run_train_cli(
        argv + ["--output_dir", out, "-E", "1"] + flags, counters, root)
    check(len(log) == 1 and np.isfinite(log).all(),
          f"train {' '.join(flags)}: loss log {log}")
    check_launches(f"train {' '.join(flags)}", launches, 5 * chunks)
    check(glob.glob(os.path.join(out, "model_iter0.vrt.npz")),
          f"train {' '.join(flags)}: no checkpoint")
    print(f"[train] cli.train -E 1 {' '.join(TRAIN_ARGS)} {' '.join(flags)}: "
          f"{wall:.3f} s wall, losses (train, val) {log}, launches "
          f"{launches} = 5 x {chunks} validation chunks, none in the steps; "
          f"{smi}", flush=True)


def remat_on_card(seed):
    """SMALL_NET in float64 on the card with dropout and the aux head:
    compute_grads with remat against without (GRAD_RTOL of each leaf's
    largest |g|), and every BN buffer and parameter after two train steps
    (GRAD_RTOL of its largest |value|)."""
    from vocal_remover_tpu_torch.models.cascaded import CascadedNet
    from vocal_remover_tpu_torch.nn import config
    from vocal_remover_tpu_torch.train.step import Trainer

    rng = np.random.default_rng(seed + 5)
    X = np.abs(rng.standard_normal((2, 2, SMALL_NET[0] // 2 + 1, 256)))
    y = X * rng.uniform(0.0, 1.0, X.shape)
    config.set_compute_dtype(torch.float64)
    try:
        model = CascadedNet(*SMALL_NET, generator=torch.Generator()
                            .manual_seed(seed)).double()
        res = []
        for remat in (False, True):
            t = Trainer(copy.deepcopy(model), 1e-3, seed=seed,
                        aux_lambda=0.1, remat=remat)
            loss, grads = t.compute_grads(X, y)
            t.train_epoch([(X, y), (X[::-1].copy(), y[::-1].copy())])
            res.append((loss, grads, t.model.state_dict()))
    finally:
        config.set_compute_dtype(torch.float32)
    (lp, gp, sp), (lr, gr, sr) = res
    # leaves that are zero in exact arithmetic (cancellation residue)
    # against 1e-3 of the largest |g|, as grads_card_vs_cpu
    scale = max(g.abs().max().item() for g in gp.values())
    worst_g = max((gr[k] - g).abs().max().item()
                  / max(g.abs().max().item(), 1e-3 * scale)
                  for k, g in gp.items())
    worst_s = max(((sr[k] - b).abs().max() / b.abs().max().clamp_min(1e-300))
                  .item() for k, b in sp.items() if b.is_floating_point())
    rel = abs(lr - lp) / abs(lp)
    check(max(rel, worst_g, worst_s) <= GRAD_RTOL,
          f"train: remat on the card: loss {rel:.3g}, worst gradient leaf "
          f"{worst_g:.3g}, worst buffer / parameter {worst_s:.3g} "
          f"(tol {GRAD_RTOL})")
    print(f"[train] remat on the card, CascadedNet{SMALL_NET} float64, "
          f"dropout on, aux_lambda 0.1: compute_grads with vs without loss "
          f"{rel:.3g} relative, worst of {len(gp)} gradient leaves "
          f"{worst_g:.3g}; after two steps worst BN buffer / parameter "
          f"{worst_s:.3g} of its max (tol {GRAD_RTOL})", flush=True)


def timed_steps(trainer, batches, warm=1, source=None):
    """(ms a step, peak GiB) of `batches` after `warm` warm-up steps (an
    index loader's batches when `source` is a DeviceTrainingSource)."""
    run = (trainer.train_epoch if source is None
           else lambda b: trainer.train_epoch_device(source, b))
    run(batches[:warm])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss = run(batches)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / len(batches)
    check(np.isfinite(loss), f"train: loss {loss}")
    return ms, torch.cuda.max_memory_allocated() / 2**30


def train_modes(model, batches, patches, loader, tset, ramp, cli_seed,
                counters, smi, plain, f32_epoch):
    """The numbers of this slice's modes at the CLI's defaults, each
    beside the plain float32 step of this run (`plain` = (ms, peak
    GiB), `f32_epoch` = (wall s, loader wait s) of an epoch from the
    loader): remat, also at batch BIG_BATCH; bf16 training (step,
    samples/s, peak, the loss gap on one batch); int8 staging (bytes a
    step, loader wait, step); the device-resident dataset in float32
    and bf16 (resident MB, bytes a step, loader wait, step, validation
    ms a patch; the first batch against the host path's)."""
    from vocal_remover_tpu_torch.data import device_cache
    from vocal_remover_tpu_torch.nn import config
    from vocal_remover_tpu_torch.train import losses
    from vocal_remover_tpu_torch.train.step import Trainer

    step_ms, peak = plain
    steps = (batches * STEP_REPEAT)[:STEP_REPEAT]

    def fresh(**kw):
        return Trainer(copy.deepcopy(model), 1e-3, seed=cli_seed, **kw)

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    with config.precision("highest"):
        ms, pk = timed_steps(fresh(remat=True), steps)
        # what the forward leaves allocated for the backward (activations
        # and the stage inputs remat keeps), without and with remat
        held = {}
        for remat in (False, True):
            t = fresh(remat=remat)
            Xd, yd, _, _, _ = t._stage(batches[0])
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            loss = t._loss(Xd, yd, t._generator())
            torch.cuda.synchronize()
            held[remat] = (torch.cuda.memory_allocated() - base) / 2**30
            del t, loss, Xd, yd
            free()
    free()
    print(f"[train] warm step --remat, batch {TRAIN_BATCH} crop 256 highest: "
          f"{ms:.2f} ms ({len(steps)} steps), peak {pk:.2f} GiB; plain in "
          f"this run {step_ms:.2f} ms, peak {peak:.2f} GiB ({ms / step_ms:.3f}"
          f"x time, {pk / peak:.3f}x peak); held for the backward after the "
          f"forward: plain {held[False]:.3f} GiB, remat {held[True]:.3f} GiB; "
          f"{smi}", flush=True)

    pairs = batches * 2
    big = [tuple(np.concatenate(p) for p in zip(a, b))
           for a, b in zip(pairs[0::2], pairs[1::2])][:BIG_STEPS]
    card = torch.cuda.get_device_properties(0).total_memory / 2**30
    row = {}
    for remat in (False, True):
        try:
            with config.precision("highest"):
                row[remat] = timed_steps(fresh(remat=remat), big, warm=1)
        except torch.cuda.OutOfMemoryError:
            row[remat] = None
        free()
    shown = {r: ("out of memory" if v is None else
                 f"{v[0]:.2f} ms, peak {v[1]:.2f} GiB") for r, v in row.items()}
    check(row[True] is not None, "train: --remat ran out of memory at batch "
                                 f"{BIG_BATCH}")
    print(f"[train] batch {BIG_BATCH} crop 256 highest ({BIG_STEPS} warm "
          f"steps; the card has {card:.1f} GiB): plain {shown[False]}, "
          f"--remat {shown[True]}; {smi}", flush=True)

    # bf16 training: the CLI's staging default in bf16 is bfloat16
    Xc, yc = (torch.from_numpy(a).cuda() for a in batches[0])
    gap = {}
    for prec in ("highest", "bfloat16"):
        with config.precision(prec), torch.no_grad():
            m = copy.deepcopy(model).cuda().train()
            gap[prec] = float(losses.mask_l1_loss(m(Xc), Xc, yc))
        del m
    rel = abs(gap["bfloat16"] - gap["highest"]) / gap["highest"]
    with config.precision("bfloat16"):
        ms, pk = timed_steps(fresh(transfer_dtype=torch.bfloat16), steps)
    free()
    print(f"[train] warm step --precision bfloat16, batch {TRAIN_BATCH} crop "
          f"256: {ms:.2f} ms ({len(steps)} steps), "
          f"{1e3 * TRAIN_BATCH / ms:.2f} samples/s, peak {pk:.2f} GiB; "
          f"highest in this run {step_ms:.2f} ms, "
          f"{1e3 * TRAIN_BATCH / step_ms:.2f} samples/s, peak {peak:.2f} "
          f"GiB; one batch's train-mode loss bf16 {gap['bfloat16']:.8f} vs "
          f"highest {gap['highest']:.8f}: {rel:.3g} relative; {smi}",
          flush=True)
    del Xc, yc

    # int8 staging, an epoch from the loader
    with config.precision("highest"):
        t = fresh(transfer_dtype="int8")
        t.train_epoch(batches[:2])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t.train_epoch(loader)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    X = batches[0][0]
    f32_bytes, q_bytes = 2 * X.nbytes, 2 * (X.size + 4)
    print(f"[train] --transfer_dtype int8, one epoch from the loader "
          f"({len(loader)} steps): {wall:.3f} s, "
          f"{1e3 * wall / len(loader):.2f} ms a step, the steps waited "
          f"{t.loader_wait_s:.3f} s ({100 * t.loader_wait_s / wall:.1f}%); "
          f"staged {q_bytes} bytes a step (X and y: uint8 + a float32 scale) "
          f"against {f32_bytes} in float32 ({f32_bytes / q_bytes:.2f}x "
          f"fewer); float32 staging in this run {f32_epoch[0]:.3f} s, waited "
          f"{f32_epoch[1]:.3f} s; {smi}", flush=True)
    del t
    free()

    # the device-resident dataset, float32 (highest) and bf16 (default)
    n_val = -(-len(patches) // VAL_BATCH)
    for prec, dtype in (("highest", torch.float32),
                        ("default", torch.bfloat16)):
        src = device_cache.DeviceTrainingSource(
            tset * TRAIN_PATCHES, 256, reduction_weight=ramp, seed=cli_seed,
            dtype=dtype)
        val = device_cache.DeviceValidationSource(patches, dtype=dtype)
        idx_loader = device_cache.DeviceLoader(src, TRAIN_BATCH, seed=cli_seed)
        idx = list(idx_loader)
        if dtype == torch.float32:
            Xd, yd = src.gather(*idx[0])
            same = (np.array_equal(Xd.cpu().numpy(), batches[0][0])
                    and np.array_equal(yd.cpu().numpy(), batches[0][1]))
            check(same, "train: the device cache's first batch differs from "
                        "the host path's")
        with config.precision(prec):
            t = fresh()
            t.train_epoch_device(src, idx[:2])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t.train_epoch_device(src, idx_loader)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            wait = t.loader_wait_s
            t.validate_epoch_device(val, VAL_BATCH)
            for wrapper in counters.values():
                wrapper.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t.validate_epoch_device(val, VAL_BATCH)
            torch.cuda.synchronize()
            val_ms = 1e3 * (time.perf_counter() - t0) / len(val)
        n_rec = counters["lstm_recurrence"].launches
        check(n_rec == 5 * n_val, f"train: device validation launched the "
                                  f"recurrence {n_rec} times, want {5 * n_val}")
        up = device_cache.pack_indices(*idx[0]).nbytes
        print(f"[train] --device_data_cache {prec} ({dtype}): resident "
              f"{src.nbytes / 1e6:.1f} MB training ({len(tset)} songs), "
              f"{val.nbytes / 1e6:.1f} MB validation ({len(val)} patches); "
              f"{up} bytes uploaded a step; one epoch ({len(idx)} steps) "
              f"{wall:.3f} s, {1e3 * wall / len(idx):.2f} ms a step, "
              f"waited {wait:.3f} s ({100 * wait / wall:.1f}%); validation "
              f"{val_ms:.2f} ms a patch ({len(val)} patches, recurrence "
              f"{n_rec} launches a pass)"
              + (", first batch = the host path's bit for bit"
                 if dtype == torch.float32 else "") + f"; {smi}", flush=True)
        del t, src, val
        free()


def phase_train(tmp, seed, counters, smi):
    """The training slice ([train]): a seeded dataset of TRAIN_SONGS
    stereo 44.1 kHz songs through the training CLI on the card at its
    full width and defaults (CascadedNet(2048, 1024, 32, 128), highest),
    TRAIN_EPOCHS epochs, then one more with --resume; the best checkpoint
    separates a 10 s song through the inference CLI; compute_grads in
    float64 and a full-width float32 train-mode loss, card vs CPU; then
    the step time, samples/s, validation ms a patch, peak memory, one
    profiled step (busy share, top kernels), the plain recurrence's
    share of the step (alone, and as the step's wall with and without it)
    and the step's wait on the loader.
    -> the recurrence's launches in the first CLI run (all validation)."""
    from torch.profiler import ProfilerActivity, profile

    from vocal_remover_tpu_torch.cli import train as train_cli
    from vocal_remover_tpu_torch.data import cache, dataset, pairing
    from vocal_remover_tpu_torch.data.loader import Loader
    from vocal_remover_tpu_torch.models.cascaded import CascadedNet
    from vocal_remover_tpu_torch.nn import config
    from vocal_remover_tpu_torch.train import checkpoint, losses
    from vocal_remover_tpu_torch.train.step import Trainer
    from vocal_remover_tpu_torch.utils import audio

    torch.cuda.empty_cache()
    config.set_precision("highest")
    phase_t0 = time.perf_counter()
    root = os.path.join(tmp, "train")
    data = write_train_songs(root, seed)
    out = os.path.join(root, "models")
    state = os.path.join(out, checkpoint.STATE_NAME)
    argv = ["-d", data, "--output_dir", out] + TRAIN_ARGS
    cwd = os.getcwd()
    os.chdir(root)  # the CLI writes its logs and validation patches here
    try:
        wall, launches, log = run_train_cli(
            argv + ["-E", str(TRAIN_EPOCHS)], counters, root)
        patches = sorted(glob.glob(os.path.join(
            root, f"cs256_sr{SR}_hl{TRAIN_HOP}_nf{TRAIN_NFFT}_of64", "*.npz")))
        chunks = -(-len(patches) // VAL_BATCH)
        check(len(log) == TRAIN_EPOCHS and np.isfinite(log).all(),
              f"train: loss log {log}")
        for k, n in launches.items():
            want = 5 * chunks * TRAIN_EPOCHS if k == "lstm_recurrence" else 0
            check(n == want, f"train: {k} launched {n} times, want {want} "
                             f"(5 band nets x {chunks} validation chunks x "
                             f"{TRAIN_EPOCHS} epochs; none in the train step)")
        first_launches = launches["lstm_recurrence"]
        # the state of epoch TRAIN_EPOCHS - 1, before --resume replaces it
        pt_first = os.path.join(root, "first_" + checkpoint.STATE_NAME)
        for sfx in ("", ".meta.json"):
            shutil.copy(state + sfx, pt_first + sfx)
        print(f"[train] cli.train -E {TRAIN_EPOCHS} {' '.join(TRAIN_ARGS)} "
              f"on {TRAIN_SONGS} x {TRAIN_SECONDS} s songs (cache built in "
              f"the run): {wall:.3f} s wall, losses (train, val) {log}, "
              f"launches {launches} = 5 x {chunks} chunks of {len(patches)} "
              f"validation patches x {TRAIN_EPOCHS}; {smi}", flush=True)

        wall, launches, log = run_train_cli(
            argv + ["-E", str(TRAIN_EPOCHS + 1), "--resume", state],
            counters, root)
        with open(state + ".meta.json") as f:
            meta = json.load(f)
        check(len(log) == 1 and np.isfinite(log).all()
              and meta["epoch"] == TRAIN_EPOCHS,
              f"train --resume: log {log}, meta {meta}")
        check(launches["lstm_recurrence"] == 5 * chunks,
              f"train --resume: {launches}")
        print(f"[train] cli.train --resume, epoch {TRAIN_EPOCHS}: {wall:.3f} "
              f"s wall, losses {log}, launches {launches}, step counter "
              f"{meta['step_counter']}", flush=True)
        resume_from_msgpack(root, argv, pt_first, out, counters, chunks, smi)
        for label, flags in FLAG_RUNS:
            flag_run(root, argv, label, flags, counters, chunks, smi)
    finally:
        os.chdir(cwd)
        config.set_precision("highest")

    # the best checkpoint separates a 10 s song on the card
    best = max(glob.glob(os.path.join(out, "model_iter*.vrt.npz")),
               key=lambda p: int(p.rsplit("iter", 1)[1].split(".")[0]))
    song = os.path.join(root, "ten.wav")
    audio.write_wav(song, train_pair(10, seed + 99)[0], SR)
    sep_out = os.path.join(root, "sep")
    wall, launches = run_cli(["-P", best, "-i", song, "-o", sep_out, "-r",
                              str(SR), "-f", str(TRAIN_NFFT), "-H",
                              str(TRAIN_HOP)], counters)
    y, v = read_stems(sep_out, "ten")
    resid = residual_lsb(y, v, read_mix(song))
    check(resid <= 2, f"train: separation with {best}: residual {resid} LSB")
    check(launches["lstm_recurrence"] > 0, f"train: separation {launches}")
    print(f"[train] {os.path.basename(best)} separates a 10 s song through "
          f"cli.inference: {wall:.3f} s, residual {resid} LSB (tol 2), "
          f"launches {launches}", flush=True)

    rel, worst, leaves = grads_card_vs_cpu(seed)
    check(rel <= GRAD_RTOL and worst <= GRAD_RTOL,
          f"train: float64 compute_grads card vs CPU: loss {rel:.3g}, "
          f"worst leaf {worst:.3g} (tol {GRAD_RTOL})")
    print(f"[train] compute_grads CascadedNet{SMALL_NET} float64, card vs "
          f"CPU: loss {rel:.3g} relative, worst of {leaves} gradient leaves "
          f"{worst:.3g} of its max |g| (tol {GRAD_RTOL})", flush=True)
    remat_on_card(seed)

    # the CLI's training loader (its seed, split and data; the cache is
    # there) and its validation patches
    cli_seed = train_cli.build_parser().get_default("seed")
    random.seed(cli_seed)
    train_files, _ = pairing.train_val_split(data, "random", 0.25, [])
    tset = cache.make_training_set(train_files, SR, TRAIN_HOP, TRAIN_NFFT)
    ramp = train_cli.reduction_weight_ramp(TRAIN_NFFT, SR, 0.2)
    loader = Loader(dataset.TrainingSet(tset * TRAIN_PATCHES, 256, 0.0, ramp,
                                        0.0, 1.0, seed=cli_seed), TRAIN_BATCH,
                    shuffle=True, seed=cli_seed)
    batches = list(loader)
    val_batches = list(Loader(dataset.ValidationSet(patches), VAL_BATCH))

    with config.precision("highest"):
        model = CascadedNet(TRAIN_NFFT, TRAIN_HOP, 32, 128,
                            generator=torch.Generator().manual_seed(seed))
        card = copy.deepcopy(model).cuda().train()
        # two of the batch's items: the CPU's forward is the cost
        Xc, yc = (torch.from_numpy(a[:2]) for a in batches[0])
        with torch.no_grad():
            lc = float(losses.mask_l1_loss(model.train()(Xc), Xc, yc))
            Xg, yg = Xc.cuda(), yc.cuda()
            lg = float(losses.mask_l1_loss(card(Xg), Xg, yg))
        rel = abs(lg - lc) / abs(lc)
        check(rel <= TRAIN_LOSS_RTOL, f"train: full-width train-mode loss "
              f"card {lg} vs CPU {lc}: {rel:.3g} > {TRAIN_LOSS_RTOL}")
        print(f"[train] full-width train-mode loss of one batch of "
              f"{tuple(Xc.shape)}, float32: card {lg:.8f}, CPU {lc:.8f}, "
              f"{rel:.3g} relative (tol {TRAIN_LOSS_RTOL})", flush=True)
        del card, Xg, yg

        trainer = Trainer(model, 1e-3, seed=seed)
        trainer.train_epoch(batches[:2])  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        steps = (batches * STEP_REPEAT)[:STEP_REPEAT]
        t0 = time.perf_counter()
        trainer.train_epoch(steps)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / len(steps)
        peak = torch.cuda.max_memory_allocated() / 2**30
        rec_ms = recurrence_train_ms([(128, 2 * TRAIN_BATCH, h)
                                      for h in (64, 32, 64, 32, 64)])
        print(f"[train] warm step, batch {TRAIN_BATCH} crop 256 highest: "
              f"{step_ms:.2f} ms ({len(steps)} steps, batches in memory), "
              f"{1e3 * TRAIN_BATCH / step_ms:.2f} samples/s, peak "
              f"{peak:.2f} GiB; the plain recurrence's forward + backward "
              f"alone at the step's five shapes {rec_ms:.2f} ms = "
              f"{100 * rec_ms / step_ms:.1f}% of the step's wall "
              f"(isolated, CUDA events); {smi}", flush=True)
        alt_ms = step_ms_without_plain_recurrence(trainer, steps)
        print(f"[train] the same steps with the plain recurrence replaced "
              f"by its forward kernel and zero gradients (timing only): "
              f"{alt_ms:.2f} ms a step; the plain recurrence's forward + "
              f"backward take {step_ms - alt_ms:.2f} ms = "
              f"{100 * (step_ms - alt_ms) / step_ms:.1f}% of the step in the "
              f"step; {smi}", flush=True)

        for wrapper in counters.values():
            wrapper.launches = 0
        trainer.validate_epoch(val_batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.validate_epoch(val_batches)
        torch.cuda.synchronize()
        val_ms = 1e3 * (time.perf_counter() - t0) / len(patches)
        n_rec = counters["lstm_recurrence"].launches
        check(n_rec == 2 * 5 * chunks, f"train: validation launched the "
              f"recurrence {n_rec} times, want {2 * 5 * chunks}")
        print(f"[train] validation: {val_ms:.2f} ms a patch ({len(patches)} "
              f"patches, batch {VAL_BATCH}; recurrence kernel {n_rec // 2} "
              "launches a pass)", flush=True)

        t0 = time.perf_counter()
        trainer.train_epoch(loader)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        f32_epoch = wall, trainer.loader_wait_s
        print(f"[train] one epoch from the loader ({len(loader)} steps, "
              f"4 workers): {wall:.3f} s, the steps waited "
              f"{trainer.loader_wait_s:.3f} s on it "
              f"({100 * trainer.loader_wait_s / wall:.1f}%)", flush=True)

        # device activity only: a step launches about 61,000 kernels, and
        # the host ops' events would take longer to read than the epoch
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trainer.train_epoch(batches[:1])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    kernels = device_kernels(prof)
    busy, by_name = kernel_summary(kernels)
    total = sum(t for t, _ in by_name.values())
    print(f"[train] profiled step (1 of the epoch's {len(loader)}, batch in "
          f"memory): {wall:.3f} s wall, "
          f"{len(kernels)} kernel launches, kernel time "
          f"{total / 1e3:.1f} ms, device busy "
          f"{busy / 1e3:.1f} ms = {100 * busy / 1e6 / wall:.1f}% of wall",
          flush=True)
    for kname, (t, n) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:10]:
        print(f"[train]   {t / 1e3:9.2f} ms {n:7d}x  {kname[:100]}",
              flush=True)
    del prof, kernels, trainer
    gc.collect()
    torch.cuda.empty_cache()
    train_modes(model, batches, patches, loader, tset, ramp, cli_seed,
                counters, smi, (step_ms, peak), f32_epoch)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    train_complex(root, data, seed, counters, smi, step_ms, peak)
    print(f"[train] phase: {time.perf_counter() - phase_t0:.1f} s",
          flush=True)
    return first_launches


# the library slice ([library]): the keywords no CLI passes, at the
# flagship's full width on [train]'s songs
LIB_PATCHES = 3  # 3 train songs x 3 = 9 items
LIB_MULT = 2  # epoch_multiplier: 18 samples, 4 batches of 4, 2 dropped
LIB_PREFETCH = 3
LIB_READS = 20  # crops timed each way
# the loss of one epoch at prefetch 3 against a fresh trainer at prefetch
# 0 (same initial weights, seed and batches): cuDNN's backward kernels
# may sum in another order from run to run, and Adam turns a sign flip of
# a near-zero gradient into a whole lr-sized step. Three H100 runs of the
# 4-step epoch were 3.45e-6, 1.57e-5 and 1.27e-4 relative apart; the
# tolerance leaves a factor of about 8 over the largest (the host batches
# are held bit for bit apart from it)
LIB_LOSS_RTOL = 1e-3
# resize_bilinear's lerp against its interp matrix at an exact 2x, f32:
# of the input's max |x|
RESIZE_TOL = 1e-5


def quantize_u8_numpy(a):
    """The int8 staging quantizer in numpy (the port's before the native
    one): 255 at the largest value from 0, multiplied by the float32
    reciprocal of the scale, NaN to 0, rounded half to even."""
    a = np.ascontiguousarray(a, np.float32)
    hi = np.float32(np.max(a, initial=np.float32(0), where=a > 0))
    scale = hi / np.float32(255) if hi > 0 else np.float32(1)
    with np.errstate(invalid="ignore"):
        s = a * (np.float32(1) / scale)
    s = np.where(s > 0, s, np.float32(0))
    return np.rint(np.minimum(s, np.float32(255))).astype(np.uint8), scale


def host_ms(fn, reps: int) -> float:
    """Mean host ms of `fn()` over `reps` calls after one warm-up."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1e3 * (time.perf_counter() - t0) / reps


def library_host_kernels(tset, stems, batch):
    """The native host kernels on the card's host: load_crop_abs at full
    width against numpy's |z| / coef (share and ulp of the values that
    differ, ms a crop each way), PCM16 round trip on [main]'s stems,
    quantize_u8 against the numpy quantizer on a training batch."""
    from vocal_remover_tpu_torch import native
    from vocal_remover_tpu_torch.data import cache

    X_path, _, coef = tset[0]
    n_frames = cache.read_npy_shape(X_path)[0]
    starts = np.random.default_rng(7).integers(0, n_frames - 256, LIB_READS)
    it = iter(np.tile(starts, 2 * LIB_READS))

    def c_read():
        return native.load_crop_abs(X_path, int(next(it)), 256, coef)

    def np_read():
        rows = cache.read_npy_rows(X_path, int(next(it)), 256)
        return (np.abs(rows.transpose(1, 2, 0)) / coef).astype(np.float32)

    c_ms, np_ms = host_ms(c_read, LIB_READS), host_ms(np_read, LIB_READS)
    differ = total = worst = 0
    rel = 0.0
    for st in starts:
        got = native.load_crop_abs(X_path, int(st), 256, coef)
        rows = cache.read_npy_rows(X_path, int(st), 256)
        ref = (np.abs(rows.transpose(1, 2, 0)) / coef).astype(np.float32)
        check(got.shape == (2, 1025, 256), f"load_crop_abs {got.shape}")
        ulp = np.abs(got.view(np.int32).astype(np.int64) - ref.view(np.int32))
        differ += int((ulp > 0).sum())
        total += got.size
        worst = max(worst, int(ulp.max()))
        nz = ref > 0
        rel = max(rel, float((np.abs(got - ref)[nz] / ref[nz]).max()))
    check(rel <= 1e-6, f"load_crop_abs vs numpy: {rel:.3g} relative")
    print(f"[library] native load_crop_abs, (2, 1025, 256) crops of "
          f"{os.path.basename(X_path)}: {100 * differ / total:.2f}% of "
          f"{total} values differ from numpy's |z| / coef (at most {worst} "
          f"ulp, {rel:.3g} relative, tol 1e-6); {c_ms:.3f} ms a crop "
          f"native, {np_ms:.3f} ms numpy (read + |z| / coef; {LIB_READS} "
          "crops each, warm file cache)", flush=True)

    y, _ = stems
    q = y.astype(np.int16)
    dec = native.pcm16_decode(q)
    check(np.array_equal(dec, q.astype(np.float32) / np.float32(32768))
          and np.array_equal(native.pcm16_encode(dec), q),
          "pcm16 round trip on [main]'s instruments stem")
    enc_ms = host_ms(lambda: native.pcm16_encode(dec), 5)
    dec_ms = host_ms(lambda: native.pcm16_decode(q), 5)
    print(f"[library] native pcm16_encode / pcm16_decode: [main]'s "
          f"instruments stem {q.shape} round trip exact; {enc_ms:.3f} / "
          f"{dec_ms:.3f} ms", flush=True)

    out = native.quantize_u8(batch)
    want_q, want_scale = quantize_u8_numpy(batch)
    check(np.array_equal(out["q"], want_q) and out["scale"] == want_scale,
          "quantize_u8 differs from the numpy quantizer")
    c_ms = host_ms(lambda: native.quantize_u8(batch), 5)
    np_ms = host_ms(lambda: quantize_u8_numpy(batch), 5)
    print(f"[library] native quantize_u8 on a training batch "
          f"{batch.shape}: equal to the numpy quantizer byte for byte "
          f"(scale {out['scale']:.6g}); {c_ms:.3f} ms native, {np_ms:.3f} "
          "ms numpy", flush=True)


def recorded(loader, out):
    """Iterate `loader`, keeping a copy of every batch in `out`."""
    for X, y in loader:
        out.append((X.copy(), y.copy()))
        yield X, y


def decoder_inputs(model, X):
    """{shape: tensor} of the inputs of `model`'s Decoders in one eval
    forward of X (the 2x upsample's shapes)."""
    from vocal_remover_tpu_torch.nn.layers import Decoder

    seen = {}

    def keep(_, inp):
        seen.setdefault(tuple(inp[0].shape), inp[0].clone())

    hooks = [m.register_forward_pre_hook(keep)
             for m in model.modules() if isinstance(m, Decoder)]
    try:
        with torch.no_grad():
            model.eval()(X)
    finally:
        for h in hooks:
            h.remove()
    return seen


def phase_library(tmp, seed, counters, smi, stems):
    """[library]: the library surface that no CLI reaches, on the card
    at the flagship's full width, on [train]'s songs and caches: the
    native host kernels; make_training_set(progress=), a Loader with
    epoch_multiplier, drop_last and prefetch, one epoch of
    Trainer(prefetch=LIB_PREFETCH) against a fresh Trainer(prefetch=0)
    (host batches bit for bit, losses within LIB_LOSS_RTOL), validate_epoch
    on a ValidationSet (the recurrence kernel 5 x chunks),
    DeviceLoader(drop_last=True) through train_epoch_device;
    resize_bilinear(lerp2x=) at the decoders' shapes, hann_window(dtype=)
    on the card; write_wav(subtype="FLOAT") and load(mono=, dtype=) on
    [main]'s instruments stem."""
    from vocal_remover_tpu_torch.cli import train as train_cli
    from vocal_remover_tpu_torch.data import cache, dataset, pairing
    from vocal_remover_tpu_torch.data.device_cache import (
        DeviceLoader,
        DeviceTrainingSource,
    )
    from vocal_remover_tpu_torch.data.loader import Loader
    from vocal_remover_tpu_torch.models.cascaded import CascadedNet
    from vocal_remover_tpu_torch.nn import config
    from vocal_remover_tpu_torch.ops import resize, stft
    from vocal_remover_tpu_torch.train.step import Trainer
    from vocal_remover_tpu_torch.utils import audio

    phase_t0 = time.perf_counter()
    config.set_precision("highest")
    root = os.path.join(tmp, "library")
    data = os.path.join(tmp, "train", "dataset")
    cli_seed = train_cli.build_parser().get_default("seed")
    random.seed(cli_seed)
    train_files, val_files = pairing.train_val_split(data, "random", 0.25,
                                                     [])
    seen = []
    t0 = time.perf_counter()
    tset = cache.make_training_set(
        train_files, SR, TRAIN_HOP, TRAIN_NFFT,
        progress=lambda files: seen.extend(files) or files)
    cache_s = time.perf_counter() - t0
    check(seen == train_files and len(tset) == len(train_files),
          f"make_training_set progress saw {seen}")
    patches = dataset.make_validation_set(
        val_files, 256, SR, TRAIN_HOP, TRAIN_NFFT, 64, patch_root=root,
        progress=lambda files: seen.extend(files) or files)
    check(seen == train_files + val_files, f"progress saw {seen}")
    print(f"[library] make_training_set / make_validation_set(progress=) "
          f"on [train]'s caches: {len(train_files)} + {len(val_files)} "
          f"songs seen by the callbacks, {cache_s:.3f} s, "
          f"{len(patches)} validation patches", flush=True)

    ramp = train_cli.reduction_weight_ramp(TRAIN_NFFT, SR, 0.2)
    tds = dataset.TrainingSet(tset * LIB_PATCHES, 256, 0.0, ramp, 0.0, 1.0,
                              seed=cli_seed)
    loader = Loader(tds, TRAIN_BATCH, shuffle=True, seed=cli_seed,
                    epoch_multiplier=LIB_MULT, drop_last=True,
                    prefetch=LIB_PREFETCH)
    n = len(tds) * LIB_MULT
    check(loader.num_samples == n and len(loader) == n // TRAIN_BATCH,
          f"Loader: num_samples {loader.num_samples}, len {len(loader)}")

    base = CascadedNet(TRAIN_NFFT, TRAIN_HOP, 32, 128,
                       generator=torch.Generator().manual_seed(seed))
    runs = {}
    for prefetch in (LIB_PREFETCH, 0):
        loader.set_epoch(0)
        trainer = Trainer(copy.deepcopy(base), 1e-3, seed=cli_seed,
                          prefetch=prefetch)
        got = []
        for wrapper in counters.values():
            wrapper.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = trainer.train_epoch(recorded(loader, got))
        torch.cuda.synchronize()
        runs[prefetch] = (loss, got, time.perf_counter() - t0,
                          trainer.loader_wait_s,
                          {k: w.launches for k, w in counters.items()})
        if prefetch:
            del trainer
    (l3, b3, w3, wait3, n3), (l0, b0, w0, wait0, n0) = runs[LIB_PREFETCH], \
        runs[0]
    check(len(b3) == len(b0) == len(loader), f"epoch of {len(b3)} / "
          f"{len(b0)} batches, want {len(loader)}")
    check(all(np.array_equal(a, b) for p, q in zip(b3, b0)
              for a, b in zip(p, q)), "prefetch changed the host batches")
    gap = abs(l3 - l0) / abs(l0)
    check(np.isfinite(l3) and gap <= LIB_LOSS_RTOL,
          f"Trainer(prefetch={LIB_PREFETCH}) loss {l3} vs prefetch 0 {l0}")
    check(not any(n3.values()) and not any(n0.values()),
          f"the train step launched kernels: {n3}, {n0}")
    print(f"[library] Loader(batchsize {TRAIN_BATCH}, shuffle, "
          f"epoch_multiplier {LIB_MULT}, drop_last, prefetch "
          f"{LIB_PREFETCH}) over {len(tds)} items: num_samples {n}, "
          f"{len(loader)} batches (len checked); one epoch of the flagship "
          f"at crop 256, highest: Trainer(prefetch={LIB_PREFETCH}) loss "
          f"{l3:.8f} in {w3:.3f} s (waited {wait3:.3f} s), a fresh "
          f"Trainer(prefetch=0) from the same weights and seed {l0:.8f} in "
          f"{w0:.3f} s (waited {wait0:.3f} s): host batches equal bit for "
          f"bit, losses {gap:.3g} apart (tol {LIB_LOSS_RTOL}); recurrence "
          f"launches in the steps {n3['lstm_recurrence']}, "
          f"{n0['lstm_recurrence']}; {smi}", flush=True)

    library_host_kernels(tset, stems, b0[0][0])

    chunks = -(-len(patches) // VAL_BATCH)
    for wrapper in counters.values():
        wrapper.launches = 0
    t0 = time.perf_counter()
    val = trainer.validate_epoch(Loader(dataset.ValidationSet(patches),
                                        VAL_BATCH))
    torch.cuda.synchronize()
    val_s = time.perf_counter() - t0
    n_rec = counters["lstm_recurrence"].launches
    check(np.isfinite(val) and n_rec == 5 * chunks,
          f"validate_epoch: loss {val}, recurrence {n_rec}, want "
          f"{5 * chunks}")
    print(f"[library] validate_epoch on a ValidationSet of {len(patches)} "
          f"patches (batch {VAL_BATCH}): loss {val:.8f}, {val_s:.3f} s, "
          f"recurrence kernel {n_rec} launches = 5 x {chunks} chunks",
          flush=True)

    src = DeviceTrainingSource(tset * LIB_PATCHES, 256, reduction_weight=ramp,
                               seed=cli_seed, dtype=torch.float32)
    dl = DeviceLoader(src, TRAIN_BATCH, seed=cli_seed, drop_last=True)
    host = Loader(tds, TRAIN_BATCH, shuffle=True, seed=cli_seed,
                  drop_last=True)
    check(len(dl) == len(host) == len(src) // TRAIN_BATCH,
          f"DeviceLoader len {len(dl)}")
    dl.set_epoch(1)
    host.set_epoch(1)
    Xd, yd = src.gather(*next(iter(dl)))
    Xh, yh = next(iter(host))
    check(np.array_equal(Xd.cpu().numpy(), Xh)
          and np.array_equal(yd.cpu().numpy(), yh),
          "DeviceLoader's first batch differs from the host loader's")
    dl.set_epoch(0)
    steps = trainer._step_counter
    t0 = time.perf_counter()
    loss = trainer.train_epoch_device(src, dl)
    torch.cuda.synchronize()
    steps = trainer._step_counter - steps
    check(np.isfinite(loss) and steps == len(dl),
          f"train_epoch_device: loss {loss}, {steps} steps, want {len(dl)}")
    print(f"[library] DeviceLoader(drop_last=True) over {len(src)} items: "
          f"{len(dl)} batches (len checked; the first equal to the host "
          f"loader's bit for bit), train_epoch_device {steps} steps, loss "
          f"{loss:.8f}, {time.perf_counter() - t0:.3f} s", flush=True)

    X = torch.from_numpy(b0[0][0]).cuda()
    worst = 0.0
    shapes = decoder_inputs(trainer.model, X)
    for shape, x in sorted(shapes.items()):
        h, w = shape[2], shape[3]
        lerp = resize.resize_bilinear(x, 2 * h, 2 * w, lerp2x=True)
        mat = resize.resize_bilinear(x, 2 * h, 2 * w, lerp2x=False)
        err = float((lerp - mat).abs().max() / x.abs().max())
        worst = max(worst, err)
    check(worst <= RESIZE_TOL, f"resize lerp vs matrix: {worst:.3g}")
    n_shapes = len(shapes)
    del X, shapes, trainer
    n = TRAIN_NFFT
    window = stft.hann_window(n, "cuda", dtype=torch.float64)
    check(window.dtype == torch.float64 and window.is_cuda
          and np.array_equal(window.cpu().numpy(), 0.5 - 0.5 * np.cos(
              2.0 * np.pi * np.arange(n) / n)),
          "hann_window(float64) on the card")
    print(f"[library] resize_bilinear(lerp2x=True) vs lerp2x=False at the "
          f"{n_shapes} decoder input shapes of the flagship at batch "
          f"{TRAIN_BATCH}, crop 256 (f32, highest): max |diff| {worst:.3g} "
          f"of max |x| (tol {RESIZE_TOL}); hann_window({n}, 'cuda', "
          "float64) equal to numpy's float64 window", flush=True)

    path = os.path.join(root, "instruments_float.wav")
    inst = stems[0].astype(np.float32) / np.float32(32768)
    audio.write_wav(path, inst, SR, subtype="FLOAT")
    back, sr = audio.read_wav(path)
    check(sr == SR and back.dtype == np.float32
          and np.array_equal(back, inst), "FLOAT wav round trip")
    mono, _ = audio.load(path, sr=SR, mono=True, dtype=np.float64)
    check(mono.dtype == np.float64 and np.array_equal(
        mono, back.mean(axis=0).astype(np.float64)), "load(mono=True)")
    print(f"[library] write_wav(subtype='FLOAT') of [main]'s instruments "
          f"stem {inst.shape}: read back exactly ({os.path.getsize(path)} "
          "bytes); load(mono=True, dtype=float64) = the channel mean",
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[library] phase: {time.perf_counter() - phase_t0:.1f} s",
          flush=True)


# the tools slice ([tools]): the dataset and evaluation CLIs on the
# flagship checkpoint of [main]
TOOLS_SONGS = 1
TOOLS_SECONDS = 10
CROSS_SECONDS = 4  # the pair run on the card and on the CPU
EVAL_BATCH = 8  # the evaluate CLI's default --batchsize
PSEUDO_BATCH = 4  # the pseudo CLI's default --batchsize
# evaluate's JSON on the card vs the CPU (dB), pseudo's .npy on the card
# vs the CPU (largest |difference| over the largest |z|)
EVAL_CROSS_DB = 0.01
PSEUDO_CROSS_TOL = 1e-4


PARALLEL_DIR_SECONDS = (15, 15)  # [parallel]'s --input_dir songs
PARALLEL_TIMEOUT_S = 300


def mesh_grads(seed):
    """compute_grads of SMALL_NET in float64 on the card, by a Trainer on
    a one-rank mesh and by the same Trainer without one; -> (loss
    relative difference, worst leaf difference over max(its max |g|,
    1e-3 of the model's), leaves)."""
    from vocal_remover_tpu_torch.models.cascaded import CascadedNet
    from vocal_remover_tpu_torch.nn import config
    from vocal_remover_tpu_torch.parallel import mesh as mesh_lib
    from vocal_remover_tpu_torch.train.step import Trainer

    rng = np.random.default_rng(seed)
    X = np.abs(rng.standard_normal((2, 2, SMALL_NET[0] // 2 + 1, 256)))
    y = X * rng.uniform(0.0, 1.0, X.shape)
    config.set_compute_dtype(torch.float64)
    try:
        model = CascadedNet(*SMALL_NET,
                            generator=torch.Generator().manual_seed(seed)
                            ).double()
        res = {}
        for label, mesh in (("plain", None), ("mesh", mesh_lib.make_mesh())):
            t = Trainer(copy.deepcopy(model), 1e-3, dropout=False,
                        device="cuda", mesh=mesh)
            loss, grads = t.compute_grads(X, y)
            res[label] = loss, {k: g.cpu().numpy() for k, g in grads.items()}
    finally:
        config.set_compute_dtype(torch.float32)
    (lp, gp), (lm, gm) = res["plain"], res["mesh"]
    scale = max(np.abs(g).max() for g in gp.values())
    worst = max(np.abs(gm[k] - g).max()
                / max(np.abs(g).max(), 1e-3 * scale) for k, g in gp.items())
    return abs(lm - lp) / abs(lp), worst, len(gp)


def parallel_child(spec):
    """The rank of [parallel] (chip_smoke.py --parallel-child SPEC, under
    torch.distributed.run with one process): joins torchrun's world (one
    NCCL rank on cuda:0), then runs the inference CLI on the flagship
    with --data_parallel 0 on a single song and on a directory (and the
    directory with --group 1, no mesh), the training CLI with
    --data_parallel 0 for one epoch, and a one-rank mesh trainer's
    float64 gradients against the same trainer's without a mesh; every
    CLI run with the launch counts reset just before and read just
    after. Writes its readings to spec["out"] as JSON."""
    import torch.distributed as dist

    from vocal_remover_tpu_torch.nn import (
        conv_int8_kernel,
        flat_conv_kernel,
        lstm_kernel,
    )
    from vocal_remover_tpu_torch.parallel import distributed

    counters = {"lstm_recurrence": lstm_kernel, "flat_conv": flat_conv_kernel,
                "conv_int8": conv_int8_kernel}
    t0 = time.perf_counter()
    distributed.initialize()
    res = {"world": [dist.get_backend(), dist.get_world_size(),
                     str(torch.device("cuda", torch.cuda.current_device()))],
           "init_s": time.perf_counter() - t0}
    try:
        dp = ["--data_parallel", "0"]
        wall, launches = run_cli(["-P", spec["ckpt"], "-i", spec["song"],
                                  "-o", spec["single"]] + dp, counters)
        res["single"] = {"wall_s": wall, "launches": launches}
        for key, flags in (("dir", dp), ("dir_group1", ["--group", "1"])):
            wall, launches = run_cli(["-P", spec["ckpt"], "--input_dir",
                                      spec["songs"], "-o", spec[key]] + flags,
                                     counters)
            res[key] = {"wall_s": wall, "launches": launches}
        cwd = os.getcwd()
        os.makedirs(spec["train_cwd"])
        os.chdir(spec["train_cwd"])
        try:
            wall, launches, log = run_train_cli(
                ["-d", spec["data"], "--output_dir", "models", "-E", "1"]
                + TRAIN_ARGS + dp, counters, spec["train_cwd"])
        finally:
            os.chdir(cwd)
        patches = glob.glob(os.path.join(
            spec["train_cwd"],
            f"cs256_sr{SR}_hl{TRAIN_HOP}_nf{TRAIN_NFFT}_of64", "*.npz"))
        res["train"] = {"wall_s": wall, "launches": launches, "log": log,
                        "patches": len(patches)}
        t0 = time.perf_counter()
        loss_rel, worst, leaves = mesh_grads(spec["seed"])
        res["grads"] = {"loss_rel": loss_rel, "worst": worst,
                        "leaves": leaves, "wall_s": time.perf_counter() - t0}
    finally:
        distributed.shutdown()
    with open(spec["out"], "w") as f:
        json.dump(res, f)


def phase_parallel(tmp, ckpt, main_results, seed, smi):
    """[parallel]: chip_smoke.py --parallel-child under torch.distributed
    .run with one process, a world of one NCCL rank: the flagship on the
    60 s song through cli.inference --data_parallel 0 (stems within 1
    LSB of [main]'s plain run, 30 recurrence launches, wall), --input_dir
    on two songs with --data_parallel 0 against --group 1 (the same
    stems), cli.train --data_parallel 0 for one epoch at [train]'s
    settings on its songs (finite losses, recurrence 5 x validation
    chunks, none in the step), and float64 compute_grads of SMALL_NET on
    a one-rank mesh against the same trainer without one (GRAD_RTOL of
    each leaf's max |g|)."""
    from vocal_remover_tpu_torch.utils import audio

    torch.cuda.empty_cache()  # the rank is a process of its own
    phase_t0 = time.perf_counter()
    root = os.path.join(tmp, "parallel")
    songs = os.path.join(root, "songs")
    os.makedirs(songs)
    for i, seconds in enumerate(PARALLEL_DIR_SECONDS):
        audio.write_wav(os.path.join(songs, f"song{i}.wav"),
                        synth_song(seconds, seed + 20 + i), SR)
    spec = {"ckpt": ckpt, "song": os.path.join(tmp, "song.wav"),
            "songs": songs, "data": os.path.join(tmp, "train", "dataset"),
            "seed": seed, "out": os.path.join(root, "child.json")}
    for key in ("single", "dir", "dir_group1", "train_cwd"):
        spec[key] = os.path.join(root, key)
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "1", os.path.abspath(__file__),
         "--parallel-child", json.dumps(spec)],
        capture_output=True, text=True, timeout=PARALLEL_TIMEOUT_S)
    launch_s = time.perf_counter() - t0
    if r.returncode != 0:
        fail(f"[parallel] the one-rank world exited {r.returncode}:\n"
             f"{r.stdout[-3000:]}\n{r.stderr[-6000:]}")
    with open(spec["out"]) as f:
        res = json.load(f)
    backend, world, device = res["world"]
    check(backend == "nccl" and world == 1,
          f"[parallel] world {res['world']}, want one NCCL rank")

    want = 5 * main_results["want"][False]
    y, v = read_stems(spec["single"], "song")
    ref = main_results["stems"]["plain", "warm"]
    diff = max(int(np.abs(a - b).max()) for a, b in zip(ref, (y, v)))
    n = res["single"]["launches"]["lstm_recurrence"]
    check(diff <= 1, f"[parallel] --data_parallel 0 stems differ from "
                     f"[main]'s plain run by {diff} LSB > 1")
    check(n == want, f"[parallel] recurrence launched {n} times, want {want}")
    print(f"[parallel] torchrun --nproc_per_node 1 ({backend}, world "
          f"{world}, {device}; process group up in {res['init_s']:.3f} s): "
          f"cli.inference -i ({SONG_SECONDS} s song) --data_parallel 0: "
          f"{res['single']['wall_s']:.3f} s wall (first run of the "
          f"process), recurrence {n} launches (want {want}), vs [main] "
          f"plain max {diff} LSB (tol 1)", flush=True)

    names = [f"song{i}" for i in range(len(PARALLEL_DIR_SECONDS))]
    diff = max(int(np.abs(a - b).max()) for name in names
               for a, b in zip(read_stems(spec["dir"], name),
                               read_stems(spec["dir_group1"], name)))
    check(diff <= 1, f"[parallel] --input_dir --data_parallel 0 stems "
                     f"differ from --group 1's by {diff} LSB > 1")
    print(f"[parallel] cli.inference --input_dir ({len(names)} songs of "
          f"{PARALLEL_DIR_SECONDS} s, directory defaults) --data_parallel 0 "
          f"{res['dir']['wall_s']:.3f} s, --group 1 without a mesh "
          f"{res['dir_group1']['wall_s']:.3f} s, launches "
          f"{res['dir']['launches']} / {res['dir_group1']['launches']}; "
          f"stems max {diff} LSB apart", flush=True)

    tr = res["train"]
    chunks = -(-tr["patches"] // VAL_BATCH)
    check(len(tr["log"]) == 1 and np.isfinite(tr["log"]).all(),
          f"[parallel] cli.train --data_parallel 0 losses {tr['log']}")
    n = tr["launches"]["lstm_recurrence"]
    check(n == 5 * chunks, f"[parallel] train: recurrence launched {n} "
                           f"times, want 5 x {chunks} validation chunks")
    print(f"[parallel] cli.train -E 1 {' '.join(TRAIN_ARGS)} --data_parallel "
          f"0 on [train]'s songs: {tr['wall_s']:.3f} s wall, losses "
          f"{tr['log']}, recurrence {n} launches (5 x {chunks} validation "
          "chunks, none in the step)", flush=True)

    g = res["grads"]
    check(g["loss_rel"] <= 1e-12 and g["worst"] <= GRAD_RTOL,
          f"[parallel] mesh vs plain float64 gradients: loss {g['loss_rel']}"
          f", worst leaf {g['worst']} (tol {GRAD_RTOL})")
    print(f"[parallel] float64 compute_grads of CascadedNet{SMALL_NET} on a "
          f"one-rank NCCL mesh vs without a mesh: loss {g['loss_rel']:.3e} "
          f"relative, worst of {g['leaves']} leaves {g['worst']:.3e} of its "
          f"max |g| (tol {GRAD_RTOL}), {g['wall_s']:.3f} s", flush=True)
    print(f"[parallel] phase: {time.perf_counter() - phase_t0:.1f} s "
          f"(launch to exit {launch_s:.1f} s); {smi}", flush=True)


def write_pairs(root, n, seconds, seed):
    """n seeded `train_pair` songs as root/mixtures and root/instruments
    WAVs; -> (mixtures dir, instruments dir)."""
    from vocal_remover_tpu_torch.utils import audio

    dirs = [os.path.join(root, sub) for sub in ("mixtures", "instruments")]
    for d in dirs:
        os.makedirs(d)
    for i in range(n):
        for d, wave in zip(dirs, train_pair(seconds, seed + i)):
            audio.write_wav(os.path.join(d, f"song{i}.wav"), wave, SR)
    return dirs


def aligned_lengths(mix_dir, inst_dir):
    """Samples of each pair after the tools' alignment (what they
    separate)."""
    from vocal_remover_tpu_torch.data import pairing
    from vocal_remover_tpu_torch.utils import audio
    from vocal_remover_tpu_torch.utils.spec import align_wave_head_and_tail

    out = []
    for mix, inst in pairing.make_pair(mix_dir, inst_dir):
        X, y = (audio.load(p, sr=SR)[0] for p in (mix, inst))
        out.append(align_wave_head_and_tail(X, y, SR)[0].shape[-1])
    return out


def sep_chunks(lengths, batch, tta):
    """Chunks of `batch` patches a separation of songs of these lengths
    runs (crop 256; with TTA both passes), whichever path: the device
    pipeline tops its last chunk up, the spectrogram path pads to whole
    chunks."""
    roi = 256 - 2 * 64
    passes = (0, roi // 2) if tta else (0,)
    return sum(-(-patch_count(n, 256, extra) // batch)
               for n in lengths for extra in passes)


def run_tool(module, argv, counters):
    """module.main(argv) with every launch count reset just before and
    read just after, its standard output kept; -> (wall s, {kernel:
    launches}, output, peak device GiB)."""
    for wrapper in counters.values():
        wrapper.launches = 0
    said = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(said):
        module.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (wall, {k: w.launches for k, w in counters.items()},
            said.getvalue(), torch.cuda.max_memory_allocated() / 2**30)


def check_launches(label, launches, want_rec):
    for k, n in launches.items():
        want = want_rec if k == "lstm_recurrence" else 0
        check(n == want, f"{label}: {k} launched {n} times, want {want}")


def evaluate_json(ckpt, mix, inst, out, counters, flags=()):
    """The evaluate CLI with --json; -> (wall, launches, peak, JSON)."""
    from vocal_remover_tpu_torch.cli import evaluate

    wall, launches, _, peak = run_tool(
        evaluate, ["-P", ckpt, "-m", mix, "-i", inst, "--json", out]
        + list(flags), counters)
    with open(out) as f:
        res = json.load(f)
    for row in res["songs"] + [res["mean"]]:
        check(all(np.isfinite(v) for k, v in row.items() if k != "song"),
              f"evaluate {flags}: {row}")
    return wall, launches, peak, res


def phase_tools(tmp, ckpt, seed, counters, smi):
    """The tools slice ([tools]) at full width: evaluate (device pipeline,
    then --postprocess --tta) and pseudo on TOOLS_SONGS seeded pairs of
    TOOLS_SECONDS with the flagship .vrt.npz, the recurrence kernel's
    launches held to 5 a chunk; a CROSS_SECONDS pair through both on the
    card and on the CPU; augment -p -1, spec_debug and dataset_images on
    the host; and plot_log on [train]'s loss log."""
    from vocal_remover_tpu_torch.cli import (
        augment,
        dataset_images,
        plot_log,
        pseudo,
        spec_debug,
    )
    from vocal_remover_tpu_torch.utils import audio

    phase_t0 = time.perf_counter()
    root = os.path.join(tmp, "tools")
    mix, inst = write_pairs(root, TOOLS_SONGS, TOOLS_SECONDS, seed + 200)
    lengths = aligned_lengths(mix, inst)
    audio_s = sum(lengths) / SR
    print(f"[tools] {TOOLS_SONGS} pairs of {TOOLS_SECONDS} s stereo {SR} Hz "
          f"(train_pair), {audio_s:.2f} s aligned; flagship {ckpt}",
          flush=True)

    # evaluate: the device pipeline (first; a warm repeat was dropped for
    # time), then the spectrogram path with merge_artifacts and TTA, warm
    # (the same chunks of 8 the run before it launched)
    for flags, runs in (([], ("first",)),
                        (["--postprocess", "--tta"], ("warm",))):
        tta = "--tta" in flags
        chunks = sep_chunks(lengths, EVAL_BATCH, tta)
        for run in runs:
            wall, launches, peak, res = evaluate_json(
                ckpt, mix, inst, os.path.join(root, "eval.json"), counters,
                flags)
            label = f"evaluate {' '.join(flags) or '(device pipeline)'} {run}"
            check(len(res["songs"]) == TOOLS_SONGS, f"{label}: {res}")
            check_launches(label, launches, 5 * chunks)
            m = res["mean"]
            print(f"[tools] {label}: {wall:.3f} s wall, "
                  f"{audio_s / wall:.2f} x real time, launches {launches} "
                  f"(5 x {chunks} chunks of {EVAL_BATCH}), peak "
                  f"{peak:.2f} GiB; mean SDR inst "
                  f"{m['instrumental_sdr']:.4f} / vocal {m['vocal_sdr']:.4f} "
                  f"dB, SI-SDR {m['instrumental_si_sdr']:.4f} / "
                  f"{m['vocal_si_sdr']:.4f}, median "
                  f"{m['instrumental_median_sdr']:.4f} / "
                  f"{m['vocal_median_sdr']:.4f}; {smi}", flush=True)

    # pseudo: TTA on the vocal spectrogram of each pair
    out = os.path.join(root, "pseudo")
    chunks = sep_chunks(lengths, PSEUDO_BATCH, True)
    wall, launches, _, peak = run_tool(
        pseudo, ["-P", ckpt, "-m", mix, "-i", inst, "-o", out], counters)
    check_launches("pseudo", launches, 5 * chunks)
    for i, n in enumerate(lengths):
        z = np.load(os.path.join(out, f"song{i}_PseudoInstruments.npy"))
        check(z.dtype == np.complex64 and z.shape == (
            2, 1025, 1 + n // 1024) and np.isfinite(z).all(),
            f"pseudo song{i}: {z.dtype} {z.shape}")
        check(os.path.exists(os.path.join(
            out, f"song{i}_PseudoInstruments.wav")), "pseudo: no placeholder")
    print(f"[tools] pseudo: {wall:.3f} s wall, {wall / TOOLS_SONGS:.3f} s a "
          f"song, launches {launches} (5 x {chunks} chunks of "
          f"{PSEUDO_BATCH}), peak {peak:.2f} GiB, outputs (2, 1025, T) "
          f"complex64; {smi}", flush=True)

    # one short pair on the card and on the CPU (plain recurrence), at
    # batch 2: the CPU runs no zero-padded patches
    cmix, cinst = write_pairs(os.path.join(root, "cross"), 1,
                              CROSS_SECONDS, seed + 300)
    res, z = {}, {}
    for gpu in ("0", "-1"):
        _, _, _, res[gpu] = evaluate_json(
            ckpt, cmix, cinst, os.path.join(root, f"cross{gpu}.json"),
            counters, ["--gpu", gpu, "-B", "2"])
        d = os.path.join(root, f"cross-pseudo{gpu}")
        run_tool(pseudo, ["-P", ckpt, "-m", cmix, "-i", cinst, "-o", d,
                          "--gpu", gpu, "-B", "2"], counters)
        z[gpu] = np.load(os.path.join(d, "song0_PseudoInstruments.npy"))
    db = max(abs(res["0"]["songs"][0][k] - v)
             for k, v in res["-1"]["songs"][0].items() if k != "song")
    rel = float(np.abs(z["0"] - z["-1"]).max() / np.abs(z["-1"]).max())
    check(db <= EVAL_CROSS_DB, f"evaluate card vs CPU: {db} dB")
    check(rel <= PSEUDO_CROSS_TOL, f"pseudo card vs CPU: {rel}")
    print(f"[tools] {CROSS_SECONDS} s pair at -B 2, card vs CPU: "
          f"evaluate's six metrics within {db:.3g} dB (tol {EVAL_CROSS_DB}), "
          f"pseudo's .npy within {rel:.3g} of its largest |z| (tol "
          f"{PSEUDO_CROSS_TOL})", flush=True)

    # the host tools; augment on the first pair alone
    amix, ainst = (os.path.join(root, "augment", sub)
                   for sub in ("mixtures", "instruments"))
    for src, dst in ((mix, amix), (inst, ainst)):
        os.makedirs(dst)
        os.link(os.path.join(src, "song0.wav"),
                os.path.join(dst, "song0.wav"))
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        augment.main(["-m", amix, "-i", ainst, "-p", "-1"])
    wall = time.perf_counter() - t0
    sub = f"sr{SR}_hl1024_nf2048"
    for d in (amix, ainst):
        z = np.load(os.path.join(d, sub, "song0_pitch-1.npy"))
        check(z.dtype == np.complex64 and z.shape[:2] == (2, 1025)
              and np.isfinite(z).all(), f"augment: {z.dtype} {z.shape}")
    print(f"[tools] augment -p -1 (built-in phase vocoder + kaiser_fast "
          f"resample, host only) on one {TOOLS_SECONDS} s pair: {wall:.3f} s "
          f"wall", flush=True)

    ext = ".jpg" if importlib.util.find_spec("PIL") else ".png"
    cwd = os.getcwd()
    os.makedirs(os.path.join(root, "spec_debug"))
    os.chdir(os.path.join(root, "spec_debug"))
    try:
        t0 = time.perf_counter()
        spec_debug.main([os.path.join(mix, "song0.wav"),
                         os.path.join(inst, "song0.wav")])
        wall = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    n_frames = 1 + lengths[0] // 1024
    for s in "Xyv":
        img = read_image(os.path.join(root, "spec_debug", f"test_{s}{ext}"))
        check(img.shape == (1025, n_frames, 3),
              f"spec_debug test_{s}{ext}: {img.shape}")
        w, sr = audio.read_wav(os.path.join(root, "spec_debug",
                                            f"test_{s}.wav"))
        check(sr == SR and w.shape == (2, lengths[0] // 1024 * 1024),
              f"spec_debug test_{s}.wav: {w.shape}")
    print(f"[tools] spec_debug (host): {wall:.3f} s wall, test_{{X,y,v}}"
          f"{ext} of (1025, {n_frames}, 3) and three WAVs", flush=True)

    t0 = time.perf_counter()
    dataset_images.main([mix, inst, os.path.join(root, "images")])
    wall = time.perf_counter() - t0
    for i, n in enumerate(lengths):
        img = read_image(os.path.join(root, "images", f"song{i}_Vocal{ext}"))
        check(img.shape == (1025, 1 + n // 1024, 3),
              f"dataset_images song{i}: {img.shape}")
    print(f"[tools] dataset_images (host, spectrogram cache made in the "
          f"run): {wall:.3f} s wall, {TOOLS_SONGS} images{ext}", flush=True)

    logs = sorted(glob.glob(os.path.join(tmp, "train", "loss_*.json")),
                  key=os.path.getmtime)
    png = os.path.join(root, "loss.png")
    said = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(said):
        try:
            plot_log.main([logs[0], png])
        except SystemExit as e:
            code = e.code
    lines = said.getvalue().splitlines()
    check(lines and lines[0].startswith("epochs: ")
          and " best val: " in lines[0], f"plot_log: {lines}")
    if code == 0:
        with open(png, "rb") as f:
            check(f.read(8) == b"\x89PNG\r\n\x1a\n", "plot_log: no PNG")
        outcome = f"{os.path.getsize(png)} bytes of PNG written"
    else:
        check("matplotlib" in str(code) and not os.path.exists(png),
              f"plot_log: exit {code!r}")
        outcome = f"no matplotlib here: exits with {code!r}"
    print(f"[tools] plot_log {os.path.basename(logs[0])}: {lines[0]!r}; "
          f"{outcome}", flush=True)
    print(f"[tools] phase: {time.perf_counter() - phase_t0:.1f} s",
          flush=True)


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
    p.add_argument("--parallel-child", default=None, help=argparse.SUPPRESS)
    args = p.parse_args()

    if not torch.cuda.is_available():
        fail("no CUDA device")
    if args.parallel_child is not None:
        parallel_child(json.loads(args.parallel_child))
        return
    try:
        from vocal_remover_tpu_torch.nn import (
            config,
            conv_chw_kernel,
            conv_int8_kernel,
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
    # packed convs; 5 band nets x 19 int8 convs + the two low-band
    # squeezes; none for the three channel-major conv kernels, which
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
    }, {
        "name": "conv_int8",
        "route": "cuda",
        "source": "vocal_remover_tpu_torch/csrc/conv_int8.cu",
        # no TPU kernel: the JAX package's int8 conv is XLA's
        "replaces": "vocal_remover_tpu/nn/functional.py:24",
        "wrapper": conv_int8_kernel,
        "per_chunk": 97,
    }]
    counters = {k["name"]: k["wrapper"] for k in kernels}

    # each phase's wall, for the time limit: (label, clock after it)
    marks = [("start", time.perf_counter())]

    def mark(label):
        marks.append((label, time.perf_counter()))

    name, smi = phase_card()
    config.set_precision("highest")
    # the native decoders (gcc) build beside the kernels (nvcc)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        native = pool.submit(phase_native_build)
        phase_build(kernels)
        native.result()
    mark("build")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rec_rows = phase_recurrence(gen)
    flat_rows = phase_flat_conv(args.seed)
    torch.cuda.empty_cache()
    chw_rows = phase_chw_convs(args.seed)
    torch.cuda.empty_cache()
    int8_rows = phase_int8_kernel(int8_flagship(args.seed), args.seed)
    torch.cuda.empty_cache()
    mark("kernel")

    with tempfile.TemporaryDirectory() as tmp:
        per_chunk = {k["name"]: k["per_chunk"] for k in kernels}
        ckpt, results = phase_main_path(tmp, args.seed, counters, per_chunk)
        phase_reference(tmp, ckpt, args.seed)
        mark("main")
        phase_spec(tmp, ckpt, args.seed, counters, per_chunk, smi)
        mark("spec")
        dir_run = phase_dir(tmp, ckpt, args.seed, counters, per_chunk)
        mark("dir")
        phase_stream(tmp, ckpt, args.seed, counters, per_chunk)
        mark("stream")
        int8_launches = phase_int8(tmp, ckpt, args.seed, counters, per_chunk,
                                   results, dir_run)
        mark("int8")
        phase_export(tmp, ckpt, args.seed, counters, per_chunk, smi, dir_run)
        mark("export")
        train_launches = phase_train(tmp, args.seed, counters, smi)
        mark("train")
        phase_library(tmp, args.seed, counters, smi,
                      results["stems"]["plain", "warm"])
        mark("library")
        phase_parallel(tmp, ckpt, results, args.seed, smi)
        mark("parallel")
        phase_tools(tmp, ckpt, args.seed, counters, smi)
        mark("tools")
        if args.profile:
            phase_profile(ckpt, args.seed)
            mark("profile")
    lab_launches = phase_lab(counters)
    mark("lab")
    print("[time] " + ", ".join(
        f"{label} {t - marks[i][1]:.1f} s" for i, (label, t) in
        enumerate(marks[1:])) + f"; total {marks[-1][1] - marks[0][1]:.1f} s",
        flush=True)

    # one record per kernel. The two kernels of the model: launches of
    # the recurrence on this slice's path (the training CLI's first run:
    # its validation passes; the train step runs the plain loop) and of
    # the flat conv on the --flat_conv path (warm run), largest error
    # over the f32 cases, times at the flagship's largest launch
    # (recurrence T = 128, 2N = 8, H = 64; flat conv stg3_full_band_net
    # enc2_conv2 in f32). The three channel-major
    # conv kernels: launches on the lab path, error and times at the
    # lab's first shape in its default dtype (bf16).
    launches = dict(results["flat", "warm"]["launches"])
    launches["lstm_recurrence"] = train_launches
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
    # the int8 conv: launches of the int8 CLI's warm run on the 60 s song,
    # times and bound summed over one chunk's 97 convs at crop 256, batch
    # 4, error over every geometry at both crops
    launches["conv_int8"] = int8_launches
    shown["conv_int8"] = (int8_rows[256], list(int8_rows.values()))
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
