"""Conv kernel lab: the three hand-written channel-major conv kernels
side by side on one NVIDIA card.

Counterpart of scripts/conv_kernel_lab.py. All candidates compute the
same fused 3x3 stride-1 'SAME' conv + bias + leaky_relu in (N, C, H, W)
layout and differ in where the tap shifts happen:
  A  tap groups: D's design on a tap table of any length (any kernel
     size, stride 2 through space_to_depth); the taps are cut into groups
     of one channel block and at most 3 x 4 (dy, dx), each group's box
     staged channel-innermost once a step and read at each tap's offset
     by tensor-core products (mma.sync; 3xTF32 in float32)
     (nn/conv_chw.py `fused_conv_chw`, csrc/conv_chw.cu).
  C  output-shift: the unshifted dy-stack of the input is staged once and
     each staged column meets the weights of all three dx, in three
     tensor-core products (mma.sync; 3xTF32 in float32); the three partial
     sums are aligned on the output side with warp shuffles of the
     accumulator fragments (csrc/conv_shift.cu).
  D  tap-dot: one input tile a block staged channel-innermost, nine
     accumulating K = Cin tensor-core products (mma.sync; 3xTF32 in
     float32), each reading the tile at its tap's (dy, dx) offset
     (csrc/conv_tapdot.cu).

Run:  python -m vocal_remover_tpu_torch.scripts.conv_kernel_lab [--shapes ...]
Each candidate runs as a chain of `--len` identical layers; a single
layer is checked against torch.nn.functional.conv2d + bias + leaky_relu
before timing. Runs on the card (CUDA events after a synchronize) and
raises without one; `--device cpu` runs the kernels' plain versions (a
check of the plumbing, not a measurement).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from vocal_remover_tpu_torch import resolve_device
from vocal_remover_tpu_torch.nn import config, conv_shift_kernel, conv_tapdot_kernel
from vocal_remover_tpu_torch.nn.conv_chw import fused_conv_chw, prepare_weights_s1

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def weights_c(wk, dtype):
    """HWIO (3,3,cin,cout) -> (3*3*cin, cout) rows ordered [dx][dy][ci]."""
    wk = np.asarray(wk)
    rows = [wk[dy, dx] for dx in range(3) for dy in range(3)]
    return torch.from_numpy(np.concatenate(rows, 0)).to(dtype)


def weights_d(wk, dtype):
    """rows ordered [(dy,dx)][ci] (same as variant A's im2col matrix)."""
    wk = np.asarray(wk)
    kh, kw, cin, cout = wk.shape
    return torch.from_numpy(wk.reshape(9 * cin, cout).copy()).to(dtype)


def call_c(x, w2, b2, act, out_dtype):
    """Variant C on the lab's operands: x (N, C, H, W) unpadded, w2 from
    `weights_c`, b2 (Cout, 1) float32, act True = leaky_relu(0.01)."""
    return conv_shift_kernel.conv_shift(
        x, w2, b2.reshape(-1), act="leaky_relu" if act else None,
        out_dtype=out_dtype)


def call_d(x, w2, b2, act, out_dtype):
    """Variant D on the lab's operands (w2 from `weights_d`)."""
    return conv_tapdot_kernel.conv_tapdot(
        x, w2, b2.reshape(-1), act="leaky_relu" if act else None,
        out_dtype=out_dtype)


def parse_shapes(spec):
    return [tuple(int(v) for v in s.split(",")) for s in spec.split(";")]


def make_inputs(n, c, h, w):
    """The lab's inputs: x, HWIO weights (Cout = Cin) and bias from
    numpy's default_rng(0)."""
    rng = np.random.default_rng(0)
    x0 = (rng.standard_normal((n, c, h, w)) * 0.1).astype(np.float32)
    wk = (rng.standard_normal((3, 3, c, c)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(c) * 0.01).astype(np.float32)
    return x0, wk, b


def time_chain(step, x, length, repeat, device):
    """One warm-up chain, then the best of `repeat` chains of `length`
    layers; -> ms per layer. CUDA events on the card, the host clock on
    the CPU."""
    def chain():
        y = x
        for _ in range(length):
            y = step(y)
        return y

    chain()
    best = float("inf")
    for _ in range(repeat):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            chain()
            end.record()
            torch.cuda.synchronize(device)
            best = min(best, start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            chain()
            best = min(best, (time.perf_counter() - t0) * 1e3)
    return best / length


def check_error(name, err, scale, dtype):
    """The single-layer check: float32 within 1e-4 of the reference
    (another summation order), bfloat16 within 2^-6 of the largest
    output (the output's own rounding plus the inputs')."""
    tol = 1e-4 * max(1.0, scale) if dtype == torch.float32 \
        else 2.0 ** -6 * max(1.0, scale)
    if not err <= tol:
        raise RuntimeError(f"{name}: max error {err:.3e} against conv2d "
                           f"exceeds {tol:.3e}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--len", type=int, default=16, dest="length")
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=sorted(DTYPES))
    p.add_argument("--repeat", type=int, default=4)
    p.add_argument("--th", type=int, default=32,
                   help="tile height of the TPU lab; accepted and ignored "
                        "(the CUDA kernels choose their own tiles)")
    p.add_argument("--variants", type=str, default="A,C,D")
    p.add_argument("--shapes", type=str,
                   default="8,32,1024,256;8,64,512,128")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default; raises without a card) or cpu "
                        "(plain versions of the kernels)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    dt = DTYPES[args.dtype]
    results = []
    for n, c, h, w in parse_shapes(args.shapes):
        print(f"=== shape (N={n}, C={c}, H={h}, W={w}) {args.dtype} on "
              f"{device.type} ===", flush=True)
        x0, wk, b = make_inputs(n, c, h, w)
        flops = 2 * 9 * c * c * n * h * w
        x32 = torch.from_numpy(x0).to(device)
        bias = torch.from_numpy(b).to(device)
        # the reference for numerics: the library's conv in full float32
        with config.precision("highest"):
            ref = torch.nn.functional.leaky_relu(
                torch.nn.functional.conv2d(
                    x32, torch.from_numpy(wk).to(device).permute(3, 2, 0, 1),
                    bias, padding=1), 0.01)
        scale = ref.abs().max().item()
        x = x32.to(dt)
        b2 = bias.reshape(-1, 1)

        variants = {}
        if "A" in args.variants:
            w2a, taps, pad = prepare_weights_s1(wk)
            w2a = torch.from_numpy(w2a).to(device, dt)
            variants["A tap groups"] = lambda y: fused_conv_chw(
                y, w2a, bias, taps, pad, act="leaky_relu", out_dtype=dt)
        if "C" in args.variants:
            w2c = weights_c(wk, dt).to(device)
            variants["C output-shift"] = lambda y: call_c(y, w2c, b2, True, dt)
        if "D" in args.variants:
            w2d = weights_d(wk, dt).to(device)
            variants["D tap-dots"] = lambda y: call_d(y, w2d, b2, True, dt)

        for name, step in variants.items():
            err = (step(x).float() - ref).abs().max().item()
            check_error(name, err, scale, dt)
            ms = time_chain(step, x, args.length, args.repeat, device)
            results.append({"shape": (n, c, h, w), "variant": name[0],
                            "ms": ms, "max_err": err})
            print(f"{name:24s} {ms:7.3f} ms/conv  "
                  f"{flops / (ms * 1e-3) / 1e12:6.2f} TF/s   "
                  f"maxerr={err:.2e} (scale {scale:.1f})", flush=True)
    return results


if __name__ == "__main__":
    main()
