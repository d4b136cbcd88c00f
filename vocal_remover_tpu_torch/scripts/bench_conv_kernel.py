"""The channel-major fused conv kernel against the library's convolution
on one NVIDIA card.

Counterpart of scripts/bench_conv_kernel.py. Runs a chain of `--len`
identical conv + bias + leaky_relu layers for each implementation and
prints ms/conv, GB/s (input + output once) and TF/s:
  kernel     nn/conv_chw.py `fused_conv_chw` (csrc/conv_chw.cu, variant A:
             tap groups on the tensor cores, mma.sync; 3xTF32 in float32)
  lib_nhwc   torch.nn.functional.conv2d on channels_last tensors
  lib_nchw   torch.nn.functional.conv2d on contiguous NCHW tensors
  lib_taps   nine shifted (M, Cin) @ (Cin, Cout) products in NHWC
The library routes are yardsticks of this tool only; nothing else in the
package calls them in place of a kernel. They run with TF32 off, so that
in float32 they compute what the kernel computes.

Run:  python -m vocal_remover_tpu_torch.scripts.bench_conv_kernel [--len 16]
Runs on the card and raises without one; `--device cpu` runs the kernel's
plain version (a check of the plumbing, not a measurement).
"""

from __future__ import annotations

import argparse

import torch

from vocal_remover_tpu_torch import resolve_device
from vocal_remover_tpu_torch.nn import config
from vocal_remover_tpu_torch.nn.conv_chw import fused_conv_chw, prepare_weights_s1
from vocal_remover_tpu_torch.scripts.conv_kernel_lab import (
    DTYPES,
    make_inputs,
    parse_shapes,
    time_chain,
)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--len", type=int, default=16, dest="length")
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=sorted(DTYPES))
    p.add_argument("--repeat", type=int, default=4)
    p.add_argument("--shapes", type=str,
                   default="8,32,1024,256;8,64,512,128")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default; raises without a card) or cpu "
                        "(plain version of the kernel)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    dt = DTYPES[args.dtype]
    conv2d = torch.nn.functional.conv2d
    leaky = torch.nn.functional.leaky_relu
    results = []
    for n, c, h, w in parse_shapes(args.shapes):
        x0, wk, b = make_inputs(n, c, h, w)
        w2, taps, pad = prepare_weights_s1(wk)
        w2 = torch.from_numpy(w2).to(device, dt)
        bias = torch.from_numpy(b).to(device)
        bias_dt = bias.to(dt)
        w_hwio = torch.from_numpy(wk).to(device, dt)
        w_oihw = w_hwio.permute(3, 2, 0, 1).contiguous()
        w_oihw_cl = w_oihw.contiguous(memory_format=torch.channels_last)
        x_chw = torch.from_numpy(x0).to(device, dt)
        x_cl = x_chw.contiguous(memory_format=torch.channels_last)
        x_nhwc = x_chw.permute(0, 2, 3, 1).contiguous()

        def kernel(y):
            return fused_conv_chw(y, w2, bias, taps, pad, act="leaky_relu")

        def lib_nhwc(y):
            return leaky(conv2d(y, w_oihw_cl, bias_dt, padding=1), 0.01)

        def lib_nchw(y):
            return leaky(conv2d(y, w_oihw, bias_dt, padding=1), 0.01)

        def lib_taps(y):
            nb, hh, ww, cc = y.shape
            yp = torch.nn.functional.pad(y, (0, 0, 1, 1, 1, 1))
            acc = None
            for dy in range(3):
                for dx in range(3):
                    d = yp[:, dy:dy + hh, dx:dx + ww].reshape(-1, cc) \
                        @ w_hwio[dy, dx]
                    acc = d.float() if acc is None else acc + d.float()
            out = leaky(acc + bias, 0.01).to(y.dtype)
            return out.reshape(nb, hh, ww, -1)

        gb = 2 * x0.size * x_chw.element_size() / 1e9
        fl = 2 * 9 * n * h * w * c * c
        for name, fn, xin in (("kernel  ", kernel, x_chw),
                              ("lib_nhwc", lib_nhwc, x_cl),
                              ("lib_nchw", lib_nchw, x_chw),
                              ("lib_taps", lib_taps, x_nhwc)):
            with config.full_float32(), torch.inference_mode():
                per = time_chain(fn, xin, args.length, args.repeat, device)
            results.append({"shape": (n, c, h, w), "route": name.strip(),
                            "ms": per})
            print(f"({n},{c},{h},{w}) {args.dtype} on {device.type} {name}: "
                  f"{per:7.3f} ms/conv  {gb / (per / 1e3):6.0f} GB/s  "
                  f"{fl / (per / 1e3) / 1e12:6.1f} TF/s", flush=True)
    return results


if __name__ == "__main__":
    main()
