"""Time the inference CLI's `load model` stage on one NVIDIA card, part
by part, for the flagship CascadedNet(2048, 1024, 32, 128) with random
weights from a seed.

The stage (cli/inference.py) reads the checkpoint (`convert.load_model`),
applies the serving transform (`serving.serving_variables`: BN fold, the
packing of enc2 / enc3 with their walk tables, the bf16 cast) and moves
the model to the card (`Separator`). Each repeat runs all three in this
process and prints one JSON line: the seconds of each part, of the
whole, and of the garbage collector's passes inside it. The CUDA context
is made before the first repeat, as a CLI run that has separated before
has it; the first repeat is what such a run pays, later ones are warm.

Run:  python -m vocal_remover_tpu_torch.scripts.time_model_load
          [--repeat 3] [--precision bfloat16] [--no-flat_conv] [--seed 0]
Runs on the card and raises without one.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import tempfile
import time

import torch


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--repeat", type=int, default=3)
    p.add_argument("--precision", default="bfloat16",
                   choices=("highest", "default", "bfloat16"))
    p.add_argument("--no-flat_conv", dest="flat_conv", action="store_false")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("time_model_load measures on a card: no CUDA "
                           "device")

    from vocal_remover_tpu_torch.models import convert, serving
    from vocal_remover_tpu_torch.models.cascaded import CascadedNet
    from vocal_remover_tpu_torch.separate.separator import Separator

    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    gc_s, gc_t0 = [0.0], [0.0]

    def on_gc(phase, info):
        if phase == "start":
            gc_t0[0] = time.perf_counter()
        else:
            gc_s[0] += time.perf_counter() - gc_t0[0]

    with tempfile.TemporaryDirectory() as tmp:
        model = CascadedNet(2048, 1024, 32, 128,
                            generator=torch.Generator().manual_seed(args.seed))
        ckpt = os.path.join(tmp, "flagship.vrt.npz")
        convert.save_native(ckpt, convert.to_jax_variables(model),
                            convert.model_config(model))
        del model
        gc.callbacks.append(on_gc)
        for rep in range(args.repeat):
            gc_s[0] = 0.0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model = convert.load_model(ckpt, 2048, 1024, 32, 128)
            t1 = time.perf_counter()
            if args.precision == "bfloat16" or args.flat_conv:
                model = serving.serving_variables(
                    model,
                    "bfloat16" if args.precision == "bfloat16" else None,
                    flat=args.flat_conv)
            t2 = time.perf_counter()
            sp = Separator(model, device="cuda", precision=args.precision)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            print(json.dumps({
                "repeat": rep, "precision": args.precision,
                "flat_conv": args.flat_conv, "load_model_s": t1 - t0,
                "serving_s": t2 - t1, "separator_s": t3 - t2,
                "stage_s": t3 - t0, "gc_s": gc_s[0]}), flush=True)
            del model, sp
        gc.callbacks.remove(on_gc)


if __name__ == "__main__":
    main()
