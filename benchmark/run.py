"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload serve-single-f32 --seed 7 \\
        --seconds 40 --trace 0

Run from the root of a checkout on a machine with NVIDIA cards. The last
line of standard output is the result, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer metrics), `device`, with `--trace 1` a
`breakdown`, and last `checks`, each number compared for `correct`
beside its limit; the same numbers are the last lines of standard error.
Without a card, with fewer cards than the cell asks for, or with JAX or
the JAX package loaded once the window has closed, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the JAX side of the repository: never loaded by a run
FORBIDDEN = ("jax", "jaxlib", "flax", "vocal_remover_tpu")


def loaded_forbidden(modules=None) -> list[str]:
    """Top-level names in `modules` (default sys.modules) that belong to
    JAX or the JAX package, each compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def cache_dirs():
    """Keep every build and kernel cache of the program inside the
    checkout, at fixed paths: the port builds its CUDA kernels and native
    extension under build/ by itself; PyTorch's extension builds and
    Triton's kernels, should the port come to use them, go beside."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cache_dirs()
    import torch

    from benchmark import harness

    files = harness.cell_files(args.workload)
    chips = files["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"cell {args.workload} needs {chips} CUDA card(s); this "
              f"machine has {have}: nothing measured", file=sys.stderr)
        return 2
    result, run = harness.execute(args.workload, args.seed, args.seconds,
                                  bool(args.trace), torch.device("cuda", 0),
                                  t_start=T_START)
    found = loaded_forbidden()
    if found:
        print(f"JAX side loaded in the measuring process: {found}",
              file=sys.stderr)
        return 3
    harness.report_checks(run)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
