"""The upper readings that the limits of `correct` are set from, on the
chip: the control and the planted faults. The program's own (lower)
readings are those of `run.py`'s result lines (`checks`).

    python3 benchmark/calibrate.py --workload serve-single-f32 \\
        --seeds 11,12,13 --control
    python3 benchmark/calibrate.py --workload train-b4-f32 \\
        --seeds 11,12,13 --control --fault half_batch --fault stale_batch

For each seed, in one process, the cell's inputs from that seed, then:
  * `--control`: the reference in the precision below the
    configuration's (float32 cells: TF32), in the program's place,
    against the reference. Serving: on the songs a run checks (the
    pool's longest and one drawn from the seed; a window finishes every
    song of these pools, the single-song cell's last few aside).
    Training: on the batches of the cell's own first steps (its driver's
    set-up, as a run makes them);
  * `--fault NAME` (training): the cell's set-up with a fault of
    benchmark/faults.py planted under it, against the reference.
One JSON line a seed and reading on standard output. Not run by the
benchmark's runs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import (  # noqa: E402
    check_serve,
    check_train,
    faults,
    harness,
    serve_common,
)


def serve_control(r) -> dict:
    songs, lengths, sd = serve_common.inputs(r)
    chosen = check_serve.sample(list(range(len(songs))), lengths, r.seed,
                                r.traffic["check_songs"])
    picked = {i: songs[i] for i in chosen}
    ref = check_serve.reference_stems(r.config, sd, r.traffic, picked,
                                      r.device)
    low = check_serve.reference_stems(r.config, sd, r.traffic, picked,
                                      r.device, allow_tf32=True)
    return {"reading": "control: reference with TF32",
            "songs_s": [lengths[i] / r.config["sr"] for i in chosen],
            "numbers": check_serve.numbers(low, ref)}


def train_setup(r, fault=None):
    """The cell's set-up (its first steps and what they trained on),
    with `fault` planted under it; the trainer is freed."""
    import torch

    train_loop = harness.driver("train_loop")
    planted = getattr(faults, fault)() if fault else None
    if planted is None:
        p = train_loop.prepare(r)
    else:
        with planted as hits:
            p = train_loop.prepare(r)
        p["fault_hits"] = hits
    p["batches"].close()
    del p["trainer"]
    torch.cuda.empty_cache()
    return p


def train_readings(r, control: bool, fault_names) -> list[dict]:
    train_loop = harness.driver("train_loop")
    out = []
    if control:
        p = train_setup(r)
        ref = train_loop.reference(r, p)
        low = train_loop.reference(r, p, allow_tf32=True)
        as_program = {"losses": low[0], "grads": low[1], "change": low[2],
                      "feed": low[4]}
        out.append({"reading": "control: reference with TF32",
                    "numbers": check_train.numbers(as_program, ref),
                    "detail": check_train.detail(as_program, ref)})
    for name in fault_names:
        p = train_setup(r, name)
        ref = train_loop.reference(r, p)
        out.append({"reading": f"fault: {name}",
                    "numbers": check_train.numbers(p["readings"], ref),
                    "detail": check_train.detail(p["readings"], ref),
                    "fault_hits": p.get("fault_hits")})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", action="append", default=[],
                    choices=("half_batch", "stale_batch"))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: nothing calibrated", file=sys.stderr)
        return 2
    files = harness.cell_files(args.workload)
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = harness.Run(files, seed, 0.0, False, device, t0)
        if files["traffic"]["driver"] == "train_loop":
            out = train_readings(r, args.control, args.fault)
        else:
            out = [serve_control(r)] if args.control else []
        for reading in out:
            reading.update(workload=args.workload, seed=seed,
                           seconds=time.perf_counter() - t0)
            print(json.dumps(reading), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
