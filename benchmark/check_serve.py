"""Whether the stems a serving window produced are correct.

The reference (benchmark/reference/serve.py, float32 with TF32 off) runs
once over each sampled song from the benchmark's own weights and PCM,
and each stem the program produced is compared with the reference's:
  * `nsr`: the power of the difference over the power of the reference
    stem (noise-to-signal ratio), worst stem of the sampled songs, over
    the samples the reference writes (all but the song's last hop at
    most). PCM16 stems of a sound float32 run differ from the reference
    by rounding flips of one LSB in a few samples in a thousand; a
    power, and not an RMS, keeps the control's few more flips apart from
    them.
Each number has its limit in benchmark/limits/<cell>.json.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import weights
from benchmark.reference import serve as ref_serve
from benchmark.reference.precision import tf32

HOP_SLACK = 4096  # samples a stem may run past the reference's end (a hop)


def reference_stems(config, state_dict, traffic, songs, device,
                    allow_tf32=False):
    """{index: (instruments, vocals)} int16 host stems of the reference
    for `songs` ({index: int16 (2, n) host song}); `allow_tf32` is the
    control's precision."""
    model = weights.reference_model(config, device, state_dict).eval()
    bucket = int(traffic.get("bucket_s", 0) * config["sr"])
    out = {}
    with tf32(allow_tf32):
        for i, song in songs.items():
            y, v = ref_serve.separate(
                model, torch.from_numpy(song).to(device), traffic["cropsize"],
                traffic["batchsize"], bucket,
                traffic.get("vocals_residual", False))
            out[i] = (y.cpu().numpy(), v.cpu().numpy())
    return out


def nsr(a: np.ndarray, ref: np.ndarray) -> float:
    d = a.astype(np.float64) - ref.astype(np.float64)
    power = np.mean(ref.astype(np.float64) ** 2)
    return float(np.mean(d * d) / max(power, 1.0))


def numbers(stems: dict, ref: dict) -> dict:
    """The compared numbers of program `stems` against `ref` (both
    {index: (instruments, vocals)}), worst over songs and stems."""
    worst = 0.0
    for i, pair in ref.items():
        for got, want in zip(stems[i], pair):
            m = want.shape[1]
            if got is None or got.shape[0] != want.shape[0] or \
                    not m <= got.shape[1] <= m + HOP_SLACK:
                return {"nsr": float("inf")}
            worst = max(worst, nsr(got[:, :m], want))
    return {"nsr": worst}


def sample(finished: list[int], lengths: list[int], seed: int,
           count: int) -> list[int]:
    """Pool indices of `count` finished songs to check: the longest that
    finished, and the rest drawn from `seed` among the others."""
    done = sorted(set(finished))
    longest = max(done, key=lambda i: lengths[i])
    rest = [i for i in done if i != longest]
    rng = np.random.default_rng(weights.sub_seed(seed, 0xC4E))
    pick = list(rng.choice(rest, size=min(count - 1, len(rest)),
                           replace=False)) if rest else []
    return [longest] + [int(i) for i in pick]
