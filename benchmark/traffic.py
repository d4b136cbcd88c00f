"""The general traffic generator: songs and training pairs from a traffic
file's parameters and the run's seed.

Every seed gets the same songs' lengths (`pool` quantiles of the length
distribution) in the same order (the traffic file's `order` of pool
indices, cycled), so that no seed changes the amount or the mix of
work that a window holds; the seed makes the audio (and the weights).
Audio is made on the device in float64 phase arithmetic, then handed to
the host as int16 PCM, as a decoded WAV would be.

Song content: a stereo mix of `tones` sinusoids (log-uniform 55 Hz to
8 kHz, each with its own level and a slow tremolo) over white noise 30 dB
down, peak-normalised to -6 dBFS: a broadband, dynamic signal, so that
every band net sees energy and the stems are far from silent.
"""

from __future__ import annotations

import math
import os
from statistics import NormalDist

import numpy as np
import torch

from benchmark.reference.serve import to_pcm16
from benchmark.weights import sub_seed

SONGS_STREAM = 0x50C
PAIRS_STREAM = 0x7A1


def pool_lengths(songs: dict, sr: int) -> list[int]:
    """Sample counts of the pool: `pool` quantiles (i + 0.5) / pool of a
    log-normal with `median_s` and `sigma`, clipped to [min_s, max_s]."""
    n = songs["pool"]
    out = []
    for i in range(n):
        z = NormalDist().inv_cdf((i + 0.5) / n)
        s = songs["median_s"] * math.exp(songs["sigma"] * z)
        s = min(max(s, songs["min_s"]), songs["max_s"])
        out.append(int(round(s * sr)))
    return out


def _wave(n: int, sr: int, tones: int, g: torch.Generator, device):
    """(2, n) float32 song in [-0.5, 0.5] made on `device`."""
    f = 55.0 * (8000.0 / 55.0) ** torch.rand(2, tones, 1, generator=g,
                                             device=device,
                                             dtype=torch.float64)
    level = torch.rand(2, tones, 1, generator=g, device=device,
                       dtype=torch.float64)
    rate = 0.2 + 2.0 * torch.rand(2, tones, 1, generator=g, device=device,
                                  dtype=torch.float64)
    t = torch.arange(n, device=device, dtype=torch.float64) / sr
    x = torch.zeros(2, n, device=device, dtype=torch.float64)
    for k in range(tones):  # one tone at a time: (2, n) temporaries
        phase = torch.frac(f[:, k] * t)  # in cycles: exact over minutes
        trem = 0.6 + 0.4 * torch.sin(2 * math.pi * torch.frac(rate[:, k] * t))
        x += level[:, k] * trem * torch.sin(2 * math.pi * phase)
    x = x.float()
    x += 0.03 * x.abs().amax() * torch.randn(2, n, generator=g, device=device)
    return 0.5 * x / x.abs().amax()


def make_songs(lengths: list[int], sr: int, tones: int, seed: int,
               device) -> list[np.ndarray]:
    """Host int16 (2, n) songs of the given lengths, made from `seed`."""
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, SONGS_STREAM))
    return [to_pcm16(_wave(n, sr, tones, g, device)).cpu().numpy()
            for n in lengths]


def stream(order: list[int]):
    """Endless pool indices: `order`, again and again."""
    while True:
        yield from order


def training_pairs(pairs: dict, config: dict, variant: int, root: str,
                   device) -> list[tuple[str, str]]:
    """(mixture, instruments) audio paths of `pairs["count"]` songs of
    `pairs["song_s"]` seconds whose spectrogram caches exist, as the
    training CLI leaves them after its first epoch: complex64 (T, 2, F)
    `.npy` under `sr{sr}_hl{hop}_nf{n_fft}/` beside the audio paths (the
    audio itself is not written). The caches are made on the device
    (centred STFT, periodic Hann) from `variant`, written once under
    `root` and reused by every run with the same variant; the mixture
    is instruments plus a vocal-like tone set."""
    sr, n_fft, hop = config["sr"], config["n_fft"], config["hop_length"]
    base = os.path.join(root, f"pairs-{n_fft}-{hop}-{sr}-v{variant}")
    cache = f"sr{sr}_hl{hop}_nf{n_fft}"
    n = int(pairs["song_s"] * sr)
    out = []
    done = os.path.join(base, "complete")
    make = not os.path.exists(done)
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(variant, PAIRS_STREAM))
    window = torch.hann_window(n_fft, periodic=True, device=device)
    for k in range(pairs["count"]):
        paths = []
        if make:
            inst = _wave(n, sr, pairs["tones"], g, device)
            voc = _wave(n, sr, pairs["tones"], g, device)
            waves = {"mixtures": 0.7 * inst + 0.3 * voc,
                     "instruments": 0.7 * inst}
        for kind in ("mixtures", "instruments"):
            path = os.path.join(base, kind, f"{k:03d}.wav")
            paths.append(path)
            if make:
                spec = torch.stft(waves[kind], n_fft, hop, window=window,
                                  center=True, pad_mode="reflect",
                                  return_complex=True)
                npy = os.path.join(base, kind, cache, f"{k:03d}.npy")
                os.makedirs(os.path.dirname(npy), exist_ok=True)
                np.save(npy, spec.permute(2, 0, 1).contiguous().cpu().numpy())
        out.append(tuple(paths))
    if make:
        with open(done, "w") as f:
            f.write("ok\n")
    return out


def cache_path(audio_path: str, config: dict) -> str:
    """The spectrogram cache of an audio path (data/cache.py's layout)."""
    d, name = os.path.split(audio_path)
    cache = f"sr{config['sr']}_hl{config['hop_length']}_nf{config['n_fft']}"
    return os.path.join(d, cache, os.path.splitext(name)[0] + ".npy")
