"""Shared inputs for the GPU port's tests (tests/test_torch_*.py)."""

import numpy as np


def perturb_bn(tree, rng):
    """Numpy copy of a JAX variables tree with random BN statistics and
    affine parameters, so eval BN is a real test."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            if set(v) == {"scale", "bias", "mean", "var"}:
                n = v["scale"].shape
                out[k] = {
                    "scale": rng.uniform(0.5, 1.5, n).astype(np.float32),
                    "bias": rng.normal(0, 0.1, n).astype(np.float32),
                    "mean": rng.normal(0, 0.1, n).astype(np.float32),
                    "var": rng.uniform(0.5, 1.5, n).astype(np.float32),
                }
            else:
                out[k] = perturb_bn(v, rng)
        else:
            out[k] = np.array(v)
    return out


def synth_song(sr=8000, seconds=3.0):
    """Deterministic stereo test signal: two tones left, a tone plus
    noise right."""
    t = np.arange(int(sr * seconds)) / sr
    left = 0.6 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(
        2 * np.pi * 1307 * t)
    right = 0.5 * np.sin(2 * np.pi * 220 * t) + 0.1 * np.random.default_rng(
        3).standard_normal(len(t))
    return np.stack([left, right]).astype(np.float32)
