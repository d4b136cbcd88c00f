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


def small_pair(seed=7):
    """The JAX CascadedNet(256, 128, 8, 16), its variables with perturbed
    BN, and the port's model holding the same weights."""
    import jax

    from vocal_remover_tpu.models.cascaded import CascadedNet as JCascadedNet
    from vocal_remover_tpu_torch.models import convert
    from vocal_remover_tpu_torch.models.cascaded import CascadedNet

    jmod = JCascadedNet(256, 128, 8, 16)
    v = perturb_bn(jmod.init(jax.random.PRNGKey(seed)),
                   np.random.default_rng(seed))
    return jmod, v, convert.from_jax_variables(CascadedNet(256, 128, 8, 16), v)


def max_lsb(a, b):
    """Largest difference of two int16 stems, in PCM16 LSB."""
    return int(np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32)).max())
