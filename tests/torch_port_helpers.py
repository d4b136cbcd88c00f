"""Shared inputs for the GPU port's tests (tests/test_torch_*.py)."""

import numpy as np
import pytest


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


@pytest.fixture
def float64_mode():
    """JAX x64 and both packages' compute dtype at float64 for a test
    (as the JAX package's tests/test_grad_parity.py), restored after:
    gradients compared across the frameworks in float32 differ where
    rounding flips a ReLU / LeakyReLU branch."""
    import jax
    import jax.numpy as jnp
    import torch

    from vocal_remover_tpu.nn import config as jconfig
    from vocal_remover_tpu_torch.nn import config as tconfig

    jax.config.update("jax_enable_x64", True)
    jconfig.set_compute_dtype(jnp.float64)
    tconfig.set_compute_dtype(torch.float64)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)
        jconfig.set_compute_dtype(jnp.float32)
        tconfig.set_compute_dtype(torch.float32)


TINY = (64, 32, 4, 8)  # JAX's tiny training configuration (test_train.py)


def tiny_weights(seed, is_complex=False):
    """JAX's init of the tiny CascadedNet (jitted, float32; complex-mask
    with `is_complex`) with BN perturbed, as numpy."""
    import jax

    from vocal_remover_tpu.models.cascaded import CascadedNet as JCascadedNet

    jmod = JCascadedNet(*TINY, is_complex=is_complex)
    return perturb_bn(jax.jit(jmod.init)(jax.random.PRNGKey(seed)),
                      np.random.default_rng(seed))


def tiny_batch(is_complex=False):
    """A (2, C, 33, 160) float64 batch (X, y) for the tiny net: magnitudes,
    y = X times a uniform [0, 1) gain; with `is_complex`, [real;
    imaginary] channel stacks of random complex spectrograms, y = X times
    a complex gain of modulus below 1."""
    rng = np.random.default_rng(12)
    if not is_complex:
        X = np.abs(rng.standard_normal((2, 2, 33, 160)))
        return X, X * rng.uniform(0.0, 1.0, X.shape)
    shape = (2, 2, 33, 160)
    Xc = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    yc = Xc * rng.uniform(0.0, 1.0, shape) * np.exp(
        1j * rng.uniform(-0.5, 0.5, shape))
    return (np.concatenate([Xc.real, Xc.imag], axis=1),
            np.concatenate([yc.real, yc.imag], axis=1))


def check_grads_match_jax(weights, aux_lambda, is_complex=False,
                          wave_loss=None, remat=False):
    """The port's `Trainer.compute_grads` against JAX's
    `Trainer(dropout=False).compute_grads` on the tiny net (complex-mask
    with `is_complex`, the wave term with `wave_loss`, both recomputing
    the band nets in the backward pass with `remat`), in float64
    (run under the float64_mode fixture): the loss within 1e-10
    relative; each gradient leaf within 1e-9 of its largest |g|. Leaves
    whose gradient is zero in exact arithmetic (the dense head's bias
    feeds a batch norm: cancellation residue, ~1e-17; aux_out without
    aux_lambda) are held to 1e-12 of the largest |g| of the model
    instead. compute_grads must leave the model as it was."""
    import copy

    import jax
    import torch

    from vocal_remover_tpu.models.cascaded import CascadedNet as JCascadedNet
    from vocal_remover_tpu.nn.partition import partition
    from vocal_remover_tpu.train.step import Trainer as JTrainer
    from vocal_remover_tpu_torch.models import convert
    from vocal_remover_tpu_torch.models.cascaded import CascadedNet
    from vocal_remover_tpu_torch.train.step import Trainer

    v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), weights)
    X, y = tiny_batch(is_complex)

    jt = JTrainer(JCascadedNet(*TINY, is_complex=is_complex), v,
                  learning_rate=1e-3, dropout=False, aux_lambda=aux_lambda,
                  wave_loss=wave_loss, remat=remat)
    jloss, jgrads = jt.compute_grads(X, y)
    jflat = convert._flatten(jgrads)

    model = convert.from_jax_variables(
        CascadedNet(*TINY, is_complex=is_complex), v).double()
    before = {k: b.clone() for k, b in model.state_dict().items()}
    trainer = Trainer(model, learning_rate=1e-3, dropout=False,
                      aux_lambda=aux_lambda, wave_loss=wave_loss,
                      remat=remat, device="cpu")
    loss, grads = trainer.compute_grads(X, y)
    for k, b in model.state_dict().items():
        assert torch.equal(b, before[k]), k
    assert all(p.grad is None for p in model.parameters())

    assert abs(loss - jloss) <= 1e-10 * abs(jloss)
    # the port's {name: gradient} as JAX's tree, through the converter
    holder = copy.deepcopy(model)
    with torch.no_grad():
        for name, p in holder.named_parameters():
            p.copy_(grads[name])
    flat = convert._flatten(partition(convert.to_jax_variables(holder))[0])
    assert set(flat) == set(jflat) and len(flat) > 100
    scale = max(np.abs(g).max() for g in jflat.values())
    for k, g_ref in jflat.items():
        g = flat[k]
        assert g.dtype == np.float64 and g.shape == g_ref.shape, k
        tol = max(1e-9 * np.abs(g_ref).max(), 1e-12 * scale)
        np.testing.assert_allclose(g, g_ref, rtol=0, atol=tol, err_msg=k)
    aux = np.abs(flat["aux_out/conv"]).max()
    assert (aux > 0) == (aux_lambda > 0)
