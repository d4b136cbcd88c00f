"""GPU port, training slice: the train-mode primitives and the train-mode
CascadedNet forward vs the JAX package on the same inputs (numpy, from
a seed) and the same weights (JAX init, BN perturbed, carried across
with `from_jax_variables`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vocal_remover_tpu.models.cascaded import CascadedNet as JCascadedNet
from vocal_remover_tpu.nn import functional as JF
from vocal_remover_tpu.nn.partition import partition
from vocal_remover_tpu.ops import resize as jresize
from vocal_remover_tpu_torch.models import convert
from vocal_remover_tpu_torch.models.cascaded import CascadedNet
from vocal_remover_tpu_torch.nn import functional as TF
from vocal_remover_tpu_torch.nn import layers as TL
from vocal_remover_tpu_torch.ops import resize as tresize

from torch_port_helpers import float64_mode, perturb_bn  # noqa: F401

torch.set_num_threads(1)

# JAX's tiny training configuration (tests/test_train.py): F 33, T 160
TINY = (64, 32, 4, 8)


def _bn_case(shape, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    bn = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
          "bias": rng.normal(0, 0.1, c).astype(np.float32),
          "mean": rng.normal(0, 0.1, c).astype(np.float32),
          "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
    return x, bn


def _port_bn(x_last, bn, dtype):
    """The port's train batch norm on the channels-last case, moved to
    its layout (NCHW for 4-D, (rows, C) as it is)."""
    x = torch.from_numpy(x_last)
    if x.dim() == 4:
        x = x.permute(0, 3, 1, 2)
    mean = torch.from_numpy(bn["mean"].copy())
    var = torch.from_numpy(bn["var"].copy())
    y = TF.batch_norm_train(x.to(dtype), torch.from_numpy(bn["scale"]),
                            torch.from_numpy(bn["bias"]), mean, var)
    if y.dim() == 4:
        y = y.permute(0, 2, 3, 1)
    return y.float().numpy(), mean.numpy(), var.numpy()


@pytest.mark.parametrize("shape", [(2, 9, 7, 5), (40, 6)],
                         ids=["nchw", "rows_c"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_train_matches_jax(shape, dtype):
    """Output and new running statistics against JAX's
    batch_norm(train=True): float32 within 1e-6; bf16 (statistics in
    float32 on both sides; JAX applies scale and shift in two bf16
    roundings, the port in one) within 2 bf16 ulps of the output, the
    statistics within 1e-6."""
    x, bn = _bn_case(shape, seed=len(shape))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref, new = JF.batch_norm(jnp.asarray(x).astype(jdt), bn, train=True)
    out, mean, var = _port_bn(x, bn, getattr(torch, dtype))
    ref = np.asarray(ref.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_allclose(out, ref, rtol=2 ** -7, atol=2 ** -7)
    np.testing.assert_allclose(mean, np.asarray(new["mean"]), atol=1e-6)
    np.testing.assert_allclose(var, np.asarray(new["var"]), rtol=1e-6,
                               atol=1e-6)


def test_batchnorm_module_updates_its_buffers_in_train_mode_only():
    bn = TL.BatchNorm(3)
    TL.reset_parameters(torch.nn.Sequential(bn), torch.Generator())
    x = torch.randn(2, 3, 4, 5, generator=torch.Generator().manual_seed(0))
    bn.eval()
    bn(x)
    assert int(bn.num_batches_tracked) == 0
    assert torch.equal(bn.running_mean, torch.zeros(3))
    bn.train()
    bn(x)
    bn(x)
    assert int(bn.num_batches_tracked) == 2
    want = 0.19 * x.mean(dim=(0, 2, 3))  # 0.1 m + 0.9 (0.1 m)
    torch.testing.assert_close(bn.running_mean, want, rtol=1e-6, atol=1e-7)


def test_dropout2d_zeroes_whole_channels_and_is_reproducible():
    x = torch.rand(4, 64, 5, 6) + 0.5
    rate = 0.25
    y = TF.dropout2d(x, rate, torch.Generator().manual_seed(3))
    kept = (y != 0).flatten(2)
    # every channel is kept or dropped whole
    assert bool((kept.all(-1) | (~kept).all(-1)).all())
    ch = kept.all(-1)
    torch.testing.assert_close(y[ch], x[ch] / (1 - rate))
    assert 0.6 < ch.float().mean().item() < 0.9
    again = TF.dropout2d(x, rate, torch.Generator().manual_seed(3))
    assert torch.equal(y, again)
    other = TF.dropout2d(x, rate, torch.Generator().manual_seed(4))
    assert not torch.equal(y, other)
    assert TF.dropout2d(x, rate, None) is x
    assert TF.dropout2d(x, 0.0, torch.Generator()) is x


@pytest.mark.parametrize("h,w", [(5, 7), (1, 4), (16, 32)])
def test_lerp_upsample_matches_jax_forward_and_gradient(h, w):
    rng = np.random.default_rng(h * w)
    x = rng.standard_normal((2, h, w, 3)).astype(np.float32)
    g = rng.standard_normal((2, 2 * h, 2 * w, 3)).astype(np.float32)

    def jloss(xx):
        return jnp.sum(jresize.upsample2x(xx, lerp=True) * g)

    ref = np.asarray(jresize.upsample2x(jnp.asarray(x), lerp=True))
    ref_grad = np.asarray(jax.grad(jloss)(jnp.asarray(x)))

    xt = torch.from_numpy(np.moveaxis(x, -1, 1).copy()).requires_grad_()
    gt = torch.from_numpy(np.moveaxis(g, -1, 1).copy())
    out = tresize.upsample2x(xt, lerp=True)
    (out * gt).sum().backward()
    np.testing.assert_allclose(np.moveaxis(out.detach().numpy(), 1, -1),
                               ref, atol=1e-6)
    np.testing.assert_allclose(np.moveaxis(xt.grad.numpy(), 1, -1),
                               ref_grad, atol=1e-5)
    # the eval form is the same grid, and differentiable too
    xm = xt.detach().clone().requires_grad_()
    outm = tresize.upsample2x(xm)
    (outm * gt).sum().backward()
    torch.testing.assert_close(outm, out.detach(), atol=1e-6, rtol=0)
    torch.testing.assert_close(xm.grad, xt.grad, atol=1e-5, rtol=0)


@pytest.mark.parametrize("lerp", [False, True], ids=["matrix", "lerp"])
def test_resize_gradient_after_an_inference_mode_call(lerp):
    """The resize's cached constants (interp matrices, lerp weights) are
    made once per shape; made inside `torch.inference_mode` (a
    separation), they must still serve a later forward under autograd
    (training, or any gradient through the eval form), as JAX's
    constants do. Shapes no other test resizes, so the cache is cold."""
    x = torch.rand(1, 2, 13, 21)
    with torch.inference_mode():
        want = tresize.upsample2x(x, lerp=lerp)
    xg = x.clone().requires_grad_()
    out = tresize.upsample2x(xg, lerp=lerp)
    out.sum().backward()
    torch.testing.assert_close(out.detach(), want.clone())
    assert xg.grad is not None and bool(torch.isfinite(xg.grad).all())


@pytest.fixture(scope="module")
def tiny():
    jmod = JCascadedNet(*TINY)
    v = perturb_bn(jax.jit(jmod.init)(jax.random.PRNGKey(3)),
                   np.random.default_rng(3))
    rng = np.random.default_rng(5)
    X = np.abs(rng.standard_normal((2, 2, 33, 160))).astype(np.float32)
    return jmod, v, X


def _bn_stats(tree):
    _, stats = partition(tree)
    return {k: np.asarray(a) for k, a in convert._flatten(stats).items()}


# float32: the tiny nets' train-mode batch norm divides by the spread of
# one- and two-channel activations, which turns float32 rounding into
# up to 8e-5 of mask; float64 shows the math agrees to ~1e-13
FORWARD_TOL = {"float32": (2e-4, 1e-4), "float64": (1e-10, 1e-10)}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_train_forward_matches_jax(tiny, dtype, request):
    """CascadedNet in train mode, dropout off (no generator), against
    JAX apply(train=True, rng=None): the mask, aux=True's aux mask, and
    every new BatchNorm statistic."""
    if dtype == "float64":
        request.getfixturevalue("float64_mode")
    jmod, v, X = tiny
    X = X.astype(dtype)
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), v)
    Xh = jnp.asarray(np.moveaxis(X, 1, -1))
    fwd = jax.jit(lambda vv, xx: jmod.apply(vv, xx, train=True, rng=None,
                                            aux=True))
    (mask, aux_mask), new_v = fwd(v, Xh)

    model = convert.from_jax_variables(CascadedNet(*TINY), v).to(
        getattr(torch, dtype)).train()
    out, aux_out = model(torch.from_numpy(X), aux=True)
    assert out.dtype == getattr(torch, dtype)
    mask_tol, stat_tol = FORWARD_TOL[dtype]
    np.testing.assert_allclose(out.detach().numpy(),
                               np.moveaxis(np.asarray(mask), -1, 1),
                               atol=mask_tol)
    np.testing.assert_allclose(aux_out.detach().numpy(),
                               np.moveaxis(np.asarray(aux_mask), -1, 1),
                               atol=mask_tol)
    want = _bn_stats(new_v)
    have = _bn_stats(convert.to_jax_variables(model))
    assert set(have) == set(want) and len(want) > 100
    for k in want:
        np.testing.assert_allclose(have[k], want[k], rtol=stat_tol,
                                   atol=stat_tol, err_msg=k)
    # without aux the same mask; the statistics moved a second time
    out2 = model(torch.from_numpy(X))
    torch.testing.assert_close(out2, out, atol=1e-6, rtol=0)
    assert all(int(m.num_batches_tracked) == 2 for m in model.modules()
               if isinstance(m, TL.BatchNorm))


def test_train_mode_takes_the_lerp_and_plain_recurrence_eval_does_not(
        tiny, monkeypatch):
    """Train mode runs the BiLSTM's recurrence as the differentiable
    plain loop (the op has no gradient) and the Decoders' lerp; eval runs
    the op and the interp matrices. Dropout draws from the generator it
    is given: the same seed, the same masks."""
    from vocal_remover_tpu_torch.nn import lstm_kernel

    jmod, v, X = tiny
    model = convert.from_jax_variables(CascadedNet(*TINY), v)
    calls = {"plain": 0, "op": 0, "lerp": 0}
    plain, op, lerp = (lstm_kernel.recurrence_plain,
                       lstm_kernel.recurrence_cols, tresize._up2x_axis)

    def count(name, fn):
        def inner(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return inner

    monkeypatch.setattr(lstm_kernel, "recurrence_plain", count("plain", plain))
    monkeypatch.setattr(lstm_kernel, "recurrence_cols", count("op", op))
    monkeypatch.setattr(tresize, "_up2x_axis", count("lerp", lerp))
    x = torch.from_numpy(X)
    model.train()
    a = model(x, generator=torch.Generator().manual_seed(1))
    a.sum().backward()
    assert calls == {"plain": 5, "op": 0, "lerp": 5 * 4 * 2}
    b = model(x, generator=torch.Generator().manual_seed(1))
    c = model(x)
    assert torch.equal(a, b)  # batch statistics: the same masks
    assert not torch.equal(a, c)  # dropout changed something
    model.eval()
    with torch.no_grad():
        model(x)
    # the op's CPU implementation is the plain loop
    assert calls == {"plain": 20, "op": 5, "lerp": 3 * 40}
