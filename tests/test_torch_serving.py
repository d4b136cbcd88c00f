"""GPU port: the serving transforms (models/serving.py) leaf by leaf
against the JAX package's transformed tree, the folded / bf16 forwards,
and the precision modes (nn/config.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vocal_remover_tpu.models import serving as jserving
from vocal_remover_tpu.models.cascaded import CascadedNet as JCascadedNet
from vocal_remover_tpu.nn import config as jconfig
from vocal_remover_tpu_torch.models import convert as tconvert
from vocal_remover_tpu_torch.models import serving as tserving
from vocal_remover_tpu_torch.models.base_net import BaseNet
from vocal_remover_tpu_torch.models.cascaded import CascadedNet
from vocal_remover_tpu_torch.nn import config as tconfig
from vocal_remover_tpu_torch.nn import functional as TF
from vocal_remover_tpu_torch.nn.layers import reset_parameters

from torch_port_helpers import perturb_bn

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def small():
    """CascadedNet(256, 128, 8, 16) with perturbed BN statistics, so
    that folding is a real test."""
    jmod = JCascadedNet(256, 128, 8, 16)
    v = perturb_bn(jmod.init(jax.random.PRNGKey(3)),
                   np.random.default_rng(3))
    tmod = tconvert.from_jax_variables(CascadedNet(256, 128, 8, 16), v)
    x = np.abs(np.random.default_rng(0).standard_normal(
        (2, 129, 256, 2))).astype(np.float32)
    return jmod, v, tmod.eval(), x


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _assert_leaves_equal(model, jtree):
    """Every leaf of the JAX tree, under its path, equals the port's:
    values exactly (bf16 compared as float32, which holds every bf16
    value), and the resident dtype by name."""
    ours, dtypes = _flatten(tconvert.to_jax_variables(model)), \
        tconvert.weight_dtypes(model)
    theirs = _flatten(jtree)
    assert set(ours) == set(theirs)
    for path, leaf in theirs.items():
        assert dtypes[path] == jnp.asarray(leaf).dtype.name, path
        np.testing.assert_array_equal(
            ours[path], np.asarray(jnp.asarray(leaf, jnp.float32)),
            err_msg=path)


def test_fold_batch_norms_leaves_equal_jax(small):
    """Both fold in float64 with the same operations, so the float32
    leaves are equal bit for bit."""
    _, v, tmod, _ = small
    _assert_leaves_equal(tserving.fold_batch_norms(tmod),
                         jserving.fold_batch_norms(v))


def test_fold_batch_norms_matches_eval_forward(small):
    """Folded forward of the port equals its unfolded forward (atol
    2e-5, as tests/test_serving_transforms.py: float association)."""
    _, _, tmod, x = small
    xt = torch.from_numpy(np.moveaxis(x, -1, 1).copy())
    with torch.no_grad(), tconfig.precision("highest"):
        ref = tmod(xt)
        out = tserving.fold_batch_norms(tmod)(xt)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-5)


def test_fold_is_not_identity_and_leaves_the_model_alone(small):
    _, v, tmod, _ = small
    before = {k: t.clone() for k, t in tmod.state_dict().items()}
    folded = tserving.serving_variables(tmod, "bfloat16", flat=True)
    for k, t in tmod.state_dict().items():
        assert torch.equal(t, before[k]), k
    assert tmod.stg3_full_band_net.flat_enc is None
    f32 = tserving.fold_batch_norms(tmod)
    w0 = tmod.stg3_full_band_net.enc1.conv[0].weight
    w1 = f32.stg3_full_band_net.enc1.conv[0].weight
    assert (w0 - w1).abs().max() > 1e-3
    bn = f32.stg3_full_band_net.enc1.conv[1]
    assert torch.all(bn.weight == 1.0) and torch.all(bn.running_mean == 0.0)
    assert not folded.training


def test_identity_bn_adds_only_the_shift(small):
    """rsqrt(var + eps) == 1 exactly for the folded statistics."""
    _, _, tmod, _ = small
    bn = tserving.fold_batch_norms(tmod).stg3_full_band_net.enc1.conv[1]
    x = torch.randn(1, bn.bias.numel(), 3, 5,
                    generator=torch.Generator().manual_seed(0))
    assert torch.equal(bn(x), x + bn.bias.detach().reshape(1, -1, 1, 1))


def test_cast_weights_leaves_equal_jax(small):
    _, v, tmod, _ = small
    cast = tserving.cast_weights(tserving.fold_batch_norms(tmod))
    _assert_leaves_equal(cast, jserving.cast_weights(
        jserving.fold_batch_norms(v)))
    dtypes = tconvert.weight_dtypes(cast)
    assert dtypes["stg3_full_band_net/enc1/conv"] == "bfloat16"
    assert dtypes["stg3_full_band_net/enc1/bn/bias"] == "float32"
    assert dtypes["stg3_full_band_net/lstm_dec2/lstm/fwd/w_hh"] == "bfloat16"
    assert dtypes["stg3_full_band_net/lstm_dec2/dense_bn/var"] == "float32"


def test_pack_flat_encoders_leaves_equal_jax(small):
    jmod, v, tmod, _ = small
    packed = tserving.pack_flat_encoders(tserving.fold_batch_norms(tmod))
    jtree = jserving.pack_flat_encoders(jserving.fold_batch_norms(v), jmod)
    _assert_leaves_equal(packed, jtree)
    nets = [n for n, m in packed.named_modules() if isinstance(m, BaseNet)]
    assert len(nets) == 5
    assert all(set(jtree[n]["flat_enc"]) == {
        "enc2_conv1", "enc2_conv2", "enc3_conv1", "enc3_conv2"}
        for n in ("stg1_low_band_net", "stg3_full_band_net"))


def test_pack_skips_nets_wider_than_32_channels():
    """p1 = 128 // nout < 4: no packed weights, as in the JAX package."""
    gen = torch.Generator().manual_seed(0)
    wide, narrow = BaseNet(2, 64, 8, 16), BaseNet(2, 32, 8, 16)
    reset_parameters(wide, gen)
    reset_parameters(narrow, gen)
    assert tserving.serving_variables(wide, flat=True).flat_enc is None
    packed = tserving.serving_variables(narrow, flat=True).flat_enc
    assert packed["enc2_conv1"].wst.shape == (3, 128, 2 * 128)
    assert packed["enc3_conv2"].wst.shape == (3, 128, 3 * 128)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_serving_variables_leaves_equal_jax(small, dtype):
    jmod, v, tmod, _ = small
    _assert_leaves_equal(
        tserving.serving_variables(tmod, dtype, flat=True),
        jserving.serving_variables(v, dtype, model=jmod, flat=True))


def test_serving_variables_refuses_int8(small):
    """int8 is no longer refused: it quantizes the conv stack (the
    leaves against JAX's: tests/test_torch_int8_serving.py); a weight
    dtype the JAX package has no transform for still is."""
    _, _, tmod, _ = small
    q = tserving.serving_variables(tmod, "int8")
    assert q.stg3_full_band_net.enc1.conv[0].q.dtype == torch.int8
    with pytest.raises(ValueError, match="unsupported"):
        tserving.serving_variables(tmod, "float16")


def test_bf16_forward_close_to_f32_and_to_jax(small):
    """bf16 weights and activations. Against the port's own f32 forward:
    the bounds of tests/test_serving_transforms.py (sigmoid-mask deltas:
    max 0.05, mean 2e-3). Against the JAX bf16 forward: max 0.05 and
    mean 2e-3 as well, which is looser than the f32 tests' 5e-5 because
    the two frameworks round to bf16 at different places (XLA fuses
    conv + BN + activation before rounding; PyTorch rounds after each)."""
    jmod, v, tmod, x = small
    xt = torch.from_numpy(np.moveaxis(x, -1, 1).copy())
    t16 = tserving.serving_variables(tmod, "bfloat16")
    with torch.no_grad():
        with tconfig.precision("highest"):
            ref = tmod(xt).numpy()
        with tconfig.precision("bfloat16"):
            out = t16(xt)
    assert out.dtype == torch.float32  # the mask head runs in f32
    out = np.moveaxis(out.numpy(), 1, -1)
    ref = np.moveaxis(ref, 1, -1)
    assert np.abs(out - ref).max() < 0.05
    assert np.abs(out - ref).mean() < 2e-3
    with jconfig.precision("bfloat16"):
        jout = np.asarray(jax.jit(jmod)(
            jserving.serving_variables(v, "bfloat16"), x)).astype(np.float32)
    assert np.abs(out - jout).max() < 0.05
    assert np.abs(out - jout).mean() < 2e-3


def test_bf16_activations_stay_bf16(small):
    """Inside the net the band nets' outputs are bf16 (conv, BN,
    activation, the LSTM branch and the concats keep the dtype)."""
    _, _, tmod, x = small
    t16 = tserving.serving_variables(tmod, "bfloat16", flat=True)
    seen = {}
    hook = t16.stg3_full_band_net.register_forward_hook(
        lambda m, a, out: seen.update(inp=a[0].dtype, out=out.dtype))
    lstm_hook = t16.stg3_full_band_net.lstm_dec2.register_forward_hook(
        lambda m, a, out: seen.update(lstm=out.dtype))
    with torch.no_grad(), tconfig.precision("bfloat16"):
        t16(torch.from_numpy(np.moveaxis(x, -1, 1).copy()))
    hook.remove()
    lstm_hook.remove()
    assert seen == {"inp": torch.bfloat16, "out": torch.bfloat16,
                    "lstm": torch.bfloat16}


def test_precision_modes_and_context_manager():
    tconfig.set_precision("highest")
    assert tconfig.get_compute_dtype() == torch.float32
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    with tconfig.precision("default"):  # TF32 on the card, f32 activations
        assert tconfig.get_precision() == "default"
        assert tconfig.get_compute_dtype() == torch.float32
        assert torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
        with tconfig.full_float32():
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
        with tconfig.precision("bfloat16"):
            assert tconfig.get_compute_dtype() == torch.bfloat16
            assert not torch.backends.cudnn.allow_tf32
        assert tconfig.get_precision() == "default"
        assert torch.backends.cuda.matmul.allow_tf32
    assert tconfig.get_precision() == "highest"
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    with pytest.raises(ValueError, match="weight transform"):
        tconfig.set_precision("int8")
    with pytest.raises(ZeroDivisionError):  # restored on an exception too
        with tconfig.precision("bfloat16"):
            1 / 0
    assert tconfig.get_compute_dtype() == torch.float32


def test_conv2d_and_batch_norm_follow_the_compute_dtype():
    """conv2d casts input and weight to the compute dtype; eval
    batch_norm computes scale / shift in f32 and applies them in the
    activation's dtype (vocal_remover_tpu/nn/functional.py:86-90,
    148-154)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 4, 6, 8, generator=g)
    w = torch.randn(5, 4, 3, 3, generator=g) * 0.2
    bn = [torch.rand(5, generator=g) + 0.5, torch.randn(5, generator=g),
          torch.randn(5, generator=g), torch.rand(5, generator=g) + 0.5]
    with tconfig.precision("bfloat16"):
        y = TF.conv2d(x, w)
        z = TF.batch_norm(y, *bn)
    assert y.dtype == z.dtype == torch.bfloat16
    with tconfig.precision("highest"):
        y32 = TF.conv2d(x.bfloat16(), w)
        z32 = TF.batch_norm(y32, *bn)
    assert y32.dtype == z32.dtype == torch.float32
    # bf16 rounding of input, weight and output: 3 x 2^-8 relative
    assert (y.float() - TF.conv2d(x, w)).abs().max() < 0.05
    scale = torch.rsqrt(bn[3] + TF.BN_EPS) * bn[0]
    want = y * scale.bfloat16().reshape(1, -1, 1, 1) + (
        bn[1] - bn[2] * scale).bfloat16().reshape(1, -1, 1, 1)
    assert torch.equal(z, want)
