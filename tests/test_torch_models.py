"""GPU port: CascadedNet masks vs the JAX model (recurrence under the
Pallas kernel in interpret mode), the flat serving branch vs the JAX
flat branch (flat-conv Pallas kernel in interpret mode), parameter
count, and checkpoint conversion (`.vrt.npz`, JAX variables tree) both
ways."""

import jax
import numpy as np
import pytest
import torch

from vocal_remover_tpu.models import convert as jconvert
from vocal_remover_tpu.models import serving as jserving
from vocal_remover_tpu.models.base_net import BaseNet as JBaseNet
from vocal_remover_tpu.models.cascaded import CascadedNet as JCascadedNet
from vocal_remover_tpu.models.cascaded import param_count as jparam_count
from vocal_remover_tpu.nn import config as jconfig
from vocal_remover_tpu_torch.models import convert as tconvert
from vocal_remover_tpu_torch.models import serving as tserving
from vocal_remover_tpu_torch.models.base_net import BaseNet
from vocal_remover_tpu_torch.models.cascaded import CascadedNet, param_count
from vocal_remover_tpu_torch.nn import config as tconfig
from vocal_remover_tpu_torch.nn import conv_pack as tcp

from torch_port_helpers import perturb_bn

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def small():
    jmod = JCascadedNet(256, 128, 8, 16)
    v = perturb_bn(jmod.init(jax.random.PRNGKey(0)),
                   np.random.default_rng(0))
    tmod = tconvert.from_jax_variables(CascadedNet(256, 128, 8, 16), v)
    return jmod, v, tmod.eval()


def _jax_eval(fn, *args):
    jconfig.set_lstm_impl("pallas")
    try:
        return np.asarray(jax.jit(fn)(*args))
    finally:
        jconfig.set_lstm_impl("scan")


def _mag(shape, seed):
    return np.abs(np.random.default_rng(seed).standard_normal(shape)).astype(
        np.float32) * 2


def test_cascaded_masks_match_jax(small):
    """Full masks and the offset-trimmed `predict_mask` vs one JAX
    forward (the JAX predict_mask is that forward, trimmed)."""
    jmod, v, tmod = small
    x = _mag((2, 129, 160, 2), seed=1)  # NHWC (N, F, T, C)
    ref = _jax_eval(jmod, v, x)
    xt = torch.from_numpy(np.moveaxis(x, -1, 1).copy())
    with torch.no_grad():
        out = tmod(xt)
        trimmed = tmod.predict_mask(xt)
    assert out.shape == (2, 2, 129, 160)
    np.testing.assert_allclose(np.moveaxis(out.numpy(), 1, -1), ref,
                               atol=5e-5)
    assert trimmed.shape == (2, 2, 129, 160 - 2 * 64)
    np.testing.assert_allclose(np.moveaxis(trimmed.numpy(), 1, -1),
                               ref[:, :, 64:-64], atol=5e-5)


def _count_flat_layers(monkeypatch):
    """Count the port's flat_layer_apply calls (on the CPU the kernel's
    own `launches` count stays 0: the plain version runs)."""
    calls = []
    real = tcp.flat_layer_apply

    def counted(layer, xf, h, wb, **kw):
        calls.append((tuple(xf.shape), layer["stride"]))
        return real(layer, xf, h, wb, **kw)

    monkeypatch.setattr(tcp, "flat_layer_apply", counted)
    return calls


def test_flat_cascaded_masks_match_jax(small, monkeypatch):
    """Eval forward with the flat serving transform vs the JAX forward
    with serving_variables(flat=True). atol 5e-5 as for the plain
    forward: f32 throughout, another summation order. At this size four
    band nets take the flat branch and stg1_high_band_net (WB = 4) the
    plain one, in both packages."""
    jmod, v, tmod = small
    x = _mag((2, 129, 256, 2), seed=2)
    jv = jserving.serving_variables(v, None, model=jmod, flat=True)
    ref = _jax_eval(jmod, jv, x)
    tflat = tserving.serving_variables(tmod, flat=True)
    calls = _count_flat_layers(monkeypatch)
    xt = torch.from_numpy(np.moveaxis(x, -1, 1).copy())
    with torch.no_grad(), tconfig.precision("highest"):
        out = tflat(xt)
        plain = tserving.serving_variables(tmod)(xt)
    np.testing.assert_allclose(np.moveaxis(out.numpy(), 1, -1), ref,
                               atol=5e-5)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=2e-5)
    assert len(calls) == 4 * 4  # four layers in each of four band nets
    band = (2, 64, 256, 2)  # NHWC band input of the JAX nets
    for name, flat in (("stg1_low_band_net", True),
                       ("stg1_high_band_net", False),
                       ("stg2_low_band_net", True),
                       ("stg2_high_band_net", True),
                       ("stg3_full_band_net", True)):
        jnet = getattr(jmod, name)
        tnet = getattr(tflat, name)
        tnet = tnet[0] if isinstance(tnet, torch.nn.Sequential) else tnet
        assert "flat_enc" in jv[name] and tnet.flat_enc is not None
        assert jnet._flat_supported(band) == flat
        assert tnet._flat_supported((2, 2, 64, 256)) == flat
        assert tnet._flat_p1() == jnet._flat_p1()


def test_flat_base_net_matches_jax(monkeypatch):
    """One BaseNet(2, 16, 32, 16) on a (1, 2, 64, 64) input: p1 = 8,
    WB = 8, all four packed layers, against the JAX BaseNet with the
    same packed weights (atol 5e-5)."""
    jnet = JBaseNet(2, 16, 32, 16)
    v = perturb_bn(jnet.init(jax.random.PRNGKey(5)),
                   np.random.default_rng(5))
    tnet = tconvert.from_jax_variables(BaseNet(2, 16, 32, 16), v).eval()

    class Holder:  # pack_flat_encoders walks a model's BaseNet children
        _children = ("net",)
        net = jnet

    jv = jserving.pack_flat_encoders(
        {"net": jserving.fold_batch_norms(v)}, Holder())["net"]
    x = _mag((1, 64, 64, 2), seed=6)
    assert jnet._flat_supported(x.shape)
    ref = _jax_eval(lambda vv, xx: jnet.apply(vv, xx)[0], jv, x)
    tflat = tserving.serving_variables(tnet, flat=True)
    calls = _count_flat_layers(monkeypatch)
    with torch.no_grad(), tconfig.precision("highest"):
        out = tflat(torch.from_numpy(np.moveaxis(x, -1, 1).copy()))
    assert [c[1] for c in calls] == [2, 1, 2, 1]
    assert calls[0][0] == (1, 64 * 8, 128) and calls[3][0] == (1, 16 * 8, 128)
    np.testing.assert_allclose(np.moveaxis(out.numpy(), 1, -1), ref,
                               atol=5e-5)
    # training mode never takes the flat branch
    calls.clear()
    with torch.no_grad(), tconfig.precision("highest"):
        tflat.train()(torch.from_numpy(np.moveaxis(x, -1, 1).copy()))
    assert calls == []


def test_flagship_band_nets_all_take_the_flat_branch():
    """At the flagship's shapes (crop 256) every band net passes
    `_flat_supported`, with the packs and block widths the kernel is
    launched at."""
    nets = {"stg1_low": (BaseNet(2, 16, 256, 128), 512, 8, 32),
            "stg1_high": (BaseNet(2, 8, 256, 64), 512, 16, 16),
            "stg2_low": (BaseNet(10, 32, 256, 128), 512, 4, 64),
            "stg2_high": (BaseNet(10, 16, 256, 64), 512, 8, 32),
            "stg3_full": (BaseNet(26, 32, 512, 128), 1024, 4, 64)}
    for name, (net, bins, p1, wb) in nets.items():
        assert net._flat_p1() == p1, name
        assert 256 // p1 == wb, name
        assert net._flat_supported((4, net.enc1.conv[0].weight.shape[1],
                                    bins, 256)), name


def test_flagship_param_count():
    """CascadedNet(2048, 1024, 32, 128): 14,740,882 trainable parameters,
    as the JAX model counts them."""
    jv = jax.eval_shape(JCascadedNet(2048, 1024, 32, 128).init,
                        jax.random.PRNGKey(0))
    assert jparam_count(jv) == 14_740_882
    assert param_count(CascadedNet(2048, 1024, 32, 128)) == 14_740_882


def _assert_tree_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_tree_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def test_jax_variables_round_trip(small):
    _, v, tmod = small
    _assert_tree_equal(tconvert.to_jax_variables(tmod), v)


def test_state_dict_keys_are_the_references():
    """The reference's key layout, as the JAX package's to_torch writes
    it (num_batches_tracked included)."""
    jmod = JCascadedNet(256, 128, 8, 16)
    ref_keys = set(jmod.to_torch(jmod.init(jax.random.PRNGKey(0))))
    assert set(CascadedNet(256, 128, 8, 16).state_dict()) == ref_keys


def test_native_checkpoint_round_trip(small, tmp_path):
    jmod, v, tmod = small
    cfg = tconvert.model_config(tmod)
    assert cfg == jconvert.model_config(jmod)
    # port writes, JAX reads
    path = str(tmp_path / "port.vrt.npz")
    tconvert.save_native(path, tconvert.to_jax_variables(tmod), cfg)
    jv, jcfg = jconvert.load_native(path)
    _assert_tree_equal(jv, v)
    assert jcfg == cfg
    # JAX writes (also int8-quantized), port reads
    for quantize in (None, "int8"):
        path = str(tmp_path / f"jax-{quantize}.vrt.npz")
        jconvert.save_native(path, v, cfg, quantize=quantize)
        tv, tcfg = tconvert.load_native(path)
        _assert_tree_equal(tv, jconvert.load_native(path)[0])
        assert tcfg == cfg
    model = tconvert.load_model(str(tmp_path / "jax-None.vrt.npz"), 2048, 1024)
    assert (model.n_fft, model.nout, model.nout_lstm) == (256, 8, 16)
    for a, b in zip(model.state_dict().values(), tmod.state_dict().values()):
        assert torch.equal(a, b)


def test_from_jax_variables_rejects_a_mismatched_tree(small):
    _, v, _ = small
    broken = dict(v)
    del broken["aux_out"]
    with pytest.raises(ValueError, match="aux_out.weight"):
        tconvert.from_jax_variables(CascadedNet(256, 128, 8, 16), broken)


def test_complex_mask_model_matches_jax():
    """The complex-mask head (tanh-bounded re/im channels)."""
    jmod = JCascadedNet(256, 128, 8, 16, is_complex=True)
    v = perturb_bn(jmod.init(jax.random.PRNGKey(3)), np.random.default_rng(3))
    tmod = tconvert.from_jax_variables(
        CascadedNet(256, 128, 8, 16, is_complex=True), v).eval()
    x = np.random.default_rng(4).standard_normal((1, 129, 32, 4)).astype(
        np.float32)
    ref = _jax_eval(jmod, v, x)
    with torch.no_grad():
        out = tmod(torch.from_numpy(np.moveaxis(x, -1, 1).copy()))
    np.testing.assert_allclose(np.moveaxis(out.numpy(), 1, -1), ref,
                               atol=5e-5)
