"""GPU port: layer modules and the bilinear resize vs the JAX package at
float32 `highest`, with the same weights (JAX init, BN statistics
perturbed from numpy) and the same inputs."""

import jax
import numpy as np
import pytest
import torch

from vocal_remover_tpu.nn import config as jconfig
from vocal_remover_tpu.nn import layers as JL
from vocal_remover_tpu.ops import resize as jresize
from vocal_remover_tpu_torch.models.convert import from_jax_variables
from vocal_remover_tpu_torch.nn import layers as TL
from vocal_remover_tpu_torch.ops import resize as tresize

from torch_port_helpers import perturb_bn

torch.set_num_threads(1)


def pair(jmod, tmod, seed=0):
    v = perturb_bn(jmod.init(jax.random.PRNGKey(seed)),
                   np.random.default_rng(seed))
    return v, from_jax_variables(tmod, v).eval()


def nchw(x_nhwc):
    return torch.from_numpy(np.moveaxis(x_nhwc, -1, 1).copy())


def nhwc(y_nchw):
    return np.moveaxis(y_nchw.detach().numpy(), 1, -1)


def check(jmod, tmod, *xs, seed=0, lstm_pallas=False):
    v, tmod = pair(jmod, tmod, seed)
    if lstm_pallas:
        jconfig.set_lstm_impl("pallas")
    try:
        ref, _ = jmod.apply(v, *xs, train=False)
    finally:
        jconfig.set_lstm_impl("scan")
    with torch.no_grad():
        out = tmod(*[nchw(x) for x in xs])
    assert out.shape == nchw(np.asarray(ref)).shape
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=3e-5)


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("ksize,stride,pad,dilation,activ", [
    (3, 1, 1, 1, "relu"),
    (3, 2, 1, 1, "leaky_relu"),
    (1, 1, 0, 1, "relu"),
    (3, 1, (4, 2), (4, 2), "relu"),
])
def test_conv_bn_activ(ksize, stride, pad, dilation, activ):
    check(JL.Conv2DBNActiv(5, 7, ksize, stride, pad, dilation, activ),
          TL.Conv2DBNActiv(5, 7, ksize, stride, pad, dilation, activ),
          _x((2, 16, 24, 5)))


def test_encoder():
    check(JL.Encoder(4, 6, 3, 2, 1), TL.Encoder(4, 6, 3, 2, 1),
          _x((2, 16, 20, 4)))


@pytest.mark.parametrize("skip_w", [12, 15])
def test_decoder_with_skip(skip_w):
    """x (6 frames) upsamples to 12; a 15-frame skip is centre-cropped."""
    check(JL.Decoder(6 + 3, 5), TL.Decoder(6 + 3, 5),
          _x((2, 8, 6, 6)), _x((2, 16, skip_w, 3), seed=2))


def test_aspp_anisotropic_dilations():
    dil = ((4, 2), (8, 4), (12, 6))
    check(JL.ASPPModule(8, 6, dil), TL.ASPPModule(8, 6, dil),
          _x((2, 16, 12, 8)))


def test_lstm_module():
    check(JL.LSTMModule(4, 16, 8), TL.LSTMModule(4, 16, 8),
          _x((2, 16, 12, 4)), lstm_pallas=True)


@pytest.mark.parametrize("in_hw,out_hw", [
    ((5, 7), (10, 14)),  # every Decoder's exact 2x
    ((1, 9), (6, 9)),    # ASPP's frequency-pooled 1 -> h re-expand
    ((4, 3), (7, 5)),    # a general ratio
])
def test_resize_bilinear(in_hw, out_hw):
    x = _x((2, *in_hw, 3))
    ref = jresize.resize_bilinear(x, *out_hw, lerp2x=False)
    out = tresize.resize_bilinear(nchw(x), *out_hw)
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=3e-5)
