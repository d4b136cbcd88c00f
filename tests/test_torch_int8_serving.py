"""GPU port: int8 serving's weight transforms (models/serving.py
`quantize_int8`, `calibrate_act_scales`, `serving_variables(..., 'int8')`)
leaf by leaf against the JAX package's, and the int8 forward against
JAX's int8 masks and the port's own float32 masks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vocal_remover_tpu.models import serving as jserving
from vocal_remover_tpu.nn import config as jconfig
from vocal_remover_tpu_torch.models import convert as tconvert
from vocal_remover_tpu_torch.models import serving as tserving
from vocal_remover_tpu_torch.models.cascaded import CascadedNet
from vocal_remover_tpu_torch.nn import config as tconfig
from vocal_remover_tpu_torch.nn.layers import Conv2d, QConv2d

from torch_port_helpers import small_pair

torch.set_num_threads(1)

# the int8 quality gate of the JAX package (tests/test_serving_transforms.py)
SNR_FLOOR_DB = 40.0


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_leaves_equal(model, jtree):
    """Every leaf of the JAX tree equals the port's under its path: the
    values exactly and the resident dtype by name (int8 q, float32
    scales, bf16 weights compared as float32)."""
    ours, dtypes = _flatten(tconvert.to_jax_variables(model)), \
        tconvert.weight_dtypes(model)
    theirs = _flatten(jtree)
    assert set(ours) == set(theirs)
    for path, leaf in theirs.items():
        assert dtypes[path] == jnp.asarray(leaf).dtype.name, path
        np.testing.assert_array_equal(
            np.asarray(ours[path], np.float32),
            np.asarray(jnp.asarray(leaf, jnp.float32)), err_msg=path)


def _snr_db(ref, test):
    num = float(np.sum(ref.astype(np.float64) ** 2))
    den = float(np.sum((ref - test).astype(np.float64) ** 2))
    return float("inf") if den == 0 else 10.0 * np.log10(num / den)


@pytest.fixture(scope="module")
def setup():
    """The pair of CascadedNet(256, 128, 8, 16) with perturbed BN; the
    port's model holding JAX's folded tree; a forward input and a short
    calibration input; JAX's activation scales from it (its eager
    calibration is the slow part, so it runs once)."""
    jmod, v, tmod = small_pair()
    folded = _numpy(jserving.fold_batch_norms(v))
    tfold = tconvert.from_jax_variables(CascadedNet(256, 128, 8, 16),
                                        folded).eval()
    rng = np.random.default_rng(0)
    x = np.abs(rng.standard_normal((2, 129, 256, 2))).astype(np.float32)
    x_cal = np.abs(rng.standard_normal((1, 129, 32, 2))).astype(np.float32)
    jscales = jserving.calibrate_act_scales(jmod, folded, [x_cal])
    return jmod, v, tmod.eval(), folded, tfold, x, x_cal, jscales


def _nchw(x):
    return torch.from_numpy(np.moveaxis(x, -1, 1).copy())


def _port_names(model, jscales):
    """JAX's {tree path: scale} as the port's {conv module name: scale}."""
    by_path = {tconvert.module_path(name): name
               for name, m in model.named_modules() if isinstance(m, Conv2d)}
    return {by_path[path]: s for path, s in jscales.items()}


def test_quantize_int8_leaves_equal_jax(setup):
    """From the same folded tree, q / scale are JAX's bit for bit; the
    BiLSTM branch and the mask heads stay float, the 97 convs of the
    flagship's structure (5 x 19 in the band nets + 2 squeezes) do not."""
    _, _, _, folded, tfold, *_ = setup
    q = tserving.quantize_int8(tfold)
    jq = jserving.quantize_int8(folded)
    _assert_leaves_equal(q, jq)
    names = [n for n, m in q.named_modules() if isinstance(m, QConv2d)]
    assert len(names) == 97
    assert not any("lstm_dec2" in n for n in names)
    assert sum(p.endswith("/q") for p in _flatten(jq)) == 97
    assert isinstance(q.out, Conv2d) and isinstance(q.aux_out, Conv2d)
    assert isinstance(q.stg3_full_band_net.lstm_dec2.conv.conv[0], Conv2d)
    assert q.serving_transformed and not hasattr(tfold, "serving_transformed")


def test_quantize_int8_with_scales_leaves_equal_jax(setup):
    _, _, _, folded, tfold, _, _, jscales = setup
    q = tserving.quantize_int8(tfold, _port_names(tfold, jscales))
    _assert_leaves_equal(q, jserving.quantize_int8(folded, jscales))
    assert all(m.a_scale is not None and m.a_scale.dtype == torch.float32
               for m in q.modules() if isinstance(m, QConv2d))


def test_calibrate_act_scales_matches_jax(setup):
    """The same keys after translation to JAX's tree paths (every float
    conv, the BiLSTM's squeeze included: 102), values within a relative
    1e-5 (the amax of activations the two frameworks compute in float32
    in another order)."""
    _, _, _, _, tfold, _, x_cal, jscales = setup
    with tconfig.precision("highest"):
        scales = tserving.calibrate_act_scales(tfold, [_nchw(x_cal)])
    assert not tfold.training
    paths = tserving.act_scale_paths(scales)
    assert set(paths) == set(jscales) and len(paths) == 102
    for path, s in paths.items():
        assert isinstance(s, np.float32)
        np.testing.assert_allclose(s, jscales[path], rtol=1e-5,
                                   err_msg=str(path))


def test_scales_that_match_nothing_are_refused(setup):
    """Both packages raise rather than fall back to dynamic scales."""
    _, _, _, folded, tfold, *_ = setup
    with pytest.raises(ValueError, match="none"):
        tserving.quantize_int8(tfold, {"no.such.conv.0": np.float32(1.0)})
    with pytest.raises(ValueError, match="none"):
        jserving.quantize_int8(folded, {("no", "such"): np.float32(1.0)})


def test_from_jax_variables_runs_a_tree_jax_quantized(setup):
    """A tree the JAX package quantized (static scales) loads into the
    port as QConv2d modules, reads back as the same tree, and runs as the
    port's own quantized model does."""
    _, _, _, folded, tfold, x, _, jscales = setup
    jq = _numpy(jserving.quantize_int8(folded, jscales))
    loaded = tconvert.from_jax_variables(CascadedNet(256, 128, 8, 16), jq)
    assert loaded.serving_transformed
    _assert_leaves_equal(loaded, jq)
    ours = tserving.quantize_int8(tfold, _port_names(tfold, jscales))
    xt = _nchw(x[:1])
    with torch.no_grad(), tconfig.precision("bfloat16"):
        assert torch.equal(loaded.eval()(xt), ours(xt))


def test_serving_variables_int8_leaves_equal_jax(setup):
    """fold, quantize, then the remaining float weights in bf16 (the BN
    vectors and the int8 convs' scales stay float32); flat packing and
    int8 are refused together with JAX's message."""
    jmod, v, tmod, *_ = setup
    t8 = tserving.serving_variables(tmod, "int8")
    _assert_leaves_equal(t8, jserving.serving_variables(v, "int8"))
    dtypes = tconvert.weight_dtypes(t8)
    assert dtypes["stg3_full_band_net/enc1/conv/q"] == "int8"
    assert dtypes["stg3_full_band_net/enc1/conv/scale"] == "float32"
    assert dtypes["stg3_full_band_net/lstm_dec2/conv/conv"] == "bfloat16"
    assert dtypes["out/conv"] == "bfloat16"
    assert not t8.training
    cast = tserving.cast_weights(t8)  # the int8 leaves stay as they are
    assert tconvert.weight_dtypes(cast) == dtypes
    with pytest.raises(ValueError, match="flat packing and int8 are "
                                         "exclusive serving transforms"):
        tserving.serving_variables(tmod, "int8", flat=True)
    with pytest.raises(ValueError, match="flat packing and int8 are "
                                         "exclusive serving transforms"):
        jserving.serving_variables(v, "int8", model=jmod, flat=True)


@pytest.mark.parametrize("calibrated", [False, True],
                         ids=["dynamic", "calibrated"])
def test_int8_forward_close_to_jax_and_to_f32(setup, calibrated):
    """int8 masks against JAX's int8 masks: max 0.05 and mean 2e-3, the
    bounds of test_torch_serving.py's bf16 comparison (the convs are
    exact integer sums in both, but the bf16 activations around them
    round at other places, and a value that lands on the other side of a
    quantization step moves by one step). Against the port's own float32
    masks: JAX's int8 gate, >= 40 dB SNR."""
    jmod, v, tmod, folded, _, x, x_cal, jscales = setup
    xt = _nchw(x)
    batches = [_nchw(x_cal)] if calibrated else None
    with tconfig.precision("highest"):
        t8 = tserving.serving_variables(tmod, "int8",
                                        calibration_batches=batches)
    jv = jserving.cast_weights(jserving.quantize_int8(
        folded, jscales if calibrated else None))
    with torch.no_grad():
        with tconfig.precision("highest"):
            ref = np.moveaxis(tmod(xt).numpy(), 1, -1)
        with tconfig.precision("bfloat16"):
            out = t8(xt)
    assert out.dtype == torch.float32  # the mask head runs in f32
    out = np.moveaxis(out.numpy(), 1, -1)
    with jconfig.precision("bfloat16"):
        jout = np.asarray(jax.jit(jmod)(jv, x)).astype(np.float32)
    assert np.abs(out - jout).max() < 0.05
    assert np.abs(out - jout).mean() < 2e-3
    assert _snr_db(ref, out) >= SNR_FLOOR_DB
