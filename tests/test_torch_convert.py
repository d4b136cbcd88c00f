"""GPU port: the checkpoint converter (cli/convert.py) and
`models/convert.load_checkpoint` / `export_torch`, against the JAX
package's on the CPU."""

import jax
import numpy as np
import pytest
import torch

from vocal_remover_tpu.models import convert as jconvert
from vocal_remover_tpu.models.cascaded import CascadedNet as JCascadedNet
from vocal_remover_tpu_torch.cli import convert as convert_cli
from vocal_remover_tpu_torch.models import convert
from vocal_remover_tpu_torch.models.cascaded import CascadedNet

from torch_port_helpers import perturb_bn

SMALL = ["-f", "256", "-H", "128", "--nout", "8", "--nout_lstm", "16"]


def _jax_variables(is_complex=False, seed=3):
    jmod = JCascadedNet(256, 128, 8, 16, is_complex=is_complex)
    v = perturb_bn(jmod.init(jax.random.PRNGKey(seed)),
                   np.random.default_rng(seed))
    return jmod, v


def _flat(tree):
    return {k: np.asarray(a) for k, a in jconvert._flatten(tree).items()}


@pytest.fixture
def npz(tmp_path):
    jmod, v = _jax_variables()
    path = str(tmp_path / "small.vrt.npz")
    jconvert.save_native(path, v, jconvert.model_config(jmod))
    return path, v


def test_npz_to_pth_to_npz_gives_identical_arrays(npz, tmp_path, capsys):
    src, v = npz
    pth, back = str(tmp_path / "small.pth"), str(tmp_path / "back.vrt.npz")
    convert_cli.main([src, pth] + SMALL)
    convert_cli.main([pth, back] + SMALL)
    assert capsys.readouterr().out.splitlines() == [
        f"wrote torch checkpoint {pth}", f"wrote native checkpoint {back}"]
    (a, cfg_a), (b, cfg_b) = convert.load_native(src), convert.load_native(back)
    assert cfg_b == cfg_a
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_npz_to_npz_keeps_the_embedded_config(npz, tmp_path):
    """A native input carries its config: the flags' defaults (the
    flagship's) do not apply."""
    src, v = npz
    out = str(tmp_path / "copy.vrt.npz")
    convert_cli.main([src, out])
    got, cfg = convert.load_native(out)
    assert (cfg["n_fft"], cfg["nout"], cfg["nout_lstm"]) == (256, 8, 16)
    for k, a in _flat(v).items():
        np.testing.assert_array_equal(_flat(got)[k], a, err_msg=k)


def test_port_pth_loads_through_jax_load_checkpoint(npz, tmp_path):
    """A `.pth` the port writes is the reference's state_dict: JAX's
    `load_checkpoint` reads it back to the same variables."""
    src, v = npz
    pth = str(tmp_path / "small.pth")
    convert.export_torch(pth, convert.load_model(src, 256, 128))
    got = JCascadedNet(256, 128, 8, 16)
    fv = _flat(jconvert.load_checkpoint(pth, got))
    for k, a in _flat(v).items():
        np.testing.assert_array_equal(fv[k], a, err_msg=k)


def test_jax_pth_converts_to_the_jax_variables(tmp_path):
    jmod, v = _jax_variables(seed=4)
    pth, out = str(tmp_path / "jax.pth"), str(tmp_path / "out.vrt.npz")
    jconvert.export_torch(pth, jmod, v)
    convert_cli.main([pth, out] + SMALL)
    got, cfg = convert.load_native(out)
    assert cfg == jconvert.model_config(jmod)
    for k, a in _flat(v).items():
        np.testing.assert_array_equal(_flat(got)[k], a, err_msg=k)


def test_complex_pth(tmp_path):
    """`--complex` builds the complex-mask model for a `.pth` input; its
    config and weights reach the native file, as JAX's converter writes
    them."""
    jmod, v = _jax_variables(is_complex=True, seed=5)
    pth = str(tmp_path / "cx.pth")
    jconvert.export_torch(pth, jmod, v)
    ours, theirs = str(tmp_path / "ours.vrt.npz"), str(tmp_path / "j.vrt.npz")
    convert_cli.main([pth, ours, "--complex"] + SMALL)
    model = JCascadedNet(256, 128, 8, 16, is_complex=True)
    jconvert.save_native(theirs, jconvert.load_checkpoint(pth, model),
                         jconvert.model_config(model))
    (a, cfg_a), (b, cfg_b) = (convert.load_native(ours),
                              convert.load_native(theirs))
    assert cfg_a == cfg_b and cfg_a["is_complex"] is True
    for k, x in _flat(b).items():
        np.testing.assert_array_equal(_flat(a)[k], x, err_msg=k)
    with pytest.raises(RuntimeError):  # without --complex: wrong shapes
        convert_cli.main([pth, str(tmp_path / "no.vrt.npz")] + SMALL)


def test_load_checkpoint_refuses_another_config(npz):
    src, _ = npz
    with pytest.raises(ValueError, match="is_complex=False"):
        convert.load_checkpoint(src, CascadedNet(256, 128, 8, 16,
                                                 is_complex=True))
    model = convert.load_checkpoint(src, CascadedNet(256, 128, 8, 16))
    assert isinstance(model, CascadedNet)


@pytest.mark.parametrize("argv,match", [
    (["--quantize", "int8"], "A13"),
    ([], "output must end in"),
])
def test_cli_refusals(npz, tmp_path, argv, match):
    out = str(tmp_path / ("out.vrt.npz" if argv else "out.bin"))
    with pytest.raises(SystemExit, match=match):
        convert_cli.main([npz[0], out] + argv)


def test_export_torch_writes_cpu_tensors_with_the_reference_keys(npz,
                                                                 tmp_path):
    src, _ = npz
    model = convert.load_model(src, 256, 128)
    pth = str(tmp_path / "m.pth")
    convert.export_torch(pth, model)
    sd = torch.load(pth, weights_only=True)
    assert list(sd) == list(model.state_dict())
    assert all(t.device.type == "cpu" for t in sd.values())
    again = convert.load_model(pth, 256, 128, 8, 16)
    for k, t in model.state_dict().items():
        assert torch.equal(again.state_dict()[k], t), k
