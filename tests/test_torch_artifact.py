"""GPU port: AOT serving artifacts (separate/artifact.py) and the
recurrence as a torch.library custom op, on the CPU.

The tiny CascadedNet(256, 128, 8, 16) of tests/test_artifact.py, with the
same JAX-initialised weights, exported by the port (torch.export) and by
the JAX package (jax.export): the port's artifact against the port's
eager serving model and against JAX's artifact, its refusals, and the
eager path after an export in the same process."""

import json
import os
import zipfile

import jax
import numpy as np
import pytest
import torch

from vocal_remover_tpu.models.cascaded import CascadedNet as JCascadedNet
from vocal_remover_tpu.separate import artifact as jartifact
from vocal_remover_tpu_torch.models import convert, serving
from vocal_remover_tpu_torch.models.cascaded import CascadedNet
from vocal_remover_tpu_torch.nn import config, lstm_kernel
from vocal_remover_tpu_torch.ops import resize
from vocal_remover_tpu_torch.separate import artifact

torch.set_num_threads(1)

CROPS = (256, 384)
DTYPES = {"highest": None, "bfloat16": "bfloat16"}


@pytest.fixture(scope="module")
def pair():
    """(JAX module, its variables, the port's module with the same
    weights): test_artifact.py's tiny model and key."""
    jmod = JCascadedNet(256, 128, 8, 16)
    v = jax.tree_util.tree_map(np.asarray, jmod.init(jax.random.PRNGKey(0)))
    return jmod, v, convert.from_jax_variables(CascadedNet(256, 128, 8, 16),
                                               v)


@pytest.fixture(scope="module")
def artifacts(pair, tmp_path_factory):
    """The port's artifact of the pair's weights in each precision, on
    the CPU at CROPS: {precision: path}."""
    d = tmp_path_factory.mktemp("artifacts")
    paths = {}
    for precision, dtype in DTYPES.items():
        paths[precision] = str(d / f"{precision}.vrtx")
        artifact.export_artifact(pair[2], paths[precision], device="cpu",
                                 dtype=dtype, cropsizes=CROPS,
                                 precision=precision)
    return paths


@pytest.fixture(scope="module")
def jax_artifact(pair, tmp_path_factory):
    """JAX's artifact of the same weights, exported for the CPU with f32
    weights."""
    jmod, v, _ = pair
    path = str(tmp_path_factory.mktemp("jax") / "jax.vrtx")
    jartifact.export_artifact(jmod, v, path, platforms=("cpu",),
                              dtype=None, cropsizes=CROPS)
    return path


def _patches(batch, crop, seed):
    rng = np.random.default_rng(seed)
    return np.abs(rng.standard_normal((batch, 2, 129, crop))).astype(
        np.float32)


@pytest.mark.parametrize("precision", list(DTYPES))
def test_artifact_matches_eager_serving_model(pair, artifacts, precision):
    """The loaded artifact == the port's serving-transformed model, at
    batch 1, 3 and 4 (the symbolic batch) and both widths, under the
    caller's default mode: the artifact sets its own."""
    am = artifact.load_artifact(artifacts[precision])
    assert am.cropsizes == list(CROPS)
    model = pair[2]
    assert (am.n_fft, am.hop_length, am.offset, am.is_complex,
            am.output_bin, am.channels) == (
        model.n_fft, model.hop_length, model.offset, model.is_complex,
        model.output_bin, 2)
    served = serving.serving_variables(model, DTYPES[precision])
    for batch in (1, 3, 4):
        for crop in CROPS:
            x = torch.from_numpy(_patches(batch, crop, batch + crop))
            with torch.inference_mode():
                got = am(x)
                with config.precision(precision):
                    want = served(x)
            assert got.shape == (batch, 2, 129, crop)
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    assert config.get_precision() == "highest"


def test_artifact_matches_jax_artifact(artifacts, jax_artifact):
    """The port's `highest` artifact against JAX's artifact of the same
    weights, within the port's forward tolerance against JAX."""
    jam = jartifact.load_artifact(jax_artifact)
    am = artifact.load_artifact(artifacts["highest"])
    for batch in (1, 3):
        for crop in CROPS:
            x = _patches(batch, crop, 7 * batch + crop)
            want = np.asarray(jam({}, x.transpose(0, 2, 3, 1)))
            with torch.inference_mode():
                got = am(torch.from_numpy(x)).numpy()
            np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2),
                                       atol=5e-5)


def test_meta_holds_the_jax_keys_and_the_ports(artifacts):
    with zipfile.ZipFile(artifacts["bfloat16"]) as z:
        meta = json.loads(z.read("meta.json"))
        names = sorted(z.namelist())
        stored = {i.filename: i.compress_type for i in z.infolist()}
    assert names == ["exported_256.pt2", "exported_384.pt2", "meta.json"]
    assert stored["exported_256.pt2"] == zipfile.ZIP_STORED
    assert meta["format_version"] == 1 and meta["format"] == "torch.export"
    assert meta["kind"] == "patch_mask" and meta["cropsizes"] == [256, 384]
    assert (meta["offset"], meta["output_bin"], meta["channels"]) == (
        64, 129, 2)
    assert meta["serving_transform"] is True
    assert meta["weights_dtype"] == "bfloat16"
    assert meta["precision"] == "bfloat16" and meta["platforms"] == ["cpu"]
    assert meta["torch_version"] == torch.__version__
    assert meta["model_config"] == {
        "n_fft": 256, "hop_length": 128, "nout": 8, "nout_lstm": 16,
        "is_complex": False, "arch": "CascadedNet"}


def test_graph_holds_the_recurrence_op_once_per_band_net(artifacts):
    """Each entry calls the custom op five times (one BiLSTM per band
    net): no Python loop of the plain version is unrolled into it."""
    am = artifact.load_artifact(artifacts["highest"])
    op = torch.ops.vocal_remover_tpu_torch.lstm_recurrence.default
    nodes = [n for n in am.program(256).graph.nodes if n.target is op]
    assert len(nodes) == 5


def _rewrite(src, dst, edit):
    """Copy the zip `src` to `dst` with meta.json passed through `edit`."""
    with zipfile.ZipFile(src) as zin, zipfile.ZipFile(dst, "w") as zout:
        meta = json.loads(zin.read("meta.json"))
        edit(meta)
        zout.writestr("meta.json", json.dumps(meta))
        for name in zin.namelist():
            if name != "meta.json":
                zout.writestr(name, zin.read(name))


def _future(meta):
    meta["format_version"] = 999


@pytest.mark.parametrize("case,error,match", [
    ("shape", ValueError, "patches"),
    ("crop", ValueError, "no entry for cropsize 128"),
    ("future", ValueError, "format_version"),
    ("jax", ValueError, "needs jax"),
    ("train", RuntimeError, "eval-only"),
])
def test_artifact_refusals(artifacts, jax_artifact, tmp_path, case, error,
                           match):
    path = artifacts["highest"]
    if case in ("future", "jax"):
        bad = jax_artifact
        if case == "future":
            bad = str(tmp_path / "future.vrtx")
            _rewrite(path, bad, _future)
        with pytest.raises(error, match=match):
            artifact.load_artifact(bad)
        return
    am = artifact.load_artifact(path)
    with pytest.raises(error, match=match):
        if case == "shape":
            am(torch.zeros(1, 2, 130, 256))
        elif case == "crop":
            am(torch.zeros(1, 2, 129, 128))
        else:
            am.train()
    assert am.eval() is am  # eval mode is what it already is


def test_export_refuses_a_crop_without_roi(pair, tmp_path):
    with pytest.raises(ValueError, match="no roi"):
        artifact.export_artifact(pair[2], str(tmp_path / "x.vrtx"),
                                 device="cpu", cropsizes=(128, 256))
    assert not os.path.exists(tmp_path / "x.vrtx")


def test_load_model_points_to_load_artifact():
    with pytest.raises(ValueError, match="load_artifact"):
        convert.load_model("model.vrtx", 256, 128)


def test_export_leaves_the_eager_path_bit_identical(pair, tmp_path):
    """An export from a cold interp-matrix cache leaves no traced (fake)
    tensor in it: an eager forward afterwards equals one before, bit
    for bit."""
    served = serving.serving_variables(pair[2], "bfloat16")
    x = torch.from_numpy(_patches(2, 256, 3))
    with torch.inference_mode(), config.precision("bfloat16"):
        before = served(x)
    resize._cached_matrix.cache_clear()
    artifact.export_artifact(pair[2], str(tmp_path / "cold.vrtx"),
                             device="cpu", dtype="bfloat16",
                             cropsizes=(256,), precision="bfloat16")
    with torch.inference_mode(), config.precision("bfloat16"):
        after = served(x)
    assert type(after) is torch.Tensor
    assert torch.equal(before, after)


def test_artifact_moves_between_devices_and_refuses_casts(artifacts):
    am = artifact.load_artifact(artifacts["highest"], device="cpu")
    assert am.to("cpu") is am and am.device == torch.device("cpu")
    with pytest.raises(TypeError, match="baked in"):
        am.to(torch.float64)
    with pytest.raises(TypeError, match="baked in"):
        am.half()


def _recurrence_inputs(t_len, two_n, hidden, seed, device="cpu"):
    rng = np.random.default_rng(seed)
    xg = rng.standard_normal((t_len, two_n, 4 * hidden)).astype(np.float32)
    w_hh = (rng.standard_normal((2, hidden, 4 * hidden))
            / np.sqrt(hidden)).astype(np.float32)
    return (torch.from_numpy(xg).to(device),
            lstm_kernel.relayout(torch.from_numpy(w_hh).to(device)))


@pytest.mark.parametrize("t_len,two_n,hidden", [(16, 8, 16), (5, 2, 160)])
def test_opcheck_on_cpu(t_len, two_n, hidden):
    """The custom op's schema and fake (shape) function, and its CPU
    implementation (the plain version, counted as no launch)."""
    xg, w_cols = _recurrence_inputs(t_len, two_n, hidden, seed=t_len)
    op = torch.ops.vocal_remover_tpu_torch.lstm_recurrence.default
    torch.library.opcheck(op, (xg, w_cols),
                          test_utils=("test_schema", "test_faketensor"))
    before = lstm_kernel.launches
    assert torch.equal(op(xg, w_cols), lstm_kernel.recurrence_plain(
        xg, lstm_kernel.undo_relayout(w_cols)))
    assert lstm_kernel.launches == before


def test_op_has_no_gradient():
    """No autograd formula is registered (ROADMAP.md A9(b)): a loss
    through the recurrence raises in backward instead of getting no
    gradient through the branch."""
    xg, w_cols = _recurrence_inputs(4, 2, 8, seed=1)
    xg.requires_grad_(True)
    with pytest.raises(RuntimeError, match="autograd"):
        lstm_kernel.recurrence_cols(xg, w_cols).sum().backward()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("t_len,two_n,hidden", [(128, 8, 64), (512, 48, 64)])
def test_op_matches_plain_on_card(cuda_device, t_len, two_n, hidden):
    """On the card the op launches the kernel (one count a call) and
    matches the plain version; opcheck holds its schema and fake
    function there too."""
    xg, w_cols = _recurrence_inputs(t_len, two_n, hidden, seed=5,
                                    device=cuda_device)
    op = torch.ops.vocal_remover_tpu_torch.lstm_recurrence.default
    torch.library.opcheck(op, (xg, w_cols),
                          test_utils=("test_schema", "test_faketensor"))
    before = lstm_kernel.launches
    out = op(xg, w_cols)
    torch.cuda.synchronize()
    assert lstm_kernel.launches == before + 1
    ref = lstm_kernel.recurrence_plain(xg, lstm_kernel.undo_relayout(w_cols))
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               atol=2e-5)
