"""GPU port: int8 files and CLIs against the JAX package on the CPU:
`save_native(..., quantize="int8")` and `cli.convert --quantize int8`
write JAX's arrays, each package reads the other's file, and
`cli.inference --precision int8` separates in every mode on a small
checkpoint."""

import os

import jax
import numpy as np
import pytest
import torch

from vocal_remover_tpu.cli import convert as jconvert_cli
from vocal_remover_tpu.cli import inference as jcli
from vocal_remover_tpu.models import convert as jconvert
from vocal_remover_tpu_torch.cli import convert as convert_cli
from vocal_remover_tpu_torch.cli import inference as cli
from vocal_remover_tpu_torch.models import convert
from vocal_remover_tpu_torch.utils import audio

from torch_port_helpers import max_lsb, small_pair, synth_song

torch.set_num_threads(1)

SR = 8000
SNR_FLOOR_DB = 40.0  # JAX's int8 quality gate
SMALL_CLI = ["-r", str(SR), "-f", "256", "-H", "128", "-B", "2", "--gpu",
             "-1"]


def _npz_arrays(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _snr_db(ref, test):
    num = float(np.sum(ref.astype(np.float64) ** 2))
    den = float(np.sum((ref - test).astype(np.float64) ** 2))
    return float("inf") if den == 0 else 10.0 * np.log10(num / den)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A small checkpoint of perturbed weights (written by the JAX
    package), a 3 s song, and the port's highest stems of it."""
    d = tmp_path_factory.mktemp("int8cli")
    jmod, v, _ = small_pair()
    ckpt = str(d / "small.vrt.npz")
    jconvert.save_native(ckpt, v, jconvert.model_config(jmod))
    song_dir = d / "songs"
    song_dir.mkdir()
    song = str(song_dir / "song.wav")
    audio.write_wav(song, synth_song(SR, 3.0), SR)
    cli.main(["-P", ckpt, "-i", song, "-o", str(d / "highest")] + SMALL_CLI)
    return d, jmod, v, ckpt, song, _stems(d / "highest")


def _stems(out_dir, name="song"):
    return [np.round(audio.read_wav(os.path.join(out_dir, f"{name}_{s}.wav"))
                     [0] * 32768.0).astype(np.int32)
            for s in ("Instruments", "Vocals")]


def _mix(path):
    return np.round(audio.read_wav(path)[0] * 32768.0).astype(np.int32)


def test_save_native_int8_writes_jax_arrays_and_both_read_both(files,
                                                               tmp_path):
    """The same tree saved by both packages with quantize="int8": the
    same keys (`.q8` / `.q8scale` for every kernel of two or more
    dimensions, 1-D leaves as they are), dtypes and values; each
    package's load_native dequantizes the other's file to the same
    arrays."""
    _, _, v, *_ = files
    tree = jax.tree_util.tree_map(np.asarray, v)
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    cfg = {"n_fft": 256}
    convert.save_native(ours, tree, cfg, quantize="int8")
    jconvert.save_native(theirs, tree, cfg, quantize="int8")
    a, b = _npz_arrays(ours), _npz_arrays(theirs)
    assert sorted(a) == sorted(b)
    assert any(k.endswith(".q8") for k in a)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for path in (ours, theirs):
        (t_tree, t_cfg), (j_tree, j_cfg) = (convert.load_native(path),
                                            jconvert.load_native(path))
        assert t_cfg == j_cfg == cfg
        tj, jj = convert._flatten(t_tree), convert._flatten(j_tree)
        assert sorted(tj) == sorted(jj)
        for k in tj:
            np.testing.assert_array_equal(tj[k], jj[k], err_msg=k)
    with pytest.raises(ValueError, match="unsupported quantize"):
        convert.save_native(ours, tree, cfg, quantize="int4")


def test_cli_convert_quantize_int8(files, tmp_path, capsys):
    """Both converters on the same checkpoint write the same arrays; the
    port's file loads into a model (dequantized) and separates."""
    _, _, _, ckpt, song, _ = files
    ours, theirs = str(tmp_path / "q8.vrt.npz"), str(tmp_path / "j8.vrt.npz")
    convert_cli.main([ckpt, ours, "--quantize", "int8"])
    assert capsys.readouterr().out.strip() == \
        f"wrote native checkpoint {ours} (int8 weights)"
    jconvert_cli.main([ckpt, theirs, "--quantize", "int8"])
    a, b = _npz_arrays(ours), _npz_arrays(theirs)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert os.path.getsize(ours) < os.path.getsize(ckpt) / 2
    cli.main(["-P", ours, "-i", song, "-o", str(tmp_path / "q8")]
             + SMALL_CLI)
    y, v = _stems(tmp_path / "q8")
    assert max_lsb(y + v, _mix(song)) <= 2


@pytest.mark.parametrize("mode", [[], ["--stream"], ["--postprocess"]],
                         ids=["device", "stream", "postprocess"])
def test_cli_inference_int8(files, tmp_path, mode):
    """--precision int8 on the CPU in each single-file path (the device
    pipeline, segment streaming, the spectrogram path): the stems add
    back to the mixture (2 LSB, over the spectrogram path's natural
    length) and stay >= 40 dB from the highest stems of the same path."""
    d, _, _, ckpt, song, highest = files
    out = str(tmp_path / "int8")
    cli.main(["-P", ckpt, "-i", song, "-o", out, "--precision", "int8"]
             + SMALL_CLI + mode)
    y, v = _stems(out)
    n = y.shape[-1]
    assert max_lsb(y + v, _mix(song)[:, :n]) <= 2
    ref = highest
    if mode:
        cli.main(["-P", ckpt, "-i", song, "-o", str(tmp_path / "hi")]
                 + SMALL_CLI + mode)
        ref = _stems(tmp_path / "hi")
    for a, b in zip(ref, (y, v)):
        assert _snr_db(a, b) >= SNR_FLOOR_DB


def test_cli_directory_int8(files, tmp_path):
    """--input_dir in int8 (the service's compute stream) against the
    same song alone through the single-file int8 path at the directory's
    crop and batch: >= 40 dB (dynamic scales depend on which patches
    share a chunk, in JAX too)."""
    d, _, _, ckpt, song, _ = files
    out = str(tmp_path / "dir")
    cli.main(["-P", ckpt, "--input_dir", str(d / "songs"), "-o", out,
              "-c", "256", "--group", "2", "--precision", "int8"]
             + SMALL_CLI)
    y, v = _stems(out)
    assert max_lsb(y + v, _mix(song)) <= 2
    cli.main(["-P", ckpt, "-i", song, "-o", str(tmp_path / "one"), "-c",
              "256", "--precision", "int8"] + SMALL_CLI)
    for a, b in zip(_stems(tmp_path / "one"), (y, v)):
        assert _snr_db(a, b) >= SNR_FLOOR_DB


def test_flat_conv_with_int8_is_refused_as_in_jax(files, tmp_path):
    _, _, _, ckpt, song, _ = files
    msg = "flat packing and int8 are exclusive serving transforms"
    argv = ["-P", ckpt, "-i", song, "-o", str(tmp_path / "x"), "-r",
            str(SR), "-f", "256", "-H", "128", "--precision", "int8",
            "--flat_conv"]
    with pytest.raises(ValueError, match=msg):
        cli.main(argv + ["--gpu", "-1"])
    with pytest.raises(ValueError, match=msg):
        jcli.main(argv)
