"""GPU port, tools slice: `python -m vocal_remover_tpu_torch.cli.<tool>`
for evaluate, pseudo, augment, spec_debug, dataset_images and plot_log,
each run in-process beside the JAX package's tool of the same name on
the same files (seeded synthetic pairs) and, where there is one, the
same checkpoint (JAX's tiny CascadedNet(256, 128, 8, 16) with perturbed
batch norm, as a `.vrt.npz`). The port's evaluate and pseudo run with
`--gpu -1`."""

import builtins
import json
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

from vocal_remover_tpu.cli import augment as jaugment
from vocal_remover_tpu.cli import dataset_images as jdataset_images
from vocal_remover_tpu.cli import evaluate as jevaluate
from vocal_remover_tpu.cli import plot_log as jplot_log
from vocal_remover_tpu.cli import pseudo as jpseudo
from vocal_remover_tpu.cli import spec_debug as jspec_debug
from vocal_remover_tpu.models import convert as jconvert
from vocal_remover_tpu.models.cascaded import CascadedNet as JCascadedNet
from vocal_remover_tpu.utils import audio as jaudio
from vocal_remover_tpu_torch.cli import (
    augment,
    dataset_images,
    evaluate,
    plot_log,
    pseudo,
    spec_debug,
)

from torch_port_helpers import perturb_bn

torch.set_num_threads(1)

SR = 8000
SR_IMAGES = 44100  # spec_debug and dataset_images work at 44.1 kHz
SEP_FLAGS = ["-r", str(SR), "-f", "256", "-H", "128", "-B", "2"]


def _write_pairs(root, sr, seconds, names=("s0", "s1")):
    rng = np.random.default_rng(17)
    for sub in ("mixtures", "instruments"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i, name in enumerate(names):
        t = np.arange(int(sr * seconds)) / sr
        y = np.stack([0.4 * np.sin(2 * np.pi * (200 + 40 * i) * t),
                      0.35 * np.sin(2 * np.pi * (300 + 40 * i) * t)])
        y = y + 0.02 * rng.standard_normal(y.shape)
        v = 0.2 * np.sin(2 * np.pi * 1000 * t * (1 + 0.01 * np.sin(3 * t)))
        jaudio.write_wav(os.path.join(root, "instruments", f"{name}.wav"),
                         y.astype(np.float32), sr)
        jaudio.write_wav(os.path.join(root, "mixtures", f"{name}.wav"),
                         (y + np.stack([v, 0.8 * v])).astype(np.float32), sr)
    return os.path.join(root, "mixtures"), os.path.join(root, "instruments")


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """Two 3 s stereo 8 kHz pairs (read only)."""
    return _write_pairs(str(tmp_path_factory.mktemp("pairs")), SR, 3.0)


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    model = JCascadedNet(256, 128, 8, 16)
    v = perturb_bn(model.init(jax.random.PRNGKey(0)),
                   np.random.default_rng(0))
    path = str(tmp_path_factory.mktemp("ckpt") / "model.vrt.npz")
    jconvert.save_native(path, v, jconvert.model_config(model))
    return path


# ---------------------------------------------------------------------------
# evaluate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [[], ["--tta"], ["--postprocess"],
                                   ["--postprocess", "--tta"]],
                         ids=["wave", "wave_tta", "postprocess",
                              "postprocess_tta"])
def test_evaluate_matches_jax(pairs, tiny_ckpt, tmp_path, flags, capsys):
    """Every SDR / SI-SDR / median SDR of the JSON within 1e-3 dB of the
    JAX tool's, the same songs and keys."""
    mix, inst = pairs
    argv = ["-P", tiny_ckpt, "-m", mix, "-i", inst] + SEP_FLAGS + flags
    jevaluate.main(argv + ["--json", str(tmp_path / "jax.json")])
    evaluate.main(argv + ["--json", str(tmp_path / "port.json"),
                          "--gpu", "-1"])
    out = capsys.readouterr().out
    assert out.count("inst SDR") == 4 and out.count("mean:") == 2
    with open(tmp_path / "jax.json") as f:
        want = json.load(f)
    with open(tmp_path / "port.json") as f:
        got = json.load(f)
    assert [r["song"] for r in got["songs"]] == \
        [r["song"] for r in want["songs"]] and len(got["songs"]) == 2
    assert set(got["mean"]) == set(want["mean"]) and len(got["mean"]) == 6
    for g, w in zip(got["songs"] + [got["mean"]],
                    want["songs"] + [want["mean"]]):
        assert set(g) == set(w)
        for k, val in w.items():
            if k != "song":
                assert np.isfinite(g[k]) and abs(g[k] - val) <= 1e-3, k


# ---------------------------------------------------------------------------
# pseudo
# ---------------------------------------------------------------------------

def test_pseudo_matches_jax(pairs, tiny_ckpt, tmp_path):
    """Each `_PseudoInstruments.npy` complex64 (2, F, T) within 1e-5 of
    its largest |z| of the JAX tool's, and the one-sample placeholder WAV
    beside it."""
    mix, inst = pairs
    argv = ["-P", tiny_ckpt, "-m", mix, "-i", inst] + SEP_FLAGS
    jpseudo.main(argv + ["-o", str(tmp_path / "jax")])
    pseudo.main(argv + ["-o", str(tmp_path / "port"), "--gpu", "-1"])
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "jax")) == [
            "s0_PseudoInstruments.npy", "s0_PseudoInstruments.wav",
            "s1_PseudoInstruments.npy", "s1_PseudoInstruments.wav"]
    for name in ("s0", "s1"):
        got = np.load(tmp_path / "port" / f"{name}_PseudoInstruments.npy")
        want = np.load(tmp_path / "jax" / f"{name}_PseudoInstruments.npy")
        assert got.dtype == want.dtype == np.complex64
        assert got.shape == want.shape and got.shape[:2] == (2, 129)
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 1e-5 * scale
        w, sr = jaudio.read_wav(
            str(tmp_path / "port" / f"{name}_PseudoInstruments.wav"))
        assert sr == SR and w.shape[-1] == 1


@pytest.mark.parametrize("tool", [evaluate, pseudo])
def test_separating_tools_run_on_the_card_unless_asked(pairs, tiny_ckpt,
                                                       tmp_path, tool):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    mix, inst = pairs
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(["-P", tiny_ckpt, "-m", mix, "-i", inst, "-f", "256",
                   "-H", "128"] + (["-o", str(tmp_path)]
                                   if tool is pseudo else []))
    assert tool.build_parser().get_default("gpu") == 0


# ---------------------------------------------------------------------------
# augment
# ---------------------------------------------------------------------------

def _copy(src_pairs, dst):
    mix, inst = src_pairs
    shutil.copytree(mix, os.path.join(dst, "mixtures"))
    shutil.copytree(inst, os.path.join(dst, "instruments"))
    return os.path.join(dst, "mixtures"), os.path.join(dst, "instruments")


def test_augment_caches_equal_jax(pairs, tmp_path, capsys):
    """Names, dtype, shape and values of every `_pitch-1.npy` of a
    two-pair dataset equal the JAX tool's; a second run skips both
    pairs."""
    flags = ["-r", str(SR), "-f", "512", "-l", "256", "-p", "-1"]
    jmix, jinst = _copy(pairs, str(tmp_path / "jax"))
    mix, inst = _copy(pairs, str(tmp_path / "port"))
    jaugment.main(["-m", jmix, "-i", jinst] + flags)
    capsys.readouterr()
    augment.main(["-m", mix, "-i", inst] + flags)
    assert capsys.readouterr().out.split() == ["s0", "s1"]
    sub = f"sr{SR}_hl256_nf512"
    for d, jd in ((mix, jmix), (inst, jinst)):
        names = sorted(os.listdir(os.path.join(d, sub)))
        assert names == sorted(os.listdir(os.path.join(jd, sub))) == [
            "s0_pitch-1.npy", "s1_pitch-1.npy"]
        for n in names:
            got = np.load(os.path.join(d, sub, n))
            want = np.load(os.path.join(jd, sub, n))
            assert got.dtype == np.complex64 and got.shape[:2] == (2, 257)
            assert got.shape == want.shape and np.array_equal(got, want)
    stamps = {n: os.path.getmtime(os.path.join(mix, sub, n))
              for n in os.listdir(os.path.join(mix, sub))}
    augment.main(["-m", mix, "-i", inst] + flags)
    assert capsys.readouterr().out == ""
    assert stamps == {n: os.path.getmtime(os.path.join(mix, sub, n))
                      for n in os.listdir(os.path.join(mix, sub))}


def test_augment_soundstretch_without_the_binary_exits_as_jax(
        pairs, tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    mix, inst = pairs
    argv = ["-m", mix, "-i", inst, "--engine", "soundstretch"]
    with pytest.raises(SystemExit) as want:
        jaugment.main(argv)
    with pytest.raises(SystemExit) as got:
        augment.main(argv)
    assert got.value.code == want.value.code
    assert "soundstretch not found on PATH" in str(got.value.code)


# ---------------------------------------------------------------------------
# spec_debug, dataset_images
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pairs_44k(tmp_path_factory):
    """Two 1.5 s stereo 44.1 kHz pairs (the image tools' rate)."""
    return _write_pairs(str(tmp_path_factory.mktemp("pairs44k")),
                        SR_IMAGES, 1.5)


def _image_shape(path):
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im).shape


def test_spec_debug_matches_jax(pairs_44k, tmp_path, monkeypatch):
    """The same files; the WAVs within 1 LSB; the images of one shape."""
    mix, inst = (os.path.join(d, "s0.wav") for d in pairs_44k)
    for name, tool in (("jax", jspec_debug), ("port", spec_debug)):
        os.makedirs(tmp_path / name)
        monkeypatch.chdir(tmp_path / name)
        tool.main([mix, inst])
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == sorted(
        f"test_{s}.{e}" for s in "Xyv" for e in ("jpg", "wav"))
    for n in names:
        got, want = tmp_path / "port" / n, tmp_path / "jax" / n
        if n.endswith(".wav"):
            g, sr = jaudio.read_wav(str(got))
            w, _ = jaudio.read_wav(str(want))
            assert sr == SR_IMAGES and g.shape == w.shape
            assert np.abs(g - w).max() * 32768 <= 1
        else:
            shape = _image_shape(got)
            assert shape == _image_shape(want) and shape[0] == 1025


def test_spec_debug_without_pil_writes_png(pairs_44k, tmp_path,
                                           monkeypatch):
    """The card's machine has no PIL: the images are PNGs from the stdlib
    writer, under the same names with `.png`."""
    real_import = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("PIL hidden")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    monkeypatch.chdir(tmp_path)
    spec_debug.main([os.path.join(d, "s0.wav") for d in pairs_44k])
    assert sorted(os.listdir(tmp_path)) == sorted(
        f"test_{s}.{e}" for s in "Xyv" for e in ("png", "wav"))
    with open(tmp_path / "test_v.png", "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_dataset_images_match_jax(pairs_44k, tmp_path):
    """The same image names, each of the JAX tool's shape (each package
    caches its own copy of the pairs' spectrograms, byte-identical)."""
    jmix, jinst = _copy(pairs_44k, str(tmp_path / "jax"))
    mix, inst = _copy(pairs_44k, str(tmp_path / "port"))
    jdataset_images.main([jmix, jinst, str(tmp_path / "jax_out")])
    dataset_images.main([mix, inst, str(tmp_path / "port_out")])
    names = sorted(os.listdir(tmp_path / "port_out"))
    assert names == sorted(os.listdir(tmp_path / "jax_out")) == [
        "s0_Vocal.jpg", "s1_Vocal.jpg"]
    for n in names:
        shape = _image_shape(tmp_path / "port_out" / n)
        assert shape == _image_shape(tmp_path / "jax_out" / n)
        assert shape[0] == 1025 and shape[2] == 3
    sub = f"sr{SR_IMAGES}_hl1024_nf2048"
    for n in ("s0.npy", "s1.npy"):
        for d, jd in ((mix, jmix), (inst, jinst)):
            assert np.array_equal(np.load(os.path.join(d, sub, n)),
                                  np.load(os.path.join(jd, sub, n)))


# ---------------------------------------------------------------------------
# plot_log
# ---------------------------------------------------------------------------

@pytest.fixture
def loss_log(tmp_path):
    path = str(tmp_path / "loss_x.json")
    with open(path, "w") as f:
        json.dump([[0.5, 0.6], [0.4, 0.45], [0.35, 0.5]], f)
    return path


def test_plot_log_matches_jax(loss_log, tmp_path, capsys):
    jplot_log.main([loss_log, str(tmp_path / "jax.png")])
    want = capsys.readouterr().out.splitlines()
    plot_log.main([loss_log, str(tmp_path / "port.png")])
    got = capsys.readouterr().out.splitlines()
    assert got[0] == want[0] == ("epochs: 3  best val: 0.450000 @ epoch 1"
                                 "  (train there: 0.400000)")
    assert got[1] == f"saved {tmp_path / 'port.png'}"
    with open(tmp_path / "port.png", "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_plot_log_without_matplotlib_prints_then_exits_non_zero(
        loss_log, tmp_path, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(SystemExit) as e:
        plot_log.main([loss_log, str(tmp_path / "curve.png")])
    assert e.value.code not in (0, None) and "matplotlib" in str(e.value.code)
    assert capsys.readouterr().out.startswith("epochs: 3  best val: 0.450000")
    assert not os.path.exists(tmp_path / "curve.png")
