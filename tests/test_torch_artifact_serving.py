"""GPU port: the serving stack on an AOT artifact, on the CPU.

`Separator`, `SeparatorService` and `StreamingSeparator` take a loaded
artifact unchanged, and `python -m vocal_remover_tpu_torch.cli.export`
-> `cli.inference -P model.vrtx --gpu -1` serves it in every mode of the
CLI within 1 LSB of the `.vrt.npz` it came from."""

import os

import jax
import numpy as np
import pytest
import torch

from vocal_remover_tpu.models.cascaded import CascadedNet as JCascadedNet
from vocal_remover_tpu_torch.cli import export as export_cli
from vocal_remover_tpu_torch.cli import inference as cli
from vocal_remover_tpu_torch.models import convert
from vocal_remover_tpu_torch.models.cascaded import CascadedNet
from vocal_remover_tpu_torch.separate import artifact
from vocal_remover_tpu_torch.separate.separator import Separator
from vocal_remover_tpu_torch.separate.service import SeparatorService
from vocal_remover_tpu_torch.separate.streaming import StreamingSeparator
from vocal_remover_tpu_torch.utils import audio

from torch_port_helpers import max_lsb, synth_song

torch.set_num_threads(1)

SR = 8000


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """tests/test_artifact.py's tiny model and weights as a `.vrt.npz`."""
    jmod = JCascadedNet(256, 128, 8, 16)
    v = jax.tree_util.tree_map(np.asarray, jmod.init(jax.random.PRNGKey(0)))
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.vrt.npz")
    convert.save_native(path, v, convert.model_config(
        CascadedNet(256, 128, 8, 16)))
    return path


@pytest.fixture(scope="module")
def exported(ckpt, tmp_path_factory):
    """The checkpoint through the export CLI on the CPU: `highest` at
    crop 256 (the library tests) and the CLI's default bfloat16 at crop
    256 (the inference CLI's tests). -> {precision: path}."""
    d = tmp_path_factory.mktemp("vrtx")
    paths = {p: str(d / f"{p}.vrtx") for p in ("highest", "bfloat16")}
    export_cli.main([ckpt, paths["highest"], "--gpu", "-1", "--cropsizes",
                     "256", "--precision", "highest", "-f", "256", "-H",
                     "128"])
    export_cli.main([ckpt, paths["bfloat16"], "--gpu", "-1",
                     "--cropsizes", "256"])
    return paths


def test_export_cli_prints_the_jax_summary(ckpt, exported, tmp_path, capsys):
    path = str(tmp_path / "again.vrtx")
    export_cli.main([ckpt, path, "--gpu", "-1", "--cropsizes", "256"])
    out = capsys.readouterr().out
    assert out.startswith(f"wrote {path} ({os.path.getsize(path)} bytes): "
                          "CascadedNet n_fft=256 device=cpu crops=[256]")
    assert artifact.load_artifact(path).meta["precision"] == "bfloat16"


def test_export_cli_needs_a_card_unless_asked_for_the_cpu(ckpt, tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_cli.main([ckpt, str(tmp_path / "x.vrtx")])
    assert not os.path.exists(tmp_path / "x.vrtx")


def test_artifact_separator_matches_the_checkpoint(ckpt, exported):
    """artifact_separator's stems within 1 LSB of Separator on the
    `.vrt.npz`, with and without TTA."""
    wave = synth_song(SR, 3.3)
    sp_art = artifact.artifact_separator(exported["highest"], batchsize=2,
                                         device="cpu")
    assert sp_art.cropsize == 256 and sp_art.precision == "highest"
    sp = Separator(convert.load_model(ckpt, 256, 128), batchsize=2,
                   device="cpu")
    for tta in (False, True):
        got = sp_art.separate_wave(wave, tta=tta, pcm16_io=True)
        want = sp.separate_wave(wave, tta=tta, pcm16_io=True)
        for a, b in zip(got, want):
            assert a.shape == b.shape and max_lsb(a, b) <= 1


def test_service_and_streaming_take_the_artifact(ckpt, exported):
    """SeparatorService and StreamingSeparator on the artifact give the
    model's stems."""
    model = convert.load_model(ckpt, 256, 128)
    am = artifact.load_artifact(exported["highest"])
    songs = [synth_song(SR, s) for s in (2.0, 2.0, 3.1)]

    def service(m):
        return list(SeparatorService(
            Separator(m, batchsize=2, cropsize=256, device="cpu"),
            group=2).map(iter(songs)))

    for got, want in zip(service(am), service(model)):
        for a, b in zip(got, want):
            assert a.shape == b.shape and max_lsb(a, b) <= 1
    wave = synth_song(SR, 5.0)
    got = StreamingSeparator(am, segment_patches=4, batchsize=2,
                             device="cpu").separate_wave(wave)
    want = StreamingSeparator(model, segment_patches=4, batchsize=2,
                              device="cpu").separate_wave(wave)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=1.0 / 32768)


def _stems(out_dir, name, ext=".wav"):
    return [audio.read_wav(os.path.join(out_dir, f"{name}_{s}{ext}"))[0]
            for s in ("Instruments", "Vocals")]


# the CLI's modes: extra flags, and whether the input is a directory
MODES = {
    "pipeline": ([], False),
    "tta": (["--tta"], False),
    "stream": (["--stream"], False),
    "postprocess": (["--postprocess"], False),
    "output_image": (["--output_image"], False),
    "directory": (["-c", "256", "--group", "2"], True),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_cli_serves_the_artifact(ckpt, exported, tmp_path, mode):
    """export CLI -> `inference -P model.vrtx --gpu -1` (bfloat16, the
    export default): stems within 1 LSB of `-P ckpt.vrt.npz --gpu -1
    --precision bfloat16` in every mode; `--flat_conv` has no effect on
    an artifact."""
    flags, directory = MODES[mode]
    song_dir = tmp_path / "songs"
    song_dir.mkdir()
    names = ["a", "b"] if directory else ["a"]
    for k, name in enumerate(names):
        audio.write_wav(str(song_dir / f"{name}.wav"),
                        synth_song(SR, 2.6 + k), SR)
    src = (["--input_dir", str(song_dir)] if directory
           else ["-i", str(song_dir / "a.wav")])
    common = src + ["-r", str(SR), "-f", "256", "-H", "128", "-B", "2",
                    "--gpu", "-1"] + flags
    cli.main(["-P", ckpt, "-o", str(tmp_path / "npz"), "--precision",
              "bfloat16"] + common)
    cli.main(["-P", exported["bfloat16"], "-o", str(tmp_path / "vrtx"),
              "--flat_conv"] + common)
    for name in names:
        for a, b in zip(_stems(tmp_path / "vrtx", name),
                        _stems(tmp_path / "npz", name)):
            assert a.shape == b.shape
            assert np.abs(a - b).max() <= 1.0 / 32768 + 1e-9
    if mode == "output_image":
        for stem in ("Instruments", "Vocals"):
            assert any(os.path.exists(tmp_path / "vrtx" / f"a_{stem}{e}")
                       for e in (".jpg", ".png"))


def test_cli_refuses_a_crop_the_artifact_lacks(exported, tmp_path):
    song = str(tmp_path / "a.wav")
    audio.write_wav(song, synth_song(SR, 1.0), SR)
    with pytest.raises(SystemExit, match=r"cropsizes \[256\]"):
        cli.main(["-P", exported["bfloat16"], "-i", song, "-c", "384",
                  "--gpu", "-1", "-o", str(tmp_path)])
