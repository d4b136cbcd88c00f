"""GPU port: whole-song separation and the single-file CLI vs the JAX
`Separator.separate_wave` (recurrence under the Pallas kernel in
interpret mode), on the CPU."""

import os

import jax
import numpy as np
import pytest
import torch

from vocal_remover_tpu.models.cascaded import CascadedNet as JCascadedNet
from vocal_remover_tpu.nn import config as jconfig
from vocal_remover_tpu.separate.separator import Separator as JSeparator
from vocal_remover_tpu_torch.cli import inference as cli
from vocal_remover_tpu_torch.models import convert
from vocal_remover_tpu_torch.models.cascaded import CascadedNet
from vocal_remover_tpu_torch.separate.separator import Separator
from vocal_remover_tpu_torch.utils import audio

from torch_port_helpers import perturb_bn, synth_song

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    jmod = JCascadedNet(256, 128, 8, 16)
    v = perturb_bn(jmod.init(jax.random.PRNGKey(7)), np.random.default_rng(7))
    tmod = convert.from_jax_variables(CascadedNet(256, 128, 8, 16), v)
    return jmod, v, tmod


@pytest.mark.parametrize("tta", [False, True])
def test_separate_wave_matches_jax(pair, tta):
    """PCM16 stems within 1 LSB of the JAX device pipeline."""
    jmod, v, tmod = pair
    wave = synth_song(seconds=3.0)
    jconfig.set_lstm_impl("pallas")
    try:
        ref_y, ref_v = JSeparator(jmod, v, batchsize=2, cropsize=256) \
            .separate_wave(wave, tta=tta, pcm16_io=True)
    finally:
        jconfig.set_lstm_impl("scan")
    y, vo = Separator(tmod, batchsize=2, cropsize=256, device="cpu") \
        .separate_wave(wave, tta=tta, pcm16_io=True)
    assert y.dtype == vo.dtype == np.int16
    assert y.shape == vo.shape == wave.shape
    assert np.abs(y.astype(np.int32) - ref_y).max() <= 1
    assert np.abs(vo.astype(np.int32) - ref_v).max() <= 1


def test_cli_separates_a_song(pair, tmp_path):
    _, v, tmod = pair
    ckpt = str(tmp_path / "small.vrt.npz")
    convert.save_native(ckpt, v, convert.model_config(tmod))
    wave = synth_song(seconds=2.0)
    song = str(tmp_path / "song.wav")
    audio.write_wav(song, wave, 8000)
    out = tmp_path / "out"
    cli.main(["-P", ckpt, "-i", song, "-r", "8000", "-f", "256", "-H", "128",
              "-B", "2", "-o", str(out), "--gpu", "-1"])
    y, sr = audio.read_wav(str(out / "song_Instruments.wav"))
    vo, _ = audio.read_wav(str(out / "song_Vocals.wav"))
    assert sr == 8000 and y.shape == vo.shape == wave.shape
    want_y, want_v = Separator(tmod, batchsize=2, cropsize=256,
                               device="cpu").separate_wave(
        audio.read_wav(song)[0], pcm16_io=True, bucket=30 * 8000)
    np.testing.assert_array_equal(np.round(y * 32768), want_y)
    np.testing.assert_array_equal(np.round(vo * 32768), want_v)
    # the stems add back up to the mixture where the iSTFT covers it
    mix = audio.pcm16_encode(audio.read_wav(song)[0]).astype(np.int32)
    n_cov = 128 * (wave.shape[-1] // 128)
    assert np.abs(want_y.astype(np.int32) + want_v - mix)[:, :n_cov].max() <= 2


@pytest.mark.parametrize("argv", [
    ["--input_dir", "songs"],
    ["-i", "x.wav", "--stream"],
    ["-i", "x.wav", "--postprocess"],
    ["-i", "x.wav", "--output_image"],
    ["-i", "x.wav", "--flat_conv"],
    ["-i", "x.wav", "--group", "8"],
    ["-i", "x.wav", "--data_parallel", "2"],
    ["-i", "x.wav", "--profile", "trace"],
    ["-i", "x.wav", "--precision", "bfloat16"],
    ["-i", "x.wav", "-P", "model.pth"],
    ["-i", "x.wav", "-P", "model.vrtx"],
])
def test_cli_refuses_unported_modes(argv):
    with pytest.raises(SystemExit, match="later slice|next slice|slice"):
        cli.main(argv)


def test_no_silent_cpu_fallback(pair, tmp_path, monkeypatch):
    """Without a card, the CLI and the library raise unless the CPU was
    asked for."""
    _, v, tmod = pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Separator(tmod)
    ckpt = str(tmp_path / "small.vrt.npz")
    convert.save_native(ckpt, v, convert.model_config(tmod))
    song = str(tmp_path / "song.wav")
    audio.write_wav(song, synth_song(seconds=1.0), 8000)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-P", ckpt, "-i", song, "-r", "8000", "-f", "256",
                  "-H", "128", "-o", str(tmp_path)])
    assert not os.path.exists(tmp_path / "song_Instruments.wav")
