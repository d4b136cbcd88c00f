"""GPU port: whole-song separation and the single-file CLI vs the JAX
`Separator.separate_wave` (recurrence and, for the flat serving path,
the flat conv under their Pallas kernels in interpret mode), on the
CPU."""

import os

import jax
import numpy as np
import pytest
import torch

from vocal_remover_tpu.models import serving as jserving
from vocal_remover_tpu.models.cascaded import CascadedNet as JCascadedNet
from vocal_remover_tpu.nn import config as jconfig
from vocal_remover_tpu.parallel import mesh as jmesh
from vocal_remover_tpu.separate.separator import Separator as JSeparator
from vocal_remover_tpu_torch.cli import inference as cli
from vocal_remover_tpu_torch.models import convert
from vocal_remover_tpu_torch.models import serving as tserving
from vocal_remover_tpu_torch.models.cascaded import CascadedNet
from vocal_remover_tpu_torch.nn import config as tconfig
from vocal_remover_tpu_torch.separate.separator import Separator
from vocal_remover_tpu_torch.separate.service import SeparatorService
from vocal_remover_tpu_torch.separate.streaming import StreamingSeparator
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


def test_separate_wave_flat_matches_jax(pair):
    """The slice as a whole: the flat serving model (BN fold, packed
    enc2 / enc3) in `highest`, PCM16 stems within 1 LSB of the JAX
    Separator with serving_variables(flat=True)."""
    jmod, v, tmod = pair
    wave = synth_song(seconds=3.0)
    jv = jserving.serving_variables(v, None, model=jmod, flat=True)
    jconfig.set_lstm_impl("pallas")
    try:
        ref_y, ref_v = JSeparator(jmod, jv, batchsize=2, cropsize=256) \
            .separate_wave(wave, pcm16_io=True)
    finally:
        jconfig.set_lstm_impl("scan")
    tflat = tserving.serving_variables(tmod, flat=True)
    assert tflat.stg3_full_band_net.flat_enc is not None
    y, vo = Separator(tflat, batchsize=2, cropsize=256, device="cpu") \
        .separate_wave(wave, pcm16_io=True)
    assert y.dtype == vo.dtype == np.int16
    assert np.abs(y.astype(np.int32) - ref_y).max() <= 1
    assert np.abs(vo.astype(np.int32) - ref_v).max() <= 1


def _run_cli(tmp_path, ckpt, song, name, *flags):
    out = tmp_path / name
    cli.main(["-P", ckpt, "-i", song, "-r", "8000", "-f", "256", "-H", "128",
              "-B", "2", "-o", str(out), "--gpu", "-1", *flags])
    return [np.round(audio.read_wav(str(out / f"song_{stem}.wav"))[0]
                     * 32768).astype(np.int32)
            for stem in ("Instruments", "Vocals")]


def test_cli_flat_conv_and_precisions(pair, tmp_path):
    """`--flat_conv` writes the stems of the plain run within 1 LSB (f32
    throughout); `--precision default` is the same arithmetic on the CPU
    (TF32 exists only on the card); `--precision bfloat16` (with and
    without `--flat_conv`) stays within 40 dB of the f32 stems' energy
    and keeps the residual invariant, and the precision mode does not
    outlive the run."""
    _, v, tmod = pair
    ckpt = str(tmp_path / "small.vrt.npz")
    convert.save_native(ckpt, v, convert.model_config(tmod))
    song = str(tmp_path / "song.wav")
    audio.write_wav(song, synth_song(seconds=2.0), 8000)
    tconfig.set_precision("highest")
    plain = _run_cli(tmp_path, ckpt, song, "plain")
    flat = _run_cli(tmp_path, ckpt, song, "flat", "--flat_conv")
    default = _run_cli(tmp_path, ckpt, song, "default", "--precision",
                       "default", "--lstm_impl", "pallas")
    for a, b, c in zip(plain, flat, default):
        assert np.abs(a - b).max() <= 1
        np.testing.assert_array_equal(a, c)
    mix = audio.pcm16_encode(audio.read_wav(song)[0]).astype(np.int32)
    n_cov = 128 * (mix.shape[-1] // 128)
    for flags in (("--precision", "bfloat16"),
                  ("--precision", "bfloat16", "--flat_conv")):
        y, vo = _run_cli(tmp_path, ckpt, song, "-".join(flags), *flags)
        assert np.abs(y + vo - mix)[:, :n_cov].max() <= 2
        for a, b in zip(plain, (y, vo)):
            err = float(np.sum((a - b).astype(np.float64) ** 2))
            sig = float(np.sum(a.astype(np.float64) ** 2))
            assert 10 * np.log10(sig / max(err, 1e-300)) >= 40.0
    assert tconfig.get_precision() == "highest"


def test_separator_takes_its_precision(pair):
    _, _, tmod = pair
    assert Separator(tmod, device="cpu").precision == "highest"
    assert Separator(tmod, device="cpu",
                     precision="bfloat16").precision == "bfloat16"
    with pytest.raises(ValueError, match="precision"):
        Separator(tmod, device="cpu", precision="int8")


@pytest.mark.parametrize("argv,names", [
    (["-i", "x.wav", "--precision", "int8", "--gpu", "-1", "-P",
      "model.vrt.npz"], "A13"),
    (["-i", "x.wav", "-P", "model.vrtx", "--gpu", "-1"], "A11"),
])
def test_cli_refuses_unported_modes(argv, names):
    """Each refused flag exits with a message naming what brings it.
    `.vrtx` serving (A11) and `--precision int8` (A13) are ported: they
    pass the refusals and reach the loader, which reports the missing
    file."""
    if names in ("A11", "A13"):
        model = argv[argv.index("-P") + 1]
        with pytest.raises(FileNotFoundError, match=model):
            cli.main(argv)
        return
    with pytest.raises(SystemExit, match=names) as e:
        cli.main(argv)
    assert "not ported" in str(e.value) or "ported yet" in str(e.value)


@pytest.mark.parametrize("argv", [
    ["--input_dir", ".", "--group", "2", "--data_parallel", "2"],
    ["-i", "x.wav", "--data_parallel", "2", "--gpu", "-1"],
], ids=["group_and_data_parallel", "mesh_larger_than_the_world"])
def test_cli_data_parallel_keeps_jax_errors(argv):
    """--data_parallel runs (tests/test_torch_parallel_serving.py); the
    JAX CLI's errors around it stay: --group with --data_parallel (JAX's
    message), and a 2-rank mesh in a world of one process (JAX's mesh
    assertion), which leaves no process group behind."""
    import torch.distributed as dist

    if "--group" in argv:
        with pytest.raises(SystemExit) as e:
            cli.main(argv)
        assert str(e.value) == (
            "--group batches songs on one chip; combine with "
            "--data_parallel is not supported (pick one axis)")
        return
    with pytest.raises(AssertionError) as want:
        jmesh.make_mesh(n_data=2, devices=jax.devices()[:1])
    with pytest.raises(AssertionError) as got:
        cli.main(argv)
    assert str(got.value) == str(want.value)
    assert not dist.is_initialized()


def test_no_silent_cpu_fallback(pair, tmp_path, monkeypatch):
    """Without a card, the CLI and the library raise unless the CPU was
    asked for."""
    _, v, tmod = pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Separator(tmod)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Separator(tmod, device=None, precision="bfloat16")
    ckpt = str(tmp_path / "small.vrt.npz")
    convert.save_native(ckpt, v, convert.model_config(tmod))
    song = str(tmp_path / "song.wav")
    audio.write_wav(song, synth_song(seconds=1.0), 8000)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-P", ckpt, "-i", song, "-r", "8000", "-f", "256",
                  "-H", "128", "-o", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-P", ckpt, "-i", song, "-r", "8000", "-f", "256",
                  "-H", "128", "-o", str(tmp_path), "--flat_conv",
                  "--precision", "bfloat16"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-P", ckpt, "-i", song, "-r", "8000", "-f", "256",
                  "-H", "128", "-o", str(tmp_path), "--stream"])
    for flag in ("--postprocess", "--output_image"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["-P", ckpt, "-i", song, "-r", "8000", "-f", "256",
                      "-H", "128", "-o", str(tmp_path), flag])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-P", ckpt, "--input_dir", str(tmp_path), "-r", "8000",
                  "-f", "256", "-H", "128", "-o", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingSeparator(tmod)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SeparatorService(Separator(tmod))
    assert not os.path.exists(tmp_path / "song_Instruments.wav")
    assert not os.path.exists(tmp_path / "song_Instruments.jpg")
