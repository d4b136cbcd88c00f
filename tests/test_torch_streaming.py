"""GPU port: segment streaming (`StreamingSeparator`, two-phase
postprocess) and `merge_artifacts` against the JAX package on the CPU
(the recurrence under its Pallas kernel in interpret mode), the CLI's
`--stream` and its switch to streaming for long songs, and streaming
against the monolithic path on the card.

Songs are 16 kHz here, as in tests/test_streaming.py: with
segment_patches=4 and batch 2 a segment is 512 frames, so 3.0 s is one
partial segment and 7.3 s two, the second ending on the song's edge."""

import contextlib
import threading

import numpy as np
import pytest
import torch

from vocal_remover_tpu.cli import inference as jcli
from vocal_remover_tpu.nn import config as jconfig
from vocal_remover_tpu.separate.streaming import (
    StreamingSeparator as JStreaming,
)
from vocal_remover_tpu.utils import spec as jspec
from vocal_remover_tpu_torch.cli import inference as cli
from vocal_remover_tpu_torch.models import convert
from vocal_remover_tpu_torch.models.cascaded import CascadedNet
from vocal_remover_tpu_torch.nn import config
from vocal_remover_tpu_torch.separate.separator import Separator
from vocal_remover_tpu_torch.separate.streaming import StreamingSeparator
from vocal_remover_tpu_torch.utils import audio, spec

from torch_port_helpers import max_lsb, small_pair, synth_song

torch.set_num_threads(1)

SR = 16000


@pytest.fixture(scope="module")
def pair():
    return small_pair()


@contextlib.contextmanager
def pallas_lstm():
    jconfig.set_lstm_impl("pallas")
    try:
        yield
    finally:
        jconfig.set_lstm_impl("scan")


def _both(pair, wave, **kw):
    """(JAX stems, port stems) of StreamingSeparator(segment_patches=4,
    batchsize=2, **kw) on the CPU."""
    jmod, v, tmod = pair
    with pallas_lstm():
        ref = JStreaming(jmod, v, segment_patches=4, batchsize=2,
                         **kw).separate_wave(wave)
    got = StreamingSeparator(tmod, segment_patches=4, batchsize=2,
                             device="cpu", **kw).separate_wave(wave)
    return ref, got


@pytest.mark.parametrize("tta", [False, True])
@pytest.mark.parametrize("seconds", [3.0, 7.3])
def test_streaming_matches_jax(pair, seconds, tta):
    """Float stems within 3e-4 of JAX's (its own monolithic tolerance)."""
    wave = synth_song(SR, seconds)
    ref, got = _both(pair, wave, tta=tta)
    for a, b in zip(got, ref):
        assert a.dtype == np.float32 and a.shape == wave.shape
        np.testing.assert_allclose(a, b, atol=3e-4)


@pytest.mark.parametrize("seconds", [3.0, 7.3])
def test_streaming_matches_the_monolithic_path(pair, seconds):
    wave = synth_song(SR, seconds)
    mono = Separator(pair[2], batchsize=2, cropsize=256, device="cpu")
    stream = StreamingSeparator(pair[2], segment_patches=4, batchsize=2,
                                device="cpu")
    for a, b in zip(stream.separate_wave(wave), mono.separate_wave(wave)):
        np.testing.assert_allclose(a, b, atol=3e-4)


@pytest.mark.parametrize("tta", [False, True])
def test_streaming_pcm16_residual_matches_jax(pair, tta):
    """PCM16 in and out, vocals as clip(mixture - instruments): within 1
    LSB of JAX, the residual exact, the uncovered tail as JAX leaves
    it."""
    wave = synth_song(SR, 7.3)
    ref, (y, v) = _both(pair, wave, tta=tta, pcm16_io=True,
                        vocals_residual=True)
    assert y.dtype == v.dtype == np.int16
    assert max_lsb(y, ref[0]) <= 1 and max_lsb(v, ref[1]) <= 1
    mix = audio.pcm16_encode(wave).astype(np.int32)
    np.testing.assert_array_equal(v, np.clip(mix - y, -32768, 32767))
    natural = 128 * (wave.shape[-1] // 128)
    assert not y[:, natural:].any()


@pytest.mark.parametrize("tta", [False, True])
def test_streaming_postprocess_matches_jax(pair, tta):
    """The two streamed phases (masks, merge_artifacts on the host,
    apply) within 1 LSB of JAX's."""
    wave = synth_song(SR, 7.3)
    ref, got = _both(pair, wave, tta=tta, postprocess=True, pcm16_io=True,
                     vocals_residual=True)
    for a, b in zip(got, ref):
        assert max_lsb(a, b) <= 1


@pytest.mark.parametrize("postprocess", [False, True])
def test_streaming_restores_the_precision_mode_before_it_returns(
        pair, postprocess):
    """Each streamed phase's producer holds the precision mode
    (process-wide) for its life; once `separate_wave` returns, the
    caller's mode is back, also after the two phases of postprocess."""
    mode = (config.get_precision(), config.get_compute_dtype(),
            config._get_tf32())
    before = set(threading.enumerate())
    StreamingSeparator(pair[2], segment_patches=4, batchsize=2,
                       device="cpu", precision="default",
                       postprocess=postprocess).separate_wave(
        synth_song(SR, 3.0))
    assert (config.get_precision(), config.get_compute_dtype(),
            config._get_tf32()) == mode
    assert not set(threading.enumerate()) - before


@pytest.mark.parametrize("kind", ["complex", "hop"])
def test_streaming_refuses_what_it_cannot_stream(kind):
    model = CascadedNet(256, 128, 8, 16, is_complex=True) if kind == \
        "complex" else CascadedNet(256, 64, 8, 16)
    with pytest.raises(ValueError, match="complex" if kind == "complex"
                       else "50%-overlap"):
        StreamingSeparator(model, device="cpu")


def _mask_with_runs(rng, runs, t=400):
    """(2, 16, t) mask in [0, 0.05) with the given (start, end) frame runs
    above the threshold."""
    m = rng.uniform(0.0, 0.05, (2, 16, t)).astype(np.float32)
    for s, e in runs:
        m[:, :, s:e] = rng.uniform(0.06, 1.0, (2, 16, e - s))
    return m


@pytest.mark.parametrize("runs", [
    (),  # nothing above the threshold
    ((10, 50), (100, 140)),  # runs too short to fade
    ((20, 150), (250, 360)),  # two long runs
    ((0, 120), (300, 400)),  # long runs on both edges
    ((40, 140), (150, 260)),  # long runs closer than the fade
], ids=["none", "short", "long", "edges", "close"])
def test_merge_artifacts_matches_jax(runs):
    mask = _mask_with_runs(np.random.default_rng(5), runs)
    want = jspec.merge_artifacts(mask.copy())
    ours = mask.copy()
    out = spec.merge_artifacts(ours)
    assert out is ours  # mutated in place, as JAX's
    np.testing.assert_array_equal(out, want)
    assert (not runs or runs[0][1] - runs[0][0] < 64) == \
        np.array_equal(out, mask)


@pytest.fixture(scope="module")
def ckpts(pair, tmp_path_factory):
    """Checkpoints of the magnitude pair and of a complex-mask model."""
    d = tmp_path_factory.mktemp("ckpt")
    mag = str(d / "small.vrt.npz")
    convert.save_native(mag, pair[1], convert.model_config(pair[2]))
    cx_model = CascadedNet(256, 128, 8, 16, is_complex=True)
    cx = str(d / "complex.vrt.npz")
    convert.save_native(cx, convert.to_jax_variables(cx_model),
                        convert.model_config(cx_model))
    return {"magnitude": mag, "complex": cx}


def _cli_stems(run, ckpt, song, out, *flags):
    run(["-P", ckpt, "-i", song, "-r", str(SR), "-f", "256", "-H", "128",
         "-B", "2", "-o", str(out), *flags])
    return [np.round(audio.read_wav(str(out / f"song_{stem}.wav"))[0]
                     * 32768).astype(np.int32)
            for stem in ("Instruments", "Vocals")]


@pytest.mark.parametrize("flags", [[], ["--postprocess"]])
def test_cli_stream_matches_jax(ckpts, tmp_path, flags):
    song = str(tmp_path / "song.wav")
    audio.write_wav(song, synth_song(SR, 3.0), SR)
    ref = _cli_stems(jcli.main, ckpts["magnitude"], song, tmp_path / "jax",
                     "--stream", *flags)
    got = _cli_stems(cli.main, ckpts["magnitude"], song, tmp_path / "port",
                     "--stream", "--gpu", "-1", *flags)
    for a, b in zip(got, ref):
        assert a.shape == b.shape and max_lsb(a, b) <= 1


@pytest.mark.parametrize("kind", ["magnitude", "complex"])
def test_cli_streams_long_songs(ckpts, tmp_path, monkeypatch, capsys, kind):
    """Above STREAM_ABOVE_SECONDS a song streams as with --stream; a
    complex checkpoint never does (and so refuses --postprocess)."""
    song = str(tmp_path / "song.wav")
    audio.write_wav(song, synth_song(SR, 2.0), SR)
    monkeypatch.setattr(cli, "STREAM_ABOVE_SECONDS", 1)
    auto = _cli_stems(cli.main, ckpts[kind], song, tmp_path / "auto",
                      "--gpu", "-1")
    said = capsys.readouterr().out
    if kind == "complex":
        assert "separate (device pipeline)" in said
        with pytest.raises(SystemExit, match="A5"):
            cli.main(["-P", ckpts[kind], "-i", song, "-r", str(SR), "-f",
                      "256", "-H", "128", "-o", str(tmp_path / "pp"),
                      "--gpu", "-1", "--stream", "--postprocess"])
        return
    assert "separate (streamed segments)" in said
    forced = _cli_stems(cli.main, ckpts[kind], song, tmp_path / "forced",
                        "--gpu", "-1", "--stream")
    for a, b in zip(auto, forced):
        np.testing.assert_array_equal(a, b)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("tta", [False, True])
def test_streaming_matches_separate_wave_on_card(pair, cuda_device, tta):
    """On the card: float stems within 3e-4 of the monolithic path, PCM16
    with residual vocals within 1 LSB (the vocals up to the iSTFT's
    natural length: past it the residual is the mixture, the monolithic
    vocals are zeros)."""
    wave = synth_song(SR, 7.3)
    mono = Separator(pair[2], batchsize=2, cropsize=256, device=cuda_device)
    stream = StreamingSeparator(pair[2], segment_patches=4, batchsize=2,
                                tta=tta, device=cuda_device)
    for a, b in zip(stream.separate_wave(wave),
                    mono.separate_wave(wave, tta=tta)):
        np.testing.assert_allclose(a, b, atol=3e-4)
    stream16 = StreamingSeparator(pair[2], segment_patches=4, batchsize=2,
                                  tta=tta, pcm16_io=True,
                                  vocals_residual=True, device=cuda_device)
    (y, v), (ry, rv) = (stream16.separate_wave(wave),
                        mono.separate_wave(wave, tta=tta, pcm16_io=True))
    natural = 128 * (wave.shape[-1] // 128)
    assert max_lsb(y, ry) <= 1
    assert max_lsb(v[:, :natural], rv[:, :natural]) <= 1
