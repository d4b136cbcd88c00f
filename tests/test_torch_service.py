"""GPU port: cross-song patch batching (`Separator.separate_waves`), the
pipelined `SeparatorService` and the CLI's directory mode against the
JAX package on the CPU (the recurrence under its Pallas kernel in
interpret mode), and the same on the card against `separate_wave`."""

import contextlib
import os
import threading
import types

import numpy as np
import pytest
import torch

import vocal_remover_tpu
from vocal_remover_tpu.cli import inference as jcli
from vocal_remover_tpu.models import convert as jconvert
from vocal_remover_tpu.nn import config as jconfig
from vocal_remover_tpu.separate.separator import Separator as JSeparator
from vocal_remover_tpu.separate.service import SeparatorService as JService
from vocal_remover_tpu_torch.cli import inference as cli
from vocal_remover_tpu_torch.models import convert
from vocal_remover_tpu_torch.nn import config
from vocal_remover_tpu_torch.separate.separator import Separator
from vocal_remover_tpu_torch.separate.service import SeparatorService
from vocal_remover_tpu_torch.utils import audio

from torch_port_helpers import max_lsb, small_pair, synth_song

torch.set_num_threads(1)

SR = 8000


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


def song(seconds, k=0):
    """Song k of a given length: the test signal rolled and scaled."""
    return (np.roll(synth_song(SR, seconds), 97 * k, axis=-1)
            * (0.5 + 0.2 * k)).astype(np.float32)


@pytest.fixture(scope="module")
def stack():
    """Three 2 s songs: one patch each at crop 256, so the merged stream
    of batch 2 runs songs 0 and 1 in one chunk and tops up the last."""
    return np.stack([song(2.0, k) for k in range(3)])


@pytest.mark.parametrize("tta", [False, True])
def test_separate_waves_matches_jax(pair, stack, tta):
    jmod, v, tmod = pair
    with pallas_lstm():
        ref = JSeparator(jmod, v, batchsize=2, cropsize=256).separate_waves(
            stack, tta=tta, pcm16_io=True)
    got = Separator(tmod, batchsize=2, cropsize=256, device="cpu") \
        .separate_waves(stack, tta=tta, pcm16_io=True)
    for a, b in zip(got, ref):
        assert a.dtype == np.int16 and a.shape == stack.shape
        assert max_lsb(a, b) <= 1


@pytest.mark.parametrize("tta", [False, True])
def test_separate_waves_matches_separate_wave(pair, stack, tta):
    """Grouped songs give the stems of the same songs alone."""
    sp = Separator(pair[2], batchsize=2, cropsize=256, device="cpu")
    ys, vs = sp.separate_waves(stack, tta=tta, pcm16_io=True)
    for k in range(len(stack)):
        y, vo = sp.separate_wave(stack[k], tta=tta, pcm16_io=True)
        assert max_lsb(y, ys[k]) <= 1 and max_lsb(vo, vs[k]) <= 1


@pytest.mark.parametrize("stacked", [False, True])
def test_only_instruments_matches_jax(pair, stack, stacked):
    """`only_instruments` returns the instruments of the two-stem run
    (the JAX pipeline built with only_instruments) and no vocals."""
    jmod, v, tmod = pair
    jsep = JSeparator(jmod, v, batchsize=2, cropsize=256)
    sp = Separator(tmod, batchsize=2, cropsize=256, device="cpu")
    n = stack.shape[-1]
    x16 = np.round(np.clip(stack, -1, 1 - 1 / 32768) * 32768).astype(np.int16)
    with pallas_lstm():
        if stacked:
            (ref,) = jsep._multiwave_fn(3, n, False, True, True)(x16, v)
        else:
            (ref,) = jsep._wave_fn(n, False, True, True)(x16[0], v)
    if stacked:
        y, vo = sp.separate_waves(stack, pcm16_io=True, only_instruments=True)
    else:
        y, vo = sp.separate_wave(stack[0], pcm16_io=True,
                                 only_instruments=True)
    assert vo is None and y.dtype == np.int16
    assert max_lsb(y, np.asarray(ref)) <= 1
    both = sp.separate_waves(stack, pcm16_io=True)[0]
    np.testing.assert_array_equal(y, both if stacked else both[0])


# (song lengths in s, group, max_pending, vocals_residual)
SERVICE_CASES = {
    "group 1": ((1.0, 2.0, 1.0), 1, None, False),
    "group 2 interleaved": ((1.0, 2.0, 1.0, 2.0, 1.0), 2, None, True),
    "max_pending flush": ((1.0, 1.5, 2.0, 1.5, 1.0, 1.0), 2, 2, True),
    "vocals_residual": ((1.0, 1.0, 1.0), 1, None, True),
}


@pytest.mark.parametrize("case", list(SERVICE_CASES))
def test_service_map_matches_jax(pair, case):
    """Same stems as the JAX service, in input order, through grouping,
    interleaved lengths and a max_pending flush."""
    lengths, group, max_pending, resid = SERVICE_CASES[case]
    jmod, v, tmod = pair
    songs = [song(s, k) for k, s in enumerate(lengths)]
    kw = dict(pcm16_io=True, vocals_residual=resid, group=group,
              max_pending=max_pending)
    with pallas_lstm():
        ref = list(JService(JSeparator(jmod, v, batchsize=2, cropsize=256),
                            **kw).map(iter(songs)))
    got = list(SeparatorService(
        Separator(tmod, batchsize=2, cropsize=256, device="cpu"), **kw)
        .map(iter(songs)))
    assert len(got) == len(songs)
    for w, (y, vo), (ry, rv) in zip(songs, got, ref):
        assert y.shape == vo.shape == w.shape
        assert y.dtype == vo.dtype == np.int16
        assert max_lsb(y, ry) <= 1 and max_lsb(vo, rv) <= 1
        if resid:  # vocals = clip(mixture - instruments), exactly
            mix = audio.pcm16_encode(w).astype(np.int32)
            np.testing.assert_array_equal(
                vo, np.clip(mix - y, -32768, 32767))


def test_service_batches_follow_the_grouping_policy():
    """Dispatch order: a group as soon as it fills, the oldest song's
    buffer past max_pending, leftovers per song at the end."""
    svc = SeparatorService(None, group=2, max_pending=2)
    waves = [np.zeros((2, n), np.int16) for n in (10, 20, 30, 20, 10, 10)]
    assert [idxs for idxs, _ in svc._batches(waves)] == \
        [(0,), (1, 3), (4, 5), (2,)]


@pytest.mark.parametrize("stage", ["input", "model"])
def test_service_raises_stage_errors_in_the_caller(pair, stage):
    """An exception in the input iterator (uploader) or in the model
    (dispatcher; a song shorter than the STFT's reflect padding) reaches
    the caller."""
    def songs():
        yield song(1.0)
        if stage == "input":
            raise RuntimeError("the input failed")
        yield song(1.0)[:, :10]

    svc = SeparatorService(Separator(pair[2], batchsize=2, device="cpu"))
    with pytest.raises(RuntimeError,
                       match="the input failed" if stage == "input"
                       else "[Pp]adding"):
        list(svc.map(songs()))


def test_service_stops_its_threads_when_the_caller_stops(pair):
    def stages():
        return [t for t in threading.enumerate()
                if t.name.endswith(("(uploader)", "(dispatcher)"))]

    before = set(stages())
    svc = SeparatorService(Separator(pair[2], batchsize=2, device="cpu"),
                           depth=1)
    outputs = svc.map(song(1.0, k) for k in range(8))
    next(outputs)
    assert set(stages()) - before
    outputs.close()
    assert not set(stages()) - before  # joined by the time close returns


@pytest.mark.parametrize("closed", [True, False],
                         ids=["closed early", "run to the end"])
def test_service_restores_the_precision_mode_before_it_returns(pair,
                                                               closed):
    """The dispatcher holds the service's precision mode (process-wide)
    for its life; once `map` returns, the caller's mode is back and a
    following separation runs in it."""
    sp = Separator(pair[2], batchsize=2, device="cpu")
    ref = sp.separate_wave(song(1.0), pcm16_io=True)
    mode = (config.get_precision(), config.get_compute_dtype(),
            config._get_tf32())
    svc = SeparatorService(Separator(pair[2], batchsize=2, device="cpu",
                                     precision="default"), depth=1)
    outputs = svc.map(song(1.0, k) for k in range(6))
    if closed:
        next(outputs)
        outputs.close()
    else:
        assert len(list(outputs)) == 6
    assert (config.get_precision(), config.get_compute_dtype(),
            config._get_tf32()) == mode
    for a, b in zip(sp.separate_wave(song(1.0), pcm16_io=True), ref):
        np.testing.assert_array_equal(a, b)
    assert config.get_precision() == mode[0]


@pytest.fixture(scope="module")
def ckpt(pair, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "small.vrt.npz")
    convert.save_native(path, pair[1], convert.model_config(pair[2]))
    return path


def test_cli_input_dir_matches_jax(ckpt, tmp_path):
    """Three WAVs and a text file: the port's directory mode writes the
    JAX CLI's stems within 1 LSB (30 s buckets, a group of 2 and one song
    alone, vocals by residual), and nothing for the text file."""
    d = tmp_path / "songs"
    d.mkdir()
    names = ("b_song", "a_song", "c_song")
    for k, (name, s) in enumerate(zip(names, (2.0, 1.0, 1.5))):
        audio.write_wav(str(d / f"{name}.wav"), song(s, k), SR)
    (d / "notes.txt").write_text("not audio")
    argv = ["--input_dir", str(d), "-P", ckpt, "-r", str(SR), "-f", "256",
            "-H", "128", "-c", "256", "-B", "2", "--group", "2",
            "--precision", "highest"]
    jcli.main(argv + ["-o", str(tmp_path / "jax")])
    cli.main(argv + ["-o", str(tmp_path / "port"), "--gpu", "-1"])
    for name in names:
        want = audio.read_wav(str(d / f"{name}.wav"))[0]
        for stem in ("Instruments", "Vocals"):
            a, sr = audio.read_wav(str(tmp_path / "port"
                                       / f"{name}_{stem}.wav"))
            b, _ = audio.read_wav(str(tmp_path / "jax" / f"{name}_{stem}.wav"))
            assert sr == SR and a.shape == b.shape == want.shape
            assert max_lsb(np.round(a * 32768), np.round(b * 32768)) <= 1
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        f"{n}_{s}.wav" for n in names for s in ("Instruments", "Vocals"))


def test_cli_input_dir_refuses_undecodable_files(ckpt, tmp_path):
    """A file the port cannot decode yet stops the run before any
    separation, naming the slice that brings its decoder."""
    d = tmp_path / "songs"
    d.mkdir()
    audio.write_wav(str(d / "a.wav"), song(1.0), SR)
    (d / "b.MP3").write_bytes(b"\xff\xfb" + bytes(64))
    out = tmp_path / "out"
    with pytest.raises(SystemExit, match="A5"):
        cli.main(["--input_dir", str(d), "-P", ckpt, "-r", str(SR), "-f",
                  "256", "-H", "128", "-o", str(out), "--gpu", "-1"])
    assert not out.exists()


@pytest.mark.parametrize("flag", ["--postprocess", "--output_image"])
def test_cli_input_dir_refuses_spectrogram_flags(flag):
    with pytest.raises(SystemExit, match="single-file mode"):
        cli.main(["--input_dir", "songs", flag])


def _jax_resolved(argv, monkeypatch):
    """The JAX CLI's arguments after its own per-mode resolution: its
    main runs until the checkpoint load, with no global setting left
    changed."""
    args = jcli.build_parser().parse_args(argv)
    monkeypatch.setattr(jcli, "build_parser", lambda: types.SimpleNamespace(
        parse_args=lambda argv=None: args))

    class Resolved(Exception):
        pass

    def stop(*a, **k):
        raise Resolved

    monkeypatch.setattr(vocal_remover_tpu, "enable_compile_cache",
                        lambda *a, **k: None)
    monkeypatch.setattr(jconfig, "set_precision", lambda *a, **k: None)
    monkeypatch.setattr(jconfig, "set_lstm_impl", lambda *a, **k: None)
    monkeypatch.setattr(jconvert, "load_model", stop)
    with pytest.raises(Resolved):
        jcli.main(argv)
    return args


@pytest.mark.parametrize("argv", [
    ["-i", "x.wav"],
    ["-i", "x.wav", "-c", "512", "--group", "2"],
    ["--input_dir", "d"],
    ["--input_dir", "d", "--data_parallel", "2"],
    ["--input_dir", "d", "-c", "512", "-B", "8", "--group", "3",
     "--precision", "default"],
])
def test_cli_defaults_resolve_as_jax(argv, monkeypatch):
    want = _jax_resolved(argv, monkeypatch)
    got = cli.build_parser().parse_args(argv)
    cli.resolve_defaults(got)
    for key in ("cropsize", "batchsize", "group", "precision"):
        assert getattr(got, key) == getattr(want, key), key


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("group", [1, 2])
def test_service_matches_separate_wave_on_card(pair, cuda_device, group):
    """On the card, through the upload / compute streams and pinned
    buffers: the service's stems equal `separate_wave`'s within 1 LSB,
    in input order."""
    sp = Separator(pair[2], batchsize=2, cropsize=256, device=cuda_device)
    songs = [song(s, k) for k, s in enumerate((1.0, 2.0, 1.0, 2.0, 1.5))]
    got = list(SeparatorService(sp, group=group).map(iter(songs)))
    for w, (y, vo) in zip(songs, got):
        ry, rv = sp.separate_wave(w, pcm16_io=True)
        assert max_lsb(y, ry) <= 1 and max_lsb(vo, rv) <= 1
