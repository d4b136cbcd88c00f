"""GPU port: its spans and counters (utils/trace.py) on the CPU, on a tiny
CascadedNet: one song through `separate_wave`, one `SeparatorService.map`
of two songs and one `train_epoch` step, recorded under torch.profiler
and run again with recording off; the separation CLI's `load model`
parts; what recording off costs (nothing recorded, one shared null
context)."""

import contextlib
import re
import sys
import threading

import numpy as np
import pytest
import torch

from vocal_remover_tpu_torch.cli import inference as cli
from vocal_remover_tpu_torch.models import convert
from vocal_remover_tpu_torch.models.cascaded import CascadedNet
from vocal_remover_tpu_torch.ops.stft import num_frames
from vocal_remover_tpu_torch.ops.windowing import make_padding, num_patches
from vocal_remover_tpu_torch.separate.separator import Separator
from vocal_remover_tpu_torch.separate.service import SeparatorService
from vocal_remover_tpu_torch.train.step import Trainer
from vocal_remover_tpu_torch.utils import audio, trace

torch.set_num_threads(1)

SR = 8000
TINY = (64, 32, 4, 8)  # n_fft, hop, nout, nout_lstm
CROP, BATCH = 256, 2
LENGTHS = (8000, 9000, 5000)  # the song, then the service's two songs

SEPARATOR = ["separate", "separate.upload", "separate.stft",
             "separate.patches", "separate.model_chunk", "separate.stitch",
             "separate.istft", "separate.download"]
SERVICE = ["service.upload", "service.wait_upload", "service.dispatch",
           "service.wait_room", "service.wait_song", "service.residual"]
TRAIN = ["train.step", "train.forward", "train.backward", "train.optimizer",
         "train.wait_batch", "train.stage", "lstm.recurrence_plain",
         "lstm.recurrence_backward"]


def model():
    return CascadedNet(*TINY, generator=torch.Generator().manual_seed(5))


def songs():
    rng = np.random.default_rng(6)
    return [rng.uniform(-0.5, 0.5, (2, n)).astype(np.float32)
            for n in LENGTHS]


def batch():
    rng = np.random.default_rng(7)
    X = np.abs(rng.standard_normal((2, 2, TINY[0] // 2 + 1, 160)))
    return X.astype(np.float32), (X * rng.uniform(0, 1, X.shape)).astype(
        np.float32)


def workloads():
    """(stems of the song, stems of the service's songs, the step's loss,
    the parameters after it)."""
    sep = Separator(model(), batchsize=BATCH, cropsize=CROP, device="cpu")
    song, *pair = songs()
    one = sep.separate_wave(song, pcm16_io=True)
    svc = SeparatorService(sep, vocals_residual=True, group=2)
    two = list(svc.map(pair))
    trainer = Trainer(model(), learning_rate=1e-3, seed=3, device="cpu")
    loss = trainer.train_epoch([batch()])
    params = [p.detach().clone() for p in trainer.model.parameters()]
    return one, two, loss, params


@pytest.fixture(scope="module")
def runs():
    """The workloads recorded under the profiler, then with recording
    off: {"rec", "events", "on", "off"}."""
    with trace.profiler(cuda=False) as prof, trace.recording() as rec:
        on = workloads()
    events = [(e.name(), e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()]
    return {"rec": rec, "events": events, "on": on, "off": workloads()}


def by_name(rec, name):
    return [s for s in rec.spans if s.name == name]


def test_span_is_one_shared_null_context_while_off():
    assert trace._active is None
    a, b = trace.span("separate"), trace.span("train.step")
    assert a is b and isinstance(a, contextlib.nullcontext)
    assert trace.count("separate.patches_run") is None
    trace.backward_span("lstm.recurrence_backward", torch.ones(1),
                        torch.ones(1))  # nothing registered, no error


def test_nothing_is_recorded_outside_recording(runs):
    rec = runs["rec"]
    # the workloads ran twice, the second time after the recording closed
    assert len(by_name(rec, "train.step")) == 1
    n, counters = len(rec.spans), dict(rec.counters)
    with trace.span("separate"):
        trace.count("separate.patches_run")
    assert len(rec.spans) == n and rec.counters == counters


def test_every_name_is_recorded_and_closed(runs):
    rec = runs["rec"]
    assert {s.name for s in rec.spans} == set(SEPARATOR + SERVICE + TRAIN)
    assert all(s.end is not None and s.end >= s.start for s in rec.spans)


def test_parents_and_threads(runs):
    rec = runs["rec"]
    spans = rec.spans
    main = threading.get_native_id()
    # the song: rooted at `separate` on this thread
    (root,) = [s for s in by_name(rec, "separate") if s.parent is None]
    assert root.thread == main
    for s in spans:
        if s.name.startswith("separate."):
            assert spans[s.parent].name == "separate"
            assert s.thread == spans[s.parent].thread
    # the service: uploader, dispatcher and caller, each its own thread
    threads = {name: {s.thread for s in by_name(rec, name)}
               for name in SERVICE}
    assert threads["service.residual"] == threads["service.wait_song"] == {
        main}
    (dispatcher,) = threads["service.dispatch"]
    assert threads["service.wait_upload"] == threads[
        "service.wait_room"] == {dispatcher}
    (uploader,) = threads["service.upload"]
    assert len({main, dispatcher, uploader}) == 3
    for name in SERVICE:
        for s in by_name(rec, name):
            assert s.parent is None
    assert len(by_name(rec, "service.upload")) == len(
        by_name(rec, "service.residual")) == 2
    for s in by_name(rec, "separate"):
        if s.parent is not None:
            assert spans[s.parent].name == "service.dispatch"
    # the step
    (step,) = by_name(rec, "train.step")
    for name in ("train.forward", "train.backward", "train.optimizer"):
        (s,) = by_name(rec, name)
        assert spans[s.parent] is step
    for s in by_name(rec, "lstm.recurrence_plain"):
        assert spans[spans[s.parent].parent] is step  # inside the forward


def test_recurrence_backward_lies_inside_train_backward(runs):
    rec = runs["rec"]
    (back,) = by_name(rec, "train.backward")
    inner = by_name(rec, "lstm.recurrence_backward")
    assert len(inner) == len(by_name(rec, "lstm.recurrence_plain")) == 5
    for s in inner:  # the five band nets' BiLSTMs
        assert back.start <= s.start <= s.end <= back.end
        assert rec.spans[s.parent] is back


def test_patch_counters_follow_make_padding(runs):
    model_ = model()
    run = topup = 0
    for n in LENGTHS:  # each song runs alone: their lengths differ
        frames = num_frames(n, model_.n_fft, model_.hop_length)
        left, right, roi = make_padding(frames, CROP, model_.offset)
        p = num_patches(left + frames + right, roi, model_.offset)
        run += -(-p // BATCH) * BATCH
        topup += -(-p // BATCH) * BATCH - p
    c = runs["rec"].counters
    assert (c["separate.patches_run"], c["separate.patches_topup"]) == (
        run, topup)
    assert len(by_name(runs["rec"], "separate.model_chunk")) == run // BATCH


def test_spans_are_profiler_ranges_on_their_clock(runs):
    events = {}
    for name, start, end in runs["events"]:
        events.setdefault(name, []).append((start, end))
    for s in runs["rec"].spans:
        assert any(abs(a - s.start) <= 1e6 and abs(b - s.end) <= 1e6
                   for a, b in events.get(s.name, ())), s


def test_outputs_are_bit_identical_with_recording_on_and_off(runs):
    (one_on, two_on, loss_on, p_on) = runs["on"]
    (one_off, two_off, loss_off, p_off) = runs["off"]
    for a, b in zip(one_on + sum(two_on, ()), one_off + sum(two_off, ())):
        np.testing.assert_array_equal(a, b)
    assert loss_on == loss_off
    assert all(torch.equal(a, b) for a, b in zip(p_on, p_off))


def test_counters_add_up_across_threads():
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with trace.recording() as rec:
            threads = [threading.Thread(
                target=lambda: [trace.count("c", 2) for _ in range(500)])
                for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert rec.counters == {"c": 16 * 500 * 2}


@pytest.fixture
def cli_args(tmp_path):
    m = model()
    ckpt = str(tmp_path / "tiny.vrt.npz")
    convert.save_native(ckpt, convert.to_jax_variables(m),
                        convert.model_config(m))
    song = str(tmp_path / "song.wav")
    audio.write_wav(song, songs()[0], SR)
    return ["-P", ckpt, "-i", song, "-r", str(SR), "-o",
            str(tmp_path / "out"), "--gpu", "-1", "--precision", "bfloat16"]


def test_cli_load_model_line_prints_its_parts(cli_args, capsys):
    cli.main(cli_args)
    (line,) = [ln for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("  load model: ")]
    parts = line.split("(", 1)[1]
    assert [p.split()[0] for p in parts.rstrip(")").split(", ")] == [
        "load.read", "load.serving_transform", "load.to_device"]
    assert trace._active is None


def test_cli_separates_with_recording_off(cli_args, capsys, monkeypatch):
    seen = []
    run = Separator._run

    def watched(self, *args, **kwargs):
        seen.append(trace._active)
        return run(self, *args, **kwargs)

    monkeypatch.setattr(Separator, "_run", watched)
    cli.main(cli_args)
    assert seen and all(rec is None for rec in seen)
    stages = [ln for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("  ") and ": " in ln]
    assert any(ln.startswith("  separate") for ln in stages)
    for ln in stages:  # only `load model` prints parts after its time
        assert ln.startswith("  load model: ") or re.search(
            r": \d+\.\d\ds$", ln), ln
