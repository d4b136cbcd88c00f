"""Spans and counters inside the port, on the device trace's clock.

    from vocal_remover_tpu_torch.utils import trace

    with trace.span("separate.stft"):
        re, im = stft(waves, n_fft, hop)
    trace.count("separate.patches_run", 24)

    with trace.recording() as rec:
        separator.separate_wave(song)
    rec.spans, rec.counters

Off by default, and nearly free while off: outside `recording()`,
`span` returns one shared `contextlib.nullcontext` and `count` returns
at once; no hook is registered and nothing is allocated per call.

While recording, each span keeps its name, start and end (`time.time_ns`,
the clock of torch.profiler's events), the native id of its thread and
its parent (the index in `spans` of the span enclosing it on the same
thread, or None). Each span is also a `torch.profiler.record_function`
range: under a profiler it lands in the same event list as the kernels
it launches, on their clock and under the thread that launched them.

The names the port records (PERF.md section 3):
  * Separator: `separate`, `separate.upload`,
    `separate.stft`, `separate.patches`, `separate.model_chunk`,
    `separate.stitch`, `separate.istft`, `separate.download`; counters
    `separate.patches_run` and `separate.patches_topup` (the zero
    patches that top up a last chunk);
  * service: `service.upload` (uploader thread), `service.wait_upload`,
    `service.dispatch`, `service.wait_room` (dispatcher thread),
    `service.wait_song`, `service.residual` (caller);
  * Trainer: `train.step`, `train.forward`, `train.backward`,
    `train.optimizer`, `train.wait_batch`, `train.stage` (staging
    thread);
  * the training BiLSTM: `lstm.recurrence_plain` (the forward loop),
    `lstm.recurrence_backward` (its backward, on the thread that runs
    it);
  * the separation CLI: `load.read`, `load.serving_transform`,
    `load.to_device`.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass

import torch

_NULL = contextlib.nullcontext()
_active = None  # the innermost recording()'s Recorder, else None


@dataclass
class Span:
    name: str
    start: int  # time.time_ns()
    end: int | None  # None while open
    thread: int  # threading.get_native_id()
    parent: int | None  # index in Recorder.spans


class Recorder:
    """What one `recording()` holds: `spans` (list of Span, in the order
    they opened) and `counters` (name -> total)."""

    def __init__(self):
        self.spans: list[Span] = []
        self.counters: dict[str, int] = {}
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def count(self, name: str, n: int):
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def totals(self) -> dict:
        """Seconds of the closed spans by name, in the order first seen."""
        out: dict[str, float] = {}
        for s in self.spans:
            if s.end is not None:
                out[s.name] = out.get(s.name, 0.0) + (s.end - s.start) / 1e9
        return out


class _Open:
    """One span of a Recorder, entered and exited once."""

    __slots__ = ("rec", "name", "index", "range")

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        stack = rec._stack()
        span = Span(self.name, time.time_ns(), None,
                    threading.get_native_id(), stack[-1] if stack else None)
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        with rec._lock:
            self.index = len(rec.spans)
            rec.spans.append(span)
        stack.append(self.index)

    def __exit__(self, *exc):
        rec = self.rec
        rec.spans[self.index].end = time.time_ns()
        self.range.__exit__(None, None, None)
        stack = rec._stack()
        if stack and stack[-1] == self.index:
            stack.pop()
        elif self.index in stack:
            stack.remove(self.index)
        return False


def span(name: str):
    """A context manager: the span `name` while recording, else the
    shared null context."""
    rec = _active
    if rec is None:
        return _NULL
    return _Open(rec, name)


def count(name: str, n: int = 1):
    """Add `n` to the counter `name` while recording."""
    rec = _active
    if rec is None:
        return
    rec.count(name, n)


def backward_span(name: str, out, inp):
    """While recording, a span `name` on the thread that runs the
    backward, from the moment the gradient reaches tensor `out` until it
    reaches tensor `inp` (tensor hooks, registered only while recording
    and only where autograd will run them)."""
    rec = _active
    if rec is None or not (torch.is_grad_enabled() and out.requires_grad
                           and inp.requires_grad):
        return
    opened = []

    def begin(grad):
        s = _Open(rec, name)
        s.__enter__()
        opened.append(s)

    def end(grad):
        if opened:
            opened.pop().__exit__(None, None, None)

    out.register_hook(begin)
    inp.register_hook(end)


@contextlib.contextmanager
def recording():
    """Record every span and counter of the process (every thread) into
    a new Recorder, yielded; the one active before is restored after."""
    global _active
    rec = Recorder()
    prev, _active = _active, rec
    try:
        yield rec
    finally:
        _active = prev


def profiler(cuda: bool):
    """A torch.profiler.profile of the CPU ops of every thread where this
    torch can (the service and the trainer run work on threads of their
    own) and, with `cuda`, the card's activity."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    try:
        from torch._C._profiler import _ExperimentalConfig

        cfg = _ExperimentalConfig(profile_all_threads=True)
        return profile(activities=acts, experimental_config=cfg)
    except (ImportError, TypeError):
        return profile(activities=acts)
