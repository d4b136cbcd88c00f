"""Host spans and the profiled slice of a traced run.

`Spans` records the benchmark's own host spans (name, start, end in
`time.time_ns`, from any thread), opened by the drivers' wrappers around
the calls into each layer. `profile_slice` runs one steady slice of a
cell under `torch.profiler` (CPU and CUDA activity of every thread) and
reduces the trace to what the per-layer metrics read:
  * device activity: every kernel, copy and set on the card; `busy_s`
    is the union of their intervals, `launches` the kernels;
  * device time (the union of their intervals) of the kernels launched
    inside the CPU ops named in `attribute` (a kernel is matched to the
    CPU event that launched it by correlation id, and that event to the
    op that encloses it on the same thread);
  * the device time of the kernels whose names hold a given part
    (`groups_s`);
  * the slice's kernels by name (`device_ops`), and its idle gaps
    summed by the benchmark span that was open when each began
    (`idle_gaps`).
"""

from __future__ import annotations

import bisect
import contextlib
import threading
import time
from collections import defaultdict

import torch

MARK = "benchmark.mark"
# profiler bookkeeping that the trace lists as device activity
NOT_DEVICE_WORK = ("Buffer Flush", "Activity Buffer Request")


class Spans:
    """Host spans of the benchmark's wrappers; thread-safe."""

    def __init__(self):
        self.items: list[tuple[str, int, int]] = []
        self._lock = threading.Lock()

    def add(self, name: str, t0: int, t1: int):
        with self._lock:
            self.items.append((name, t0, t1))

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.add(name, t0, time.time_ns())


def _profiler(activities):
    """A torch.profiler that records every thread's CPU ops where this
    torch can (the separation service runs the model on its own thread)."""
    from torch.profiler import profile

    try:
        from torch._C._profiler import _ExperimentalConfig

        cfg = _ExperimentalConfig(profile_all_threads=True)
        return profile(activities=activities, experimental_config=cfg)
    except (ImportError, TypeError):
        return profile(activities=activities)


def profile_slice(fn, spans: Spans | None = None,
                  attribute: tuple[str, ...] = (),
                  kernel_groups: dict | None = None) -> dict:
    """Run `fn()` under the profiler; -> the slice's reduction (see the
    module docstring), with `slice_s` the slice's wall time."""
    from torch.profiler import ProfilerActivity, record_function

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    prof = _profiler(acts)
    prof.start()
    try:
        t_mark = time.time_ns()
        with record_function(MARK):
            pass
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize()
        slice_s = time.perf_counter() - t0
    finally:
        prof.stop()
    t1 = time.perf_counter()
    out = reduce(prof.profiler.kineto_results.events(), t_mark, slice_s,
                 spans.items if spans else [], attribute, kernel_groups or {})
    out["reduce_s"] = time.perf_counter() - t1
    return out


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _length_s(intervals) -> float:
    return sum(e - s for s, e in _union(intervals)) / 1e9


def reduce(events, t_mark: int, slice_s: float, spans, attribute,
           kernel_groups: dict) -> dict:
    cuda = torch.autograd.DeviceType.CUDA
    device = []  # (name, start, end, linked correlation id)
    cpu = []     # (name, start, end, thread, correlation id)
    mark = None
    for e in events:
        name = e.name()
        if e.device_type() == cuda:
            if name not in NOT_DEVICE_WORK:
                device.append((name, e.start_ns(), e.end_ns(),
                               e.linked_correlation_id()))
        else:
            if name == MARK:
                mark = e.start_ns()
            cpu.append((name, e.start_ns(), e.end_ns(), e.start_thread_id(),
                        e.correlation_id()))
    start = mark if mark is not None else min(
        (d[1] for d in device), default=0)
    end = start + int(slice_s * 1e9)
    kernels = [d for d in device
               if not (d[0].startswith("Memcpy") or d[0].startswith("Memset"))]
    busy = _union((max(s, start), min(e, end)) for _, s, e, _ in device
                  if e > start and s < end)
    busy_s = sum(e - s for s, e in busy) / 1e9

    by_name = defaultdict(float)
    for name, s, e, _ in kernels:
        by_name[name] += (e - s) / 1e9
    groups = {g: _length_s((s, e) for name, s, e, _ in kernels if part in name)
              for g, part in kernel_groups.items()}

    # kernels launched inside the CPU ops named in `attribute`: a kernel's
    # linked correlation id is that of the CPU event that launched it; the
    # named ops do not nest on a thread, so only the last one to start
    # before the launch can enclose it
    attributed = {}
    if attribute:
        ops = defaultdict(list)  # thread -> [(start, end, name)]
        launch = {}  # correlation id -> (thread, time)
        for name, s, e, tid, corr in cpu:
            if name in attribute:
                ops[tid].append((s, e, name))
            if corr:
                launch[corr] = (tid, s)
        for v in ops.values():
            v.sort()
        starts = {tid: [o[0] for o in v] for tid, v in ops.items()}
        spans_of = defaultdict(list)
        for _, s, e, linked in kernels:
            tid, ts = launch.get(linked, (None, 0))
            if tid not in ops:
                continue
            i = bisect.bisect_right(starts[tid], ts) - 1
            if i >= 0 and ts <= ops[tid][i][1]:
                spans_of[ops[tid][i][2]].append((s, e))
        attributed = {name: _length_s(spans_of[name]) for name in attribute}

    # idle gaps, named by the benchmark span open when each began
    offset = (mark - t_mark) if mark is not None else 0
    named = sorted(((s + offset, e + offset, n) for n, s, e in spans),
                   key=lambda x: x[0])
    gaps = defaultdict(float)
    open_at = _OpenSpans(named)
    prev = start
    for s, e in busy + [[end, end]]:
        if s > prev:
            gaps[open_at(prev)] += (s - prev) / 1e9
        prev = max(prev, e)

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:10]]

    return {"slice_s": slice_s, "busy_s": busy_s, "launches": len(kernels),
            "kernel_s": sum(by_name.values()), "attributed_s": attributed,
            "groups_s": groups, "device_ops": top(by_name),
            "idle_gaps": top(gaps)}


class _OpenSpans:
    """Called with non-decreasing times: the name of the latest-started
    span open at each, else "no span"."""

    def __init__(self, spans):
        self.spans = spans  # sorted by start
        self.next = 0
        self.active = []

    def __call__(self, t: int) -> str:
        while self.next < len(self.spans) and self.spans[self.next][0] <= t:
            self.active.append(self.spans[self.next])
            self.next += 1
        while self.active and self.active[-1][1] < t:
            self.active.pop()
        for s, e, name in reversed(self.active):
            if e >= t:
                return name
        return "no span"
