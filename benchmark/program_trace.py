"""The program's own spans and counters (vocal_remover_tpu_torch/utils/
trace.py) in a profiled slice, and the per-layer values they give.

Meant for benchmark/trace.py's `profile_slice`, which would open the
program's `recording()` around `fn()`, drop with `device_work` the
card-side copies that kineto makes of CPU ranges (`gpu_user_annotation`:
each program span would otherwise count as work on the card, and cover
its idle gaps), and add to the profile what `reduce` gives:
  * `program_counters`: the program's counters over the slice;
  * `program_span_s`: seconds of the program's spans by name (their
    durations summed), from its own records;
  * `program_union_s`: by layer (the part of a span's name before the
    first dot: `separate`, `service`, `train`, `lstm`, `load`), the union
    of its spans' intervals, from its own records;
  * `program_idle_s`: the slice's idle seconds (no kernel, copy or set
    on the card, as `device_idle_pct` counts them) by program span. A
    gap is charged to the innermost program span open at the gap's start
    on the thread that launched the activity that ends the gap (a launch
    is matched to its thread by correlation id); the spans are the
    program's `record_function` ranges in the same trace;
  * `program_unattributed_idle_s`: the rest of the idle time: gaps whose
    ending launch had no program span open on its thread, and the gap
    that ends the slice.

`per_layer(profile)` gives the values of the metrics that read them
(None where the slice has nothing to read).
"""

from __future__ import annotations

import bisect
from collections import defaultdict

import torch

from benchmark import trace


def device_work(events) -> list:
    """`events` without the card-side ranges of CPU annotations, which
    are no work on the card (torch.profiler's own tables leave them out
    of device time too)."""
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in events
            if not (e.device_type() == cuda and e.is_user_annotation())]


def _union_s(intervals) -> float:
    total, last = 0, None
    for s, e in sorted(intervals):
        if last is None or s > last:
            total += e - s
            last = e
        elif e > last:
            total += e - last
            last = e
    return total / 1e9


def reduce(events, rec, slice_s: float) -> dict:
    """The program's keys (module docstring) of a slice whose kineto
    `events` hold the program's spans recorded in `rec` (a
    trace.Recorder)."""
    names = {s.name for s in rec.spans}
    span_s = defaultdict(float)
    layers = defaultdict(list)
    for s in rec.spans:
        if s.end is not None:
            span_s[s.name] += (s.end - s.start) / 1e9
            layers[s.name.split(".")[0]].append((s.start, s.end))
    idle, unattributed = charge_idle(events, names, slice_s)
    return {"program_counters": dict(rec.counters),
            "program_span_s": dict(span_s),
            "program_union_s": {k: _union_s(v) for k, v in layers.items()},
            "program_idle_s": idle,
            "program_unattributed_idle_s": unattributed}


class _Innermost:
    """The program spans of each thread (kineto events, properly nested
    on a thread): the name of the innermost one open at a time."""

    def __init__(self, ranges):
        self.by_thread = {}
        for tid, items in ranges.items():
            items.sort(key=lambda r: (r[0], -r[1]))
            parent, stack = [], []
            for i, (s, e, _) in enumerate(items):
                while stack and items[stack[-1]][1] < s:
                    stack.pop()
                parent.append(stack[-1] if stack else -1)
                stack.append(i)
            self.by_thread[tid] = ([r[0] for r in items], items, parent)

    def __call__(self, tid, t: int):
        found = self.by_thread.get(tid)
        if found is None:
            return None
        starts, items, parent = found
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and items[i][1] < t:
            i = parent[i]
        return items[i][2] if i >= 0 else None


def charge_idle(events, names, slice_s: float):
    """({program span name: idle seconds}, unattributed idle seconds) of
    the slice that starts at `trace.MARK` (else at the first device
    activity) and lasts `slice_s`, by the rule of the module docstring;
    `events` hold no card-side annotations (`device_work`)."""
    cuda = torch.autograd.DeviceType.CUDA
    device = []  # (start, end, linked correlation id)
    launch = {}  # correlation id -> thread
    ranges = defaultdict(list)  # thread -> [(start, end, name)]
    mark = None
    for e in events:
        name = e.name()
        if e.device_type() == cuda:
            if name not in trace.NOT_DEVICE_WORK:
                device.append((e.start_ns(), e.end_ns(),
                               e.linked_correlation_id()))
            continue
        tid = e.start_thread_id()
        if name == trace.MARK:
            mark = e.start_ns()
        elif name in names:
            ranges[tid].append((e.start_ns(), e.end_ns(), name))
        corr = e.correlation_id()
        if corr:
            launch[corr] = tid
    start = mark if mark is not None else min((d[0] for d in device),
                                              default=0)
    end = start + int(slice_s * 1e9)
    innermost = _Innermost(ranges)
    idle = defaultdict(float)
    unattributed = 0.0
    prev = start
    for s, e, linked in sorted(d for d in device if d[1] > start
                               and d[0] < end):
        if s > prev:
            name = innermost(launch.get(linked), prev)
            if name is None:
                unattributed += (s - prev) / 1e9
            else:
                idle[name] += (s - prev) / 1e9
        prev = max(prev, min(e, end))
    if end > prev:
        unattributed += (end - prev) / 1e9
    return dict(idle), unattributed


def per_layer(p: dict) -> dict:
    """The per-layer values the program's records give in profile `p`
    (percentages of the slice; the chunk fill of the patches run), each
    None where the slice recorded nothing for it."""
    slice_s = p["slice_s"]
    idle, span_s = p["program_idle_s"], p["program_span_s"]
    counters = p["program_counters"]
    recurrence = ("lstm.recurrence_plain", "lstm.recurrence_backward")
    waits = ("service.wait_upload", "service.wait_room")
    run = counters.get("separate.patches_run", 0)

    def pct(v):
        return 100.0 * v / slice_s

    return {
        "recurrence_share_pct": (pct(p["program_union_s"]["lstm"])
                                 if "lstm" in p["program_union_s"] else None),
        "recurrence_idle_pct": (pct(sum(idle.get(k, 0.0) for k in recurrence))
                                if "lstm" in p["program_union_s"] else None),
        "dispatch_idle_pct": (pct(idle.get("separate.model_chunk", 0.0))
                              if "separate.model_chunk" in span_s else None),
        "dispatcher_wait_pct": (pct(sum(span_s.get(k, 0.0) for k in waits))
                                if "service.wait_upload" in span_s else None),
        "chunk_fill_pct": (100.0 * (run - counters["separate.patches_topup"])
                           / run if run else None),
    }
