"""The program's spans and counters in a profiled slice
(benchmark/program_trace.py), on made-up traces and on the CPU."""

from __future__ import annotations

import time

import pytest
import torch

import test_bench_trace
from benchmark import program_trace, trace
from test_bench_trace import CPU, CUDA
from vocal_remover_tpu_torch.utils import trace as program


class Event(test_bench_trace.Event):
    def is_user_annotation(self):
        return False


def two_threads():
    """Thread 1 (the caller) waits for a song the whole slice; thread 2
    (the dispatcher) runs a chunk, then waits for an upload. Kernel A and
    B are launched by thread 2, the copy by thread 1."""
    return [
        Event(trace.MARK, CPU, 0, 1),
        Event("service.wait_song", CPU, 0, 1000, tid=1),
        Event("separate.model_chunk", CPU, 100, 400, tid=2),
        Event("aten::conv", CPU, 120, 390, tid=2),  # not a program span
        Event("service.wait_upload", CPU, 400, 900, tid=2),
        Event("cudaLaunchKernel", CPU, 150, 160, tid=2, corr=7),
        Event("kernel_a", CUDA, 200, 300, linked=7),
        Event("cudaLaunchKernel", CPU, 500, 510, tid=2, corr=8),
        Event("kernel_b", CUDA, 600, 700, linked=8),
        Event("cudaMemcpyAsync", CPU, 800, 810, tid=1, corr=9),
        Event("Memcpy DtoH (Device -> Pinned)", CUDA, 850, 900, linked=9),
        Event("Buffer Flush", CUDA, 0, 1000),
    ]


NAMES = {"service.wait_song", "separate.model_chunk", "service.wait_upload"}


def test_a_gap_goes_to_the_thread_whose_launch_ends_it():
    idle, unattributed = program_trace.charge_idle(two_threads(), NAMES,
                                                   1000e-9)
    # [300, 600) ends with thread 2's kernel B: its chunk was open at 300;
    # [700, 850) ends with thread 1's copy: thread 1 waited for a song,
    # though thread 2's wait for an upload started later and was open
    assert idle == {"separate.model_chunk": pytest.approx(300e-9),
                    "service.wait_song": pytest.approx(150e-9)}
    # [0, 200): thread 2 had no span open at 0; [900, 1000) ends nothing
    assert unattributed == pytest.approx(300e-9)


class Annotation(test_bench_trace.Event):
    """The card-side copy kineto makes of a CPU range."""

    def is_user_annotation(self):
        return True


def test_card_side_annotations_are_no_device_work():
    events = two_threads() + [Annotation("separate.model_chunk", CUDA, 100,
                                         400)]
    kept = program_trace.device_work(events)
    assert len(kept) == len(events) - 1 and events[-1] not in kept
    idle, _ = program_trace.charge_idle(kept, NAMES, 1000e-9)
    assert idle["separate.model_chunk"] == pytest.approx(300e-9)


def test_charged_and_unattributed_idle_add_up_to_the_slice_idle():
    events = two_threads()
    idle, unattributed = program_trace.charge_idle(events, NAMES, 1000e-9)
    busy = trace.reduce(events, 0, 1000e-9, [], (), {})["busy_s"]
    assert sum(idle.values()) + unattributed == pytest.approx(1000e-9 - busy)


def test_the_innermost_span_is_charged():
    events = [Event(trace.MARK, CPU, 0, 1),
              Event("train.step", CPU, 0, 1000),
              Event("train.forward", CPU, 10, 600),
              Event("lstm.recurrence_plain", CPU, 100, 300),
              Event("cudaLaunchKernel", CPU, 400, 410, corr=3),
              Event("k", CUDA, 500, 1000, linked=3)]
    names = {"train.step", "train.forward", "lstm.recurrence_plain"}
    for t_end, want in ((250, "lstm.recurrence_plain"),
                        (350, "train.forward")):
        evs = [Event("k0", CUDA, 0, t_end, linked=0)] + events
        idle, _ = program_trace.charge_idle(evs, names, 1000e-9)
        assert set(idle) == {want}


def test_a_profiled_slice_of_the_program_on_the_cpu():
    def work():
        with program.span("separate"), program.span("separate.model_chunk"):
            program.count("separate.patches_run", 4)
            program.count("separate.patches_topup", 1)
            torch.ones(64, 64) @ torch.ones(64, 64)

    with program.profiler(cuda=False) as prof:
        with torch.profiler.record_function(trace.MARK):
            pass
        t0 = time.perf_counter()
        with program.recording() as rec:
            work()
        slice_s = time.perf_counter() - t0
    events = program_trace.device_work(prof.profiler.kineto_results.events())
    out = dict(program_trace.reduce(events, rec, slice_s), slice_s=slice_s)
    assert out["program_counters"] == {"separate.patches_run": 4,
                                       "separate.patches_topup": 1}
    assert set(out["program_span_s"]) == {"separate", "separate.model_chunk"}
    assert out["program_union_s"]["separate"] == pytest.approx(
        out["program_span_s"]["separate"])
    assert out["program_idle_s"] == {}  # no card: the slice is all idle
    assert out["program_unattributed_idle_s"] == pytest.approx(slice_s)
    values = program_trace.per_layer(out)
    assert values["chunk_fill_pct"] == pytest.approx(75.0)
    assert values["dispatch_idle_pct"] == 0.0
    assert values["recurrence_share_pct"] is None
    assert values["dispatcher_wait_pct"] is None
