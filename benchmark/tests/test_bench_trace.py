"""The reduction of a profiled slice, on a made-up trace."""

from __future__ import annotations

import pytest
import torch

from benchmark import trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Event:
    def __init__(self, name, device, start, end, tid=1, corr=0, linked=0):
        self._v = (name, device, start, end, tid, corr, linked)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def start_thread_id(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]

    def linked_correlation_id(self):
        return self._v[6]


def slice_events():
    return [
        Event(trace.MARK, CPU, 0, 1),
        Event("aten::convolution", CPU, 100, 500),
        Event("cudaLaunchKernel", CPU, 200, 210, corr=7),
        Event("conv_kernel_a", CUDA, 300, 700, linked=7),
        Event("cudaLaunchKernel", CPU, 600, 610, corr=8),
        Event("lstm_recurrence_kernel", CUDA, 800, 900, linked=8),
        Event("Memcpy DtoH (Device -> Pageable)", CUDA, 900, 950),
        # another thread's convolution launches nothing in the slice
        Event("aten::convolution", CPU, 100, 900, tid=2),
        Event("Buffer Flush", CUDA, 0, 1000),
    ]


def test_reduce():
    spans = [("song", 0, 1000), ("host", 650, 750)]
    out = trace.reduce(slice_events(), 0, 1000e-9, spans,
                       ("aten::convolution",), {"recurrence": "lstm_rec"})
    assert out["launches"] == 2  # kernels, not the copy or the profiler's
    assert out["busy_s"] == pytest.approx(550e-9)
    assert out["kernel_s"] == pytest.approx(500e-9)
    assert out["attributed_s"] == {"aten::convolution": pytest.approx(400e-9)}
    assert out["groups_s"] == {"recurrence": pytest.approx(100e-9)}
    assert dict(out["idle_gaps"]) == {"song": pytest.approx(350e-9),
                                      "host": pytest.approx(100e-9)}
    assert out["device_ops"][0] == ["conv_kernel_a", pytest.approx(400e-9)]


def test_spans_are_shifted_to_the_trace_clock():
    # the host clock reads 5000 where the trace's mark reads 0
    spans = [("song", 5000, 6000), ("host", 5650, 5750)]
    out = trace.reduce(slice_events(), 5000, 1000e-9, spans, (), {})
    assert dict(out["idle_gaps"])["host"] == pytest.approx(100e-9)


def test_profile_slice_runs_on_the_cpu():
    spans = trace.Spans()

    def work():
        with spans.span("work"):
            torch.ones(64, 64) @ torch.ones(64, 64)

    out = trace.profile_slice(work, spans)
    assert out["slice_s"] > 0 and out["launches"] == 0
