"""Hand-off between the threads of a separation pipeline.

Shared by `SeparatorService` and `StreamingSeparator`: a producer thread
runs ahead of its consumer by a bounded queue, and a `stop` event set by
the consumer lets every producer give up instead of blocking forever on
a queue that nobody drains.
"""

from __future__ import annotations

import contextlib
import queue

import torch

from vocal_remover_tpu_torch.nn import config

_POLL_S = 0.2


def put(q: queue.Queue, item, stop) -> bool:
    """Put `item` on the bounded queue `q`; False (item dropped) once
    `stop` is set."""
    while not stop.is_set():
        try:
            q.put(item, timeout=_POLL_S)
            return True
        except queue.Full:
            continue
    return False


def get(q: queue.Queue, stop):
    """The next item of `q`, or None once `stop` is set."""
    while not stop.is_set():
        try:
            return q.get(timeout=_POLL_S)
        except queue.Empty:
            continue
    return None


@contextlib.contextmanager
def model_thread(precision: str, stream=None):
    """What a thread that runs the model holds for its whole life:
    inference mode (thread-local: a new thread starts with autograd on),
    the precision mode (nn/config.py; process-wide, restored on exit) and
    its CUDA stream, if any (the current stream is thread-local too)."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.inference_mode())
        stack.enter_context(config.precision(precision))
        if stream is not None:
            stack.enter_context(torch.cuda.stream(stream))
        yield
