"""Background staging of training batches.

Counterpart of vocal_remover_tpu/train/prefetch.py: a thread runs
`put_fn` (the host-to-device copy) on upcoming items while the current
step runs, so a steady-state epoch approaches max(transfer, compute)
rather than their sum.
"""

from __future__ import annotations

import queue
import threading


def device_prefetch(iterator, put_fn, depth: int = 2):
    """Yield put_fn(item) for each item, staged `depth` ahead on a
    background thread. Exceptions propagate to the consumer."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def worker():
        try:
            for item in iterator:
                if stop.is_set():
                    return
                q.put(put_fn(item))
        except BaseException as e:  # handed to the consumer, which raises it
            q.put(e)
            return
        q.put(None)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
