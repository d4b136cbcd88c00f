"""Threaded, prefetching batch loader.

Counterpart of vocal_remover_tpu/data/loader.py, in place of the
reference's torch DataLoader worker processes (reference
train.py:245-270): a thread pool performs the host-side work (partial
.npy reads + numpy augmentation, which release the GIL in numpy),
batches are stacked into numpy arrays and prefetched ahead of the
consuming step (train/step.py stages them to the device). Batches are
identical for any `num_workers`.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

PREFETCH = 2  # batches stacked ahead of the consumer


class Loader:
    def __init__(self, dataset, batchsize, shuffle=False, num_workers=4,
                 seed=0):
        self.dataset = dataset
        self.batchsize = batchsize
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self._epoch = 0

    def set_epoch(self, epoch: int):
        """Position the loader at `epoch` (e.g. after --resume): both
        the shuffle order and the dataset's per-item draws are pure
        functions of (seed, epoch), so a resumed run continues the
        exact stream an uninterrupted run would have produced."""
        self._epoch = int(epoch)

    def __len__(self):
        return -(-len(self.dataset) // self.batchsize)

    def _batches(self, epoch: int):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            # per-epoch derived rng (not sequential generator state) so
            # set_epoch(e) reproduces epoch e's order exactly
            np.random.default_rng((0x0BD5, self.seed, epoch)).shuffle(order)
        for i in range(0, n, self.batchsize):
            yield order[i : i + self.batchsize]

    def __iter__(self):
        # advance the dataset's per-item RNG stream: epoch e draws are a
        # pure function of (seed, e, idx), so batches are identical for
        # any num_workers (see dataset.TrainingSet._item_rng)
        epoch = self._epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)
        self._epoch += 1

        q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for idxs in self._batches(epoch):
                        if stop.is_set():
                            return
                        items = list(pool.map(self.dataset.__getitem__, idxs))
                        cols = tuple(
                            np.stack([it[j] for it in items])
                            for j in range(len(items[0]))
                        )
                        q.put(cols)
            except BaseException as e:  # surface worker errors to consumer
                q.put(e)
                return
            q.put(None)

        t = threading.Thread(target=produce, daemon=True)
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
