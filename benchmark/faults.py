"""Faults planted under a training run's timed path, for the readings
that set the limits of `correct` (calibrate.py `--fault`) and for the
tests that see `correct` come out false (tests/test_bench_faults.py).
Each is a context manager that patches the port's `Trainer` class while
it is open."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def half_batch():
    """Half of each batch left out of the loss, the mean taken over the
    rest."""
    from vocal_remover_tpu_torch.train.step import Trainer

    real = Trainer._loss

    def loss(self, X, y, generator):
        return real(self, X[:len(X) // 2], y[:len(y) // 2], generator)

    Trainer._loss = loss
    try:
        yield
    finally:
        Trainer._loss = real


@contextlib.contextmanager
def stale_batch():
    """A batch staged while another is still in flight (staged, and its
    step not yet ended) is replaced by the one staged before it, which
    is then trained twice: a staging buffer handed out again. Yields a
    list that counts the batches replaced."""
    from vocal_remover_tpu_torch.train.step import Trainer

    real_stage, real_apply = Trainer._stage, Trainer._apply
    count = {"staged": 0, "applied": 0, "last": None}
    replaced = []

    def stage(self, batch, whole_ok=False):
        out = real_stage(self, batch, whole_ok)
        if count["last"] is not None and \
                count["staged"] - count["applied"] >= 1:
            replaced.append(count["staged"])
            out = count["last"]
        count["last"] = out
        count["staged"] += 1
        return out

    def apply(self):
        real_apply(self)
        count["applied"] += 1

    Trainer._stage, Trainer._apply = stage, apply
    try:
        yield replaced
    finally:
        Trainer._stage, Trainer._apply = real_stage, real_apply
