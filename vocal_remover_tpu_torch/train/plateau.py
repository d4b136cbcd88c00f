"""ReduceLROnPlateau (a copy of vocal_remover_tpu/train/plateau.py):
host-side LR controller with torch semantics
(reference train.py:220-227: factor, patience, threshold=1e-6
(relative), min_lr; cooldown 0, mode 'min')."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ReduceLROnPlateau:
    lr: float
    factor: float = 0.9
    patience: int = 6
    threshold: float = 1e-6
    min_lr: float = 0.0001
    best: float = float("inf")
    num_bad_epochs: int = 0

    def step(self, metric: float) -> float:
        """Record an epoch metric; returns the (possibly reduced) lr."""
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1

        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.num_bad_epochs = 0
        return self.lr

    def state_dict(self):
        return dataclasses.asdict(self)

    def load_state_dict(self, d):
        for k, v in d.items():
            setattr(self, k, v)
