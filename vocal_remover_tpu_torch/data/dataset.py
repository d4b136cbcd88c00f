"""Training/validation datasets with on-the-fly augmentation.

Counterpart of vocal_remover_tpu/data/dataset.py (reference
lib/dataset.py:15-141): random time crops via partial .npy reads,
per-song normalization, the augmentation set (vocal-reduction, channel
swap, instrumental-as-mixture, mixup) with the same
probabilities/distributions, reorganized as plain-Python
samplers (no torch DataLoader): a `Loader` (loader.py) drives them with
worker threads and feeds the training step (train/step.py). Items are
magnitudes, or for complex-mask training (`is_complex`) the real and
imaginary parts stacked as channels (or the complex crops, with
`complex_as_channels=False`).

Randomness is derived per item: every `__getitem__(idx)` builds its own
`np.random.Generator` seeded from (seed, epoch, idx). This makes the
augmentation stream (a) thread-safe — Loader workers never share
generator state — and (b) reproducible: the same seed yields identical
epoch batches for ANY worker count. Call `set_epoch(e)` (the Loader
does) to advance the crop/augmentation draws between epochs.
"""

from __future__ import annotations

import numpy as np

from vocal_remover_tpu_torch import native
from vocal_remover_tpu_torch.data import cache
from vocal_remover_tpu_torch.ops.windowing import make_padding

__all__ = ["TrainingSet", "ValidationSet", "make_validation_set"]


def _item(X, y, is_complex, complex_as_channels=True):
    """Complex (2, F, T) crops -> float32 magnitudes, or with
    `is_complex` (4, F, T) float32 [real; imaginary] channel stacks (the
    complex crops as they are without `complex_as_channels`)."""
    if is_complex:
        if not complex_as_channels:
            return X, y
        return (np.concatenate([X.real, X.imag]).astype(np.float32),
                np.concatenate([y.real, y.imag]).astype(np.float32))
    return np.abs(X).astype(np.float32), np.abs(y).astype(np.float32)


class TrainingSet:
    """Map-style dataset over `training_set * patches` entries.

    Items are (X_mag, y_mag) float32 arrays of shape (2, F, cropsize)
    (reference lib/dataset.py:104-119); with `is_complex`, (4, F,
    cropsize) float32 re/im channel stacks (real parts first), or with
    `complex_as_channels=False` the (2, F, cropsize) complex crops.
    """

    def __init__(self, training_set, cropsize, reduction_rate,
                 reduction_weight, mixup_rate, mixup_alpha, seed=0,
                 is_complex=False, mono_rate=0.0,
                 complex_as_channels=True):
        self.training_set = training_set
        self.cropsize = cropsize
        self.reduction_rate = reduction_rate
        self.reduction_weight = reduction_weight
        self.mixup_rate = mixup_rate
        self.mixup_alpha = mixup_alpha
        self.is_complex = is_complex
        self.complex_as_channels = complex_as_channels
        # mono-mix augmentation: dormant in the reference (commented out
        # at lib/dataset.py:81-83); carried here as a real option
        self.mono_rate = mono_rate
        self.seed = seed
        self._epoch = 0

    def __len__(self):
        return len(self.training_set)

    def set_epoch(self, epoch: int):
        """Advance the per-item RNG stream (new crops/augs each epoch)."""
        self._epoch = int(epoch)

    def _item_rng(self, idx: int) -> np.random.Generator:
        return np.random.default_rng((0x5EED, self.seed, self._epoch, idx))

    def _crop_window(self, n_frames: int, rng) -> tuple[int, int]:
        """(start, n_rows) for a random crop; songs shorter than
        cropsize are taken whole (padded to cropsize after the read).
        Always draws exactly once so the rng stream is layout-stable."""
        span = max(n_frames - self.cropsize, 1)
        start = int(rng.integers(0, span))
        if n_frames <= self.cropsize:
            return 0, n_frames
        return start, self.cropsize

    def do_crop(self, X_path, y_path, rng):
        n_frames = cache.read_npy_shape(X_path)[0]
        start, n_rows = self._crop_window(n_frames, rng)
        X = cache.read_npy_rows(X_path, start, n_rows)
        y = cache.read_npy_rows(y_path, start, n_rows)
        if n_rows < self.cropsize:
            pad = ((0, self.cropsize - n_rows), (0, 0), (0, 0))
            X = np.pad(X, pad)
            y = np.pad(y, pad)
        # (T, 2, F) rows -> (2, F, T)
        return X.transpose(1, 2, 0), y.transpose(1, 2, 0)

    def aggressively_remove_vocal(self, X, y):
        """Estimate vocal magnitude v = max(|X|-|y|, 0) gated by v > |y|
        and subtract `v * reduction_weight` from |y|, keeping y's phase
        (reference lib/dataset.py:49-57)."""
        X_mag = np.abs(X)
        y_mag = np.abs(y)
        v_mag = X_mag - y_mag
        v_mag *= v_mag > y_mag
        y_mag = np.clip(y_mag - v_mag * self.reduction_weight, 0, np.inf)
        return y_mag * np.exp(1.0j * np.angle(y))

    def do_aug(self, X, y, rng):
        if rng.uniform() < self.reduction_rate:
            y = self.aggressively_remove_vocal(X, y)

        if rng.uniform() < 0.5:  # stereo channel swap
            X = X[::-1].copy()
            y = y[::-1].copy()

        if rng.uniform() < 0.01:  # instrumental as mixture
            X = y.copy()

        if self.mono_rate > 0 and rng.uniform() < self.mono_rate:
            X = np.broadcast_to(X.mean(axis=0, keepdims=True), X.shape).copy()
            y = np.broadcast_to(y.mean(axis=0, keepdims=True), y.shape).copy()

        return X, y

    def do_mixup(self, X, y, rng):
        idx = int(rng.integers(0, len(self)))
        X_path, y_path, coef = self.training_set[idx]
        X_i, y_i = self.do_crop(X_path, y_path, rng)
        X_i = X_i / coef
        y_i = y_i / coef
        X_i, y_i = self.do_aug(X_i, y_i, rng)

        lam = rng.beta(self.mixup_alpha, self.mixup_alpha)
        X = lam * X + (1 - lam) * X_i
        y = lam * y + (1 - lam) * y_i
        return X, y

    def _magnitude_fast_path(self, idx, rng):
        """Magnitude items with no complex-valued augs pending: |z| / coef
        of the crop as float32 in the read, by the native kernel (native
        `load_crop_abs`, the JAX package's fused C read, whose bits differ
        from numpy's |z| / coef by a few ulp in a third to a half of the
        values), with the SAME rng draw order as the general path."""
        X_path, y_path, coef = self.training_set[idx % len(self.training_set)]
        n_frames = cache.read_npy_shape(X_path)[0]
        start, n_rows = self._crop_window(n_frames, rng)

        X = native.load_crop_abs(X_path, start, n_rows, coef)
        y = native.load_crop_abs(y_path, start, n_rows, coef)
        if n_rows < self.cropsize:
            pad = ((0, 0), (0, 0), (0, self.cropsize - n_rows))
            X = np.pad(X, pad)
            y = np.pad(y, pad)

        rng.uniform()  # reduction draw (reduction_rate == 0 here)
        if rng.uniform() < 0.5:  # stereo channel swap
            X = np.ascontiguousarray(X[::-1])
            y = np.ascontiguousarray(y[::-1])
        if rng.uniform() < 0.01:  # instrumental as mixture
            X = y.copy()
        rng.uniform()  # mixup draw (mixup_rate == 0 here)
        return X, y

    def __getitem__(self, idx):
        rng = self._item_rng(idx)
        if (
            not self.is_complex
            and self.reduction_rate == 0
            and self.mixup_rate == 0
            and self.mono_rate == 0
        ):
            return self._magnitude_fast_path(idx, rng)

        X_path, y_path, coef = self.training_set[idx % len(self.training_set)]
        X, y = self.do_crop(X_path, y_path, rng)
        X = X / coef
        y = y / coef
        X, y = self.do_aug(X, y, rng)
        if rng.uniform() < self.mixup_rate:
            X, y = self.do_mixup(X, y, rng)
        return _item(X, y, self.is_complex, self.complex_as_channels)


class ValidationSet:
    """Fixed validation windows persisted as .npz patches
    (reference lib/dataset.py:123-141)."""

    def __init__(self, patch_list, is_complex=False,
                 complex_as_channels=True):
        self.patch_list = patch_list
        self.is_complex = is_complex
        self.complex_as_channels = complex_as_channels

    def __len__(self):
        return len(self.patch_list)

    def __getitem__(self, idx):
        data = np.load(self.patch_list[idx])
        return _item(data["X"], data["y"], self.is_complex,
                     self.complex_as_channels)


def make_validation_set(filelist, cropsize, sr, hop_length, n_fft, offset,
                        patch_root=".", progress=lambda it: it):
    """Persist per-song fixed windows to
    `cs{}_sr{}_hl{}_nf{}_of{}/` .npz files (reference
    lib/dataset.py:220-248); returns the patch path list. `progress`
    wraps the file list (a progress bar, tqdm-style)."""
    import os

    patch_list = []
    patch_dir = os.path.join(
        patch_root,
        "cs{}_sr{}_hl{}_nf{}_of{}".format(cropsize, sr, hop_length, n_fft,
                                          offset),
    )
    os.makedirs(patch_dir, exist_ok=True)

    for X_path, y_path in progress(filelist):
        basename = os.path.splitext(os.path.basename(X_path))[0]
        X, y, _, _ = cache.cache_or_load(X_path, y_path, sr, hop_length, n_fft)
        coef = np.max([np.abs(X).max(), np.abs(y).max()])
        X, y = X / coef, y / coef

        left, right, roi_size = make_padding(X.shape[2], cropsize, offset)
        X_pad = np.pad(X, ((0, 0), (0, 0), (left, right)))
        y_pad = np.pad(y, ((0, 0), (0, 0), (left, right)))

        len_dataset = int(np.ceil(X.shape[2] / roi_size))
        for j in range(len_dataset):
            outpath = os.path.join(patch_dir, f"{basename}_p{j}.npz")
            start = j * roi_size
            if not os.path.exists(outpath):
                np.savez(
                    outpath,
                    X=X_pad[:, :, start : start + cropsize],
                    y=y_pad[:, :, start : start + cropsize],
                )
            patch_list.append(outpath)

    return patch_list


def get_oracle_data(X, y, oracle_loss, oracle_rate, oracle_drop_rate, rng):
    """Hard-example mining: top-k by loss, random n of those (reference
    lib/dataset.py:251-259; defined-but-unused there — exposed here as a
    real API for curriculum experiments)."""
    k = int(len(X) * oracle_rate * (1 / (1 - oracle_drop_rate)))
    n = int(len(X) * oracle_rate)
    indices = np.argsort(oracle_loss)[::-1][:k]
    indices = rng.choice(indices, n, replace=False)
    return X[indices].copy(), y[indices].copy(), indices
