"""Device-resident training data: crops and augmentation on the card.

Counterpart of vocal_remover_tpu/data/device_cache.py. The host data
path (dataset.py + loader.py) reads random crops from disk and ships
megabytes of spectrogram a step. A dataset that fits on the card (the
flagship's MUSDB-scale sets do) can instead live there whole: the songs'
normalized magnitudes are uploaded once, and a step uploads its crop
starts and augmentation flags only (`pack_indices`: 7 bytes an item),
from which `DeviceTrainingSource.gather` cuts and augments the batch on
the device.

  * Vocal reduction, channel swap and instrumental-as-mixture are exact
    in the magnitude domain (reference lib/dataset.py:49-57, 104-119).
    Mixup and the mono mix combine complex spectrograms before |.|
    (reference lib/dataset.py:88-102), so they, and complex-mask
    training, are refused: those runs take the host path.
  * The randomness is TrainingSet's: the same (seed, epoch, idx) streams
    in the same draw order, and `DeviceLoader` shares `Loader`'s
    shuffle. Resident magnitudes are made by the host fast path's
    expression, so at float32 a device batch equals the host path's
    batch bit for bit, and toggling the cache never changes a run.
  * In bf16 residency the gather casts to float32 before any arithmetic.
  * With a `mesh` (parallel/mesh.py) the resident arrays sit on every
    rank's card; every rank draws the same index batch, and `gather`
    cuts this rank's rows of it (the trainer's slice of the global
    batch).
"""

from __future__ import annotations

import numpy as np
import torch

from vocal_remover_tpu_torch import resolve_device
from vocal_remover_tpu_torch.data import cache
from vocal_remover_tpu_torch.data.loader import Loader
from vocal_remover_tpu_torch.parallel import mesh as mesh_lib

# bytes claimed by resident sources in this process; never decremented
# (sources live for a whole training run), as in the JAX package
_RESIDENT_BYTES = 0
# the share of the card's memory resident datasets may take: the rest is
# the model's, its optimizer's and the step's
HBM_FRACTION = 0.6


def _check_hbm_fit(nbytes: int, device: torch.device):
    """Fail before the upload when the resident datasets would take more
    than HBM_FRACTION of the card's memory, counting every source built
    in this process (the train and validation sources are checked
    jointly). The CPU has no limit, as JAX has none without a
    `bytes_limit`."""
    global _RESIDENT_BYTES
    total = _RESIDENT_BYTES + nbytes
    if device.type == "cuda":
        limit = torch.cuda.get_device_properties(device).total_memory
        if total > HBM_FRACTION * limit:
            raise ValueError(
                f"device-resident datasets need {total / 1e9:.2f} GB "
                f"({nbytes / 1e9:.2f} GB for this one) but the card has "
                f"{limit / 1e9:.2f} GB; drop --device_data_cache (the "
                "host data path streams from disk) or use the bf16 "
                "resident dtype")
    _RESIDENT_BYTES = total


def pack_indices(starts, reduct, swap, inst) -> np.ndarray:
    """An index batch as the one uint8 buffer a step uploads: the int32
    crop starts, then the three flag vectors a byte an item."""
    return np.concatenate([
        np.ascontiguousarray(starts, np.int32).view(np.uint8),
        np.stack([reduct, swap, inst]).astype(np.uint8).reshape(-1)])


def _gather_batch(X_all, y_all, rweight, starts, flags, cropsize):
    """(B, 2, F, cropsize) float32 (X, y) batches from the resident
    (2, F, total T) magnitudes (JAX `_gather_batch`): crops at the int32
    `starts`, then per item, where its flag (rows of `flags`: reduction,
    swap, instrumental-as-mixture) is set, vocal reduction (v = max(X -
    y, 0) where v > y, y = max(y - v * rweight, 0)), the stereo swap and
    X = y, in the host path's order."""
    cols = starts[:, None] + torch.arange(cropsize, device=starts.device)
    X, y = (a[:, :, cols].permute(2, 0, 1, 3).to(
        torch.float32, memory_format=torch.contiguous_format)
        for a in (X_all, y_all))
    reduct, swap, inst = (f.view(-1, 1, 1, 1) for f in flags)
    v = torch.clamp_min(X - y, 0.0)
    v = v * (v > y)
    y = torch.where(reduct, torch.clamp_min(y - v * rweight, 0.0), y)
    X = torch.where(swap, X.flip(1), X)
    y = torch.where(swap, y.flip(1), y)
    X = torch.where(inst, y, X)
    return X.contiguous(), y.contiguous()


def _refuse(is_complex, mixup_rate=0.0, mono_rate=0.0):
    if is_complex:
        raise ValueError(
            "device-resident data holds magnitudes; complex-mask "
            "training needs the host path (TrainingSet)")
    if mixup_rate != 0 or mono_rate != 0:
        raise ValueError(
            "mixup/mono augmentations combine complex spectrograms "
            "(reference lib/dataset.py:88-102) and cannot run on "
            "resident magnitudes — use the host path (TrainingSet)")


class DeviceTrainingSource:
    """All songs' normalized magnitudes resident on `device` (None: the
    card) in `dtype`: TrainingSet's sibling for the magnitude path, with
    the same item count and per-item randomness. Use with
    `Trainer.train_epoch_device` and a `DeviceLoader`; with a `mesh`,
    the trainer's."""

    def __init__(self, training_set, cropsize, reduction_rate=0.0,
                 reduction_weight=None, mixup_rate=0.0, mono_rate=0.0,
                 is_complex=False, seed=0, dtype=torch.bfloat16,
                 device=None, mesh=None, _mags=None):
        _refuse(is_complex, mixup_rate, mono_rate)
        if not training_set:
            # the host path iterates zero batches when int(n_songs *
            # val_rate) == 0 sweeps every song into validation (reference
            # dataset.py:177-180); a resident dataset makes it an error
            raise ValueError(
                "device-resident dataset: the training filelist is "
                "empty (check --val_rate / --split_mode)")
        self.device = resolve_device(device)
        self.mesh = mesh
        self.cropsize = int(cropsize)
        self.reduction_rate = float(reduction_rate)
        self.seed = seed
        self._epoch = 0
        self.training_set = training_set

        if _mags is not None:  # from_magnitudes
            songs_mags, item_song = _mags
        else:
            # each song once (the CLI passes training_set * patches);
            # each item slot maps to its song
            uniq: dict[str, int] = {}
            item_song, songs_mags = [], []
            for X_path, y_path, coef in training_set:
                if X_path not in uniq:
                    uniq[X_path] = len(songs_mags)
                    songs_mags.append((_magnitudes(X_path, coef),
                                       _magnitudes(y_path, coef)))
                item_song.append(uniq[X_path])
        self._item_song = np.asarray(item_song, np.int64)

        # each song zero-padded to >= cropsize (TrainingSet pads short
        # songs), then all concatenated along time
        mags_X, mags_y, offsets, lengths = [], [], [], []
        pos = 0
        for X, y in songs_mags:
            n_frames = X.shape[2]
            if n_frames < self.cropsize:
                pad = ((0, 0), (0, 0), (0, self.cropsize - n_frames))
                X, y = np.pad(X, pad), np.pad(y, pad)
            mags_X.append(X)
            mags_y.append(y)
            offsets.append(pos)
            lengths.append(n_frames)
            pos += X.shape[2]
        self._song_offset = np.asarray(offsets, np.int64)
        self._song_frames = np.asarray(lengths, np.int64)

        X_all = np.concatenate(mags_X, axis=2)
        y_all = np.concatenate(mags_y, axis=2)
        itemsize = torch.empty((), dtype=dtype).element_size()
        self.nbytes = X_all.size * itemsize * 2
        if reduction_weight is None:
            reduction_weight = np.zeros((X_all.shape[1], 1), np.float32)
        rw = np.asarray(reduction_weight, np.float32).reshape(-1, 1)

        _check_hbm_fit(self.nbytes, self.device)
        self.X_all = torch.from_numpy(X_all).to(self.device, dtype)
        self.y_all = torch.from_numpy(y_all).to(self.device, dtype)
        self.rweight = torch.from_numpy(rw).to(self.device)

    @classmethod
    def from_magnitudes(cls, songs_mags, cropsize, patches=1, **kw):
        """From in-memory [(X_mag, y_mag)] pairs of normalized (2, F, T)
        float32 arrays; `patches` repeats the items as the CLI's
        `training_set * patches` does."""
        n = len(songs_mags)
        item_song = [i % n for i in range(n * patches)]
        return cls(training_set=[None] * (n * patches), cropsize=cropsize,
                   _mags=(songs_mags, item_song), **kw)

    def __len__(self):
        return len(self.training_set)

    def set_epoch(self, epoch: int):
        self._epoch = int(epoch)

    def _item_rng(self, idx: int) -> np.random.Generator:
        # dataset.TrainingSet._item_rng's stream
        return np.random.default_rng((0x5EED, self.seed, self._epoch, idx))

    def index_batch(self, idxs):
        """The host's draws for a batch, in TrainingSet.__getitem__'s
        order and count (crop, reduction, swap, instrumental, mixup) ->
        (int32 absolute crop starts, reduction, swap, instrumental bool
        flags)."""
        B = len(idxs)
        starts = np.empty(B, np.int32)
        reduct, swap, inst = (np.empty(B, bool) for _ in range(3))
        for j, idx in enumerate(idxs):
            rng = self._item_rng(int(idx))
            song = self._item_song[int(idx) % len(self._item_song)]
            n_frames = self._song_frames[song]
            start = int(rng.integers(0, max(n_frames - self.cropsize, 1)))
            if n_frames <= self.cropsize:
                start = 0
            starts[j] = self._song_offset[song] + start
            reduct[j] = rng.uniform() < self.reduction_rate
            swap[j] = rng.uniform() < 0.5
            inst[j] = rng.uniform() < 0.01
            rng.uniform()  # the mixup draw (refused here; keeps streams)
        return starts, reduct, swap, inst

    def gather(self, starts, reduct, swap, inst):
        """An index batch -> its (X, y) float32 (B, 2, F, cropsize)
        batch on the device (with a mesh, this rank's rows of it). The
        indices go up as one `pack_indices` buffer (pinned, asynchronous
        on the card)."""
        if self.mesh is not None:
            starts, reduct, swap, inst = (mesh_lib.local_rows(self.mesh, a)
                                          for a in (starts, reduct, swap,
                                                    inst))
        B = len(starts)
        buf = torch.from_numpy(pack_indices(starts, reduct, swap, inst))
        if self.device.type == "cuda":
            buf = buf.pin_memory().to(self.device, non_blocking=True)
        return _gather_batch(
            self.X_all, self.y_all, self.rweight,
            buf[:4 * B].view(torch.int32).long(),
            buf[4 * B:].view(3, B).bool(), self.cropsize)


def _magnitudes(path: str, coef) -> np.ndarray:
    """A cached (T, 2, F) complex spectrogram -> (2, F, T) float32 |z| /
    coef, by the host fast path's expression (TrainingSet
    `_magnitude_fast_path`), so resident values equal its crops."""
    rows = cache.read_npy_rows(path, 0, cache.read_npy_shape(path)[0])
    return (np.abs(rows.transpose(1, 2, 0)) / coef).astype(np.float32)


class DeviceValidationSource:
    """The validation patches resident on `device` (None: the card) in
    `dtype`, uploaded once instead of every epoch; magnitudes only. With
    a `mesh`, on every rank's card (the trainer takes each rank's rows
    of a batch)."""

    def __init__(self, patch_list, is_complex=False, dtype=torch.bfloat16,
                 device=None, mesh=None):
        _refuse(is_complex)
        self.device = resolve_device(device)
        self.mesh = mesh
        Xs, ys = [], []
        for p in patch_list:
            with np.load(p) as data:
                Xs.append(np.abs(data["X"]).astype(np.float32))
                ys.append(np.abs(data["y"]).astype(np.float32))
        X = np.stack(Xs) if Xs else np.zeros((0, 2, 1, 1), np.float32)
        y = np.stack(ys) if ys else np.zeros((0, 2, 1, 1), np.float32)
        itemsize = torch.empty((), dtype=dtype).element_size()
        self.nbytes = X.size * itemsize * 2
        _check_hbm_fit(self.nbytes, self.device)
        self.X = torch.from_numpy(X).to(self.device, dtype)
        self.y = torch.from_numpy(y).to(self.device, dtype)

    def __len__(self):
        return int(self.X.shape[0])

    def batches(self, batchsize: int):
        """(X, y, n) device batches in order (validation does not
        shuffle, reference train.py:269)."""
        n = len(self)
        for i in range(0, n, batchsize):
            j = min(i + batchsize, n)
            yield self.X[i:j], self.y[i:j], j - i


class DeviceLoader(Loader):
    """Epoch iterator over a DeviceTrainingSource: yields its
    `index_batch`es in `Loader`'s order (the same shuffle, and
    `set_epoch` for resume)."""

    def __init__(self, source, batchsize, shuffle=True, seed=0):
        super().__init__(source, batchsize, shuffle=shuffle, seed=seed)

    def __iter__(self):
        epoch = self._epoch
        self.dataset.set_epoch(epoch)
        self._epoch += 1
        for idxs in self._batches(epoch):
            yield self.dataset.index_batch(idxs)
