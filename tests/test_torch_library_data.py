"""GPU port, the library keywords of the data and training path against
the JAX package's, with the same inputs: `Loader(epoch_multiplier=,
drop_last=, prefetch=)` and `num_samples`, `DeviceLoader(drop_last=)`,
`TrainingSet` / `ValidationSet(complex_as_channels=False)`,
`make_training_set` / `make_validation_set(progress=)`,
`Trainer(prefetch=)` and `save_train_state(extra=)`. Small sizes: 8 kHz
songs, n_fft 256, JAX's tiny CascadedNet."""

import json
import os
import queue
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vocal_remover_tpu.data import cache as jcache
from vocal_remover_tpu.data import dataset as jdataset
from vocal_remover_tpu.data import loader as jloader
from vocal_remover_tpu.data.device_cache import (
    DeviceLoader as JDeviceLoader,
    DeviceTrainingSource as JDeviceTrainingSource,
)
from vocal_remover_tpu.models.cascaded import CascadedNet as JCascadedNet
from vocal_remover_tpu.train import checkpoint as jcheckpoint
from vocal_remover_tpu.train.plateau import ReduceLROnPlateau as JPlateau
from vocal_remover_tpu.train.step import Trainer as JTrainer
from vocal_remover_tpu.utils import audio as jaudio
from vocal_remover_tpu_torch.data import cache, dataset, device_cache, loader
from vocal_remover_tpu_torch.data.device_cache import (
    DeviceLoader,
    DeviceTrainingSource,
)
from vocal_remover_tpu_torch.models import convert
from vocal_remover_tpu_torch.models.cascaded import CascadedNet
from vocal_remover_tpu_torch.train import checkpoint
from vocal_remover_tpu_torch.train import step as tstep
from vocal_remover_tpu_torch.train.plateau import ReduceLROnPlateau
from vocal_remover_tpu_torch.train.step import Trainer

from torch_port_helpers import TINY, tiny_weights

torch.set_num_threads(1)

SR, N_FFT, HOP = 8000, 256, 128


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """Two 8 kHz stereo songs (1.5 s and 0.5 s, shorter than the crop),
    one copy for each package: (the JAX package's root, the port's)."""
    base = tmp_path_factory.mktemp("library_data")
    jroot = base / "jax"
    rng = np.random.default_rng(41)
    for name, seconds in (("a", 1.5), ("b", 0.5)):
        t = np.arange(int(SR * seconds)) / SR
        y = np.stack([0.3 * np.sin(2 * np.pi * 170 * t)] * 2)
        x = y + 0.2 * np.sin(2 * np.pi * 610 * t) + 0.02 * \
            rng.standard_normal(y.shape)
        for sub, w in (("mixtures", x), ("instruments", y)):
            os.makedirs(jroot / sub, exist_ok=True)
            jaudio.write_wav(str(jroot / sub / f"{name}.wav"), w, SR)
    shutil.copytree(jroot, base / "port")
    return str(jroot), str(base / "port")


def _files(root):
    return [(os.path.join(root, "mixtures", f"{n}.wav"),
             os.path.join(root, "instruments", f"{n}.wav")) for n in "ab"]


def _rel(paths, root):
    return [os.path.relpath(p, root) for p in paths]


@pytest.fixture(scope="module")
def sets(roots):
    """(JAX training set, port training set), made with a progress
    callback that must see the whole file list once."""
    jroot, root = roots
    seen = []

    def progress(it):
        seen.append(list(it))
        return it

    jset = jcache.make_training_set(_files(jroot), SR, HOP, N_FFT)
    tset = cache.make_training_set(_files(root), SR, HOP, N_FFT,
                                   progress=progress)
    assert seen == [_files(root)]
    return jset, tset


def test_make_sets_progress_match_jax(roots, sets, tmp_path):
    """`progress` wraps the file list of make_training_set and
    make_validation_set, which return what JAX's return."""
    jroot, root = roots
    jset, tset = sets
    for (jx, jy, jc), (tx, ty, tc) in zip(jset, tset, strict=True):
        assert _rel([tx, ty], root) == _rel([jx, jy], jroot) and tc == jc
    seen, jseen = [], []
    tp = dataset.make_validation_set(
        _files(root), 64, SR, HOP, N_FFT, 16,
        patch_root=str(tmp_path / "p"),
        progress=lambda it: seen.append(len(it)) or it)
    jp = jdataset.make_validation_set(
        _files(jroot), 64, SR, HOP, N_FFT, 16,
        patch_root=str(tmp_path / "j"),
        progress=lambda it: jseen.append(len(it)) or it)
    assert seen == jseen == [2]
    assert _rel(tp, tmp_path / "p") == _rel(jp, tmp_path / "j")
    assert len(tp) > 2


def _training_sets(sets, **kw):
    jset, tset = sets
    ramp = np.linspace(0, 0.2, N_FFT // 2 + 1, dtype=np.float32)[:, None]
    kw = dict(cropsize=64, reduction_rate=0.0, reduction_weight=ramp,
              mixup_rate=0.0, mixup_alpha=1.0, seed=3) | kw
    return jdataset.TrainingSet(jset, **kw), dataset.TrainingSet(tset, **kw)


@pytest.mark.parametrize("kw", [
    dict(epoch_multiplier=3, drop_last=True, prefetch=3, shuffle=True),
    dict(epoch_multiplier=2, drop_last=False, prefetch=0, shuffle=True),
    dict(epoch_multiplier=1, drop_last=True, prefetch=1, shuffle=False),
], ids=["x3_drop_prefetch3", "x2_keep_unbounded", "x1_drop_prefetch1"])
def test_loader_keywords_match_jax(sets, kw, monkeypatch):
    """Batches over len(dataset) * epoch_multiplier indices (the dataset
    takes idx % its length), a short last batch dropped with drop_last,
    `prefetch` the queue's bound (0: none), two epochs, equal to JAX's
    Loader bit for bit."""
    jds, tds = _training_sets(sets)
    sizes = []

    class Queue(queue.Queue):
        def __init__(self, maxsize=0):
            sizes.append(maxsize)
            super().__init__(maxsize)

    monkeypatch.setattr(loader.queue, "Queue", Queue)
    jl = jloader.Loader(jds, 3, num_workers=2, seed=8, **kw)
    tl = loader.Loader(tds, 3, num_workers=2, seed=8, **kw)
    n = 2 * kw["epoch_multiplier"]
    assert tl.num_samples == jl.num_samples == n
    assert len(tl) == len(jl) == (n // 3 if kw["drop_last"] else -(-n // 3))
    for _ in range(2):
        jb, tb = list(jl), list(tl)
        assert len(tb) == len(tl)
        for (jx, jy), (tx, ty) in zip(jb, tb, strict=True):
            assert tx.shape == (len(tx), 2, N_FFT // 2 + 1, 64)
            assert np.array_equal(tx, jx) and np.array_equal(ty, jy)
    assert sizes == [kw["prefetch"]] * 4  # both packages' queues


@pytest.mark.parametrize("drop_last", [False, True])
def test_device_loader_drop_last_matches_jax(drop_last, monkeypatch):
    """DeviceLoader over the source's length: JAX's index batches, two
    epochs, the short last one dropped with drop_last."""
    monkeypatch.setattr(device_cache, "_RESIDENT_BYTES", 0)
    rng = np.random.default_rng(42)
    mags = [(rng.uniform(size=(2, 5, n)).astype(np.float32),
             rng.uniform(size=(2, 5, n)).astype(np.float32))
            for n in (40, 20)]
    kw = dict(cropsize=16, patches=4, seed=2)
    src = DeviceTrainingSource.from_magnitudes(mags, dtype=torch.float32,
                                               device="cpu", **kw)
    jsrc = JDeviceTrainingSource.from_magnitudes(mags, dtype=jnp.float32,
                                                 **kw)
    tl = DeviceLoader(src, 3, seed=6, drop_last=drop_last)
    jl = JDeviceLoader(jsrc, 3, seed=6, drop_last=drop_last)
    assert len(tl) == len(jl) == (2 if drop_last else 3)
    for _ in range(2):
        got, want = list(tl), list(jl)
        assert len(got) == len(tl)
        for a, b in zip(got, want, strict=True):
            for u, v in zip(a, b, strict=True):
                assert np.array_equal(u, v)


def test_complex_crops_without_channels_match_jax(roots, sets, tmp_path):
    """complex_as_channels=False: TrainingSet and ValidationSet give the
    complex (2, F, T) crops, as JAX's do; with True the (4, F, T) float32
    stacks."""
    jds, tds = _training_sets(sets, is_complex=True,
                              complex_as_channels=False, reduction_rate=0.5,
                              mixup_rate=0.5)
    for epoch in (0, 1):
        jds.set_epoch(epoch)
        tds.set_epoch(epoch)
        for i in range(len(tds)):
            (jx, jy), (tx, ty) = jds[i], tds[i]
            assert np.iscomplexobj(tx) and tx.dtype == jx.dtype
            assert tx.shape == (2, N_FFT // 2 + 1, 64)
            assert np.array_equal(tx, jx) and np.array_equal(ty, jy)
    patches = dataset.make_validation_set(_files(roots[1]), 64, SR, HOP,
                                          N_FFT, 16, patch_root=str(tmp_path))
    for cac in (False, True):
        tv = dataset.ValidationSet(patches, is_complex=True,
                                   complex_as_channels=cac)
        jv = jdataset.ValidationSet(patches, is_complex=True,
                                    complex_as_channels=cac)
        for i in range(len(tv)):
            (jx, jy), (tx, ty) = jv[i], tv[i]
            assert tx.dtype == jx.dtype and tx.shape == jx.shape
            assert tx.shape[0] == (4 if cac else 2)
            assert np.array_equal(tx, jx) and np.array_equal(ty, jy)


@pytest.fixture(scope="module")
def weights():
    return tiny_weights(44)


def _port_trainer(weights, prefetch, **kw):
    model = convert.from_jax_variables(CascadedNet(*TINY), weights)
    return Trainer(model, 1e-3, device="cpu", prefetch=prefetch, **kw)


def _data(n=2):
    rng = np.random.default_rng(43)
    out = []
    for _ in range(n):
        X = np.abs(rng.standard_normal((2, 2, 33, 160))).astype(np.float32)
        out.append((X, (X * rng.uniform(0, 1, X.shape)).astype(np.float32)))
    return out


def test_trainer_prefetch_changes_no_loss(weights, monkeypatch):
    """prefetch 0 (no staging thread), 1 and 3: the same losses of an
    epoch and a validation pass, bit for bit, dropout on."""
    depths = []
    real = tstep.device_prefetch

    def spy(it, put_fn, depth):
        depths.append(depth)
        return real(it, put_fn, depth=depth)

    monkeypatch.setattr(tstep, "device_prefetch", spy)
    data = _data()
    runs = {}
    for prefetch in (0, 1, 3):
        t = _port_trainer(weights, prefetch, seed=9)
        assert t.prefetch == prefetch
        runs[prefetch] = [t.train_epoch(data), t.validate_epoch(data)]
    assert runs[0] == runs[1] == runs[3]
    assert depths == [1, 1, 3, 3]  # no thread at 0


def test_trainer_prefetch_matches_jax(weights):
    """JAX's Trainer at prefetch 0 and 3 (its staging, shared by the
    epochs and validation): the port's validation loss at the same
    prefetch within 1e-5 relative, as tests/test_torch_train_step.py
    holds it."""
    data = _data(n=3)
    jt = JTrainer(JCascadedNet(*TINY), weights, learning_rate=1e-3)
    for prefetch in (0, 3):
        jt.prefetch = prefetch
        want = jt.validate_epoch(data)
        got = _port_trainer(weights, prefetch).validate_epoch(data)
        assert abs(got - want) <= 1e-5 * want, prefetch


@pytest.mark.parametrize("suffix", [".pt", ".msgpack"])
def test_save_train_state_extra_matches_jax(weights, tmp_path, suffix):
    """`extra` lands in the .meta.json as meta["extra"] in both layouts,
    and the meta equals what JAX's save_train_state writes for the same
    epoch, loss, step counter, scheduler and extra (None: {})."""
    jt = JTrainer(JCascadedNet(*TINY), weights, learning_rate=1e-3)
    t = _port_trainer(weights, 2)
    for extra in ({"note": "x", "songs": [1, 2]}, None):
        path = str(tmp_path / f"state{suffix}")
        jpath = str(tmp_path / "jax.msgpack")
        checkpoint.save_train_state(path, t, ReduceLROnPlateau(lr=1e-3), 3,
                                    0.25, extra=extra)
        jcheckpoint.save_train_state(jpath, jt, JPlateau(lr=1e-3), 3, 0.25,
                                     extra=extra)
        with open(path + ".meta.json") as f, open(jpath + ".meta.json") as g:
            meta, jmeta = json.load(f), json.load(g)
        assert meta == jmeta and meta["extra"] == (extra or {})
        again = _port_trainer(weights, 2)
        assert checkpoint.load_train_state(path, again, ReduceLROnPlateau(
            lr=1e-3)) == (3, 0.25)
