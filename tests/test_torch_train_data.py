"""GPU port, training slice: the data pipeline against the JAX package's,
byte for byte: pairing and splits, the spectrogram cache's .npy files,
TrainingSet items (magnitude fast path; reduction, mixup and mono on),
Loader batches at several worker counts, validation patches, the
alignment and the oracle sampler. Each package reads its own copy of
one synthetic dataset (the caches are written beside the audio)."""

import os
import random
import shutil

import numpy as np
import pytest

from vocal_remover_tpu import native as jnative
from vocal_remover_tpu.data import cache as jcache
from vocal_remover_tpu.data import dataset as jdataset
from vocal_remover_tpu.data import pairing as jpairing
from vocal_remover_tpu.data.loader import Loader as JLoader
from vocal_remover_tpu.utils import audio as jaudio
from vocal_remover_tpu.utils import spec as jspec
from vocal_remover_tpu_torch.data import cache, dataset, pairing
from vocal_remover_tpu_torch.data.loader import Loader
from vocal_remover_tpu_torch.utils import spec

SR = 8000
N_FFT, HOP = 256, 128
# (name, seconds, mixture delay in samples, channels)
SONGS = [("a", 3.0, 0, 2), ("b", 2.5, 37, 2), ("c", 4.0, 0, 1),
         ("d", 1.0, 0, 2)]


def _write_songs(root):
    rng = np.random.default_rng(31)
    for sub in ("mixtures", "instruments"):
        os.makedirs(os.path.join(root, sub))
    for name, seconds, delay, ch in SONGS:
        t = np.arange(int(SR * seconds)) / SR
        inst = 0.3 * np.sin(2 * np.pi * 180 * t) + 0.05 * rng.standard_normal(
            t.size)
        voice = 0.25 * np.sin(2 * np.pi * 660 * t * (1 + 0.01 * np.sin(t)))
        y = np.stack([inst, 0.8 * inst][:ch]).astype(np.float32)
        x = (y + np.stack([voice, voice][:ch])).astype(np.float32)
        if delay:
            x = np.concatenate([np.zeros((ch, delay), np.float32), x], 1)
        jaudio.write_wav(os.path.join(root, "mixtures", f"{name}.wav"), x, SR)
        jaudio.write_wav(os.path.join(root, "instruments", f"{name}.wav"), y,
                         SR)
    # not picked by either package: the extension matches case-sensitively
    for sub in ("mixtures", "instruments"):
        shutil.copy(os.path.join(root, sub, "a.wav"),
                    os.path.join(root, sub, "upper.WAV"))
        with open(os.path.join(root, sub, "notes.txt"), "w") as f:
            f.write("not audio")


@pytest.fixture
def roots(tmp_path):
    """Two copies of one dataset: the JAX package's and the port's."""
    base = tmp_path / "jax"
    _write_songs(str(base))
    shutil.copytree(base, tmp_path / "port")
    return str(base), str(tmp_path / "port")


def rel(pairs, root):
    return [[os.path.relpath(p, root) for p in pair] for pair in pairs]


def test_pairing_and_splits_match_jax(roots):
    jroot, root = roots
    jp = jpairing.make_pair(os.path.join(jroot, "mixtures"),
                            os.path.join(jroot, "instruments"))
    tp = pairing.make_pair(os.path.join(root, "mixtures"),
                           os.path.join(root, "instruments"))
    assert rel(tp, root) == rel(jp, jroot)
    assert len(tp) == 4  # upper.WAV and notes.txt are not picked
    for seed in (0, 2019):
        for val_rate in (0.25, 0.5):
            random.seed(seed)
            jsplit = jpairing.train_val_split(jroot, "random", val_rate, [])
            random.seed(seed)
            tsplit = pairing.train_val_split(root, "random", val_rate, [])
            assert [rel(s, root) for s in tsplit] == \
                [rel(s, jroot) for s in jsplit]
    # an explicit validation list is honoured by exclusion
    val = [list(tp[1])]
    random.seed(3)
    train, v = pairing.train_val_split(root, "random", 0.5, val)
    assert v == val and list(tp[1]) not in [list(p) for p in train]
    assert len(train) == 3
    with pytest.raises(ValueError, match="subdirs"):
        pairing.train_val_split(root, "subdirs", 0.5, val)


def test_cache_files_are_byte_identical_to_jax(roots):
    jroot, root = roots
    jset = jcache.make_training_set(
        jpairing.make_pair(os.path.join(jroot, "mixtures"),
                           os.path.join(jroot, "instruments")),
        SR, HOP, N_FFT)
    tset = cache.make_training_set(
        pairing.make_pair(os.path.join(root, "mixtures"),
                          os.path.join(root, "instruments")),
        SR, HOP, N_FFT)
    assert len(tset) == len(jset) == 4
    for (jx, jy, jc), (tx, ty, tc) in zip(jset, tset):
        assert os.path.relpath(tx, root) == os.path.relpath(jx, jroot)
        for a, b in ((jx, tx), (jy, ty)):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), b
        assert tc == jc and type(tc) is type(jc)
        assert cache.read_npy_shape(tx) == jcache.read_npy_shape(jx)
        assert np.array_equal(cache.read_npy_rows(tx, 5, 7),
                              jcache.read_npy_rows(jx, 5, 7))
    # a second call loads the cache
    X, y, _, _ = cache.cache_or_load(
        os.path.join(root, "mixtures", "b.wav"),
        os.path.join(root, "instruments", "b.wav"), SR, HOP, N_FFT)
    jX, jy_, _, _ = jcache.cache_or_load(
        os.path.join(jroot, "mixtures", "b.wav"),
        os.path.join(jroot, "instruments", "b.wav"), SR, HOP, N_FFT)
    assert np.array_equal(X, jX) and np.array_equal(y, jy_)


def test_alignment_matches_jax():
    rng = np.random.default_rng(32)
    n = SR * 5
    y = rng.standard_normal((2, n)).astype(np.float32) * 0.2
    y[:, :SR] = 0  # a second of leading silence for the trim
    x = np.concatenate([np.zeros((2, 123), np.float32), y[:, :-123]], 1) + \
        0.1 * rng.standard_normal((2, n)).astype(np.float32)
    for a, b in ((x, y), (y, x)):
        ta, tb = spec.align_wave_head_and_tail(a, b, SR)
        ja, jb = jspec.align_wave_head_and_tail(a, b, SR)
        assert np.array_equal(ta, ja) and np.array_equal(tb, jb)
    tw, tr = spec.trim_silence(y)
    jw, jr = jspec.trim_silence(y)
    assert tr == jr and tr[0] > 0 and np.array_equal(tw, jw)


def _sets(roots, **aug):
    jroot, root = roots
    jts = jcache.make_training_set(
        jpairing.make_pair(os.path.join(jroot, "mixtures"),
                           os.path.join(jroot, "instruments")),
        SR, HOP, N_FFT)
    tts = cache.make_training_set(
        pairing.make_pair(os.path.join(root, "mixtures"),
                          os.path.join(root, "instruments")),
        SR, HOP, N_FFT)
    ramp = np.linspace(0, 1, N_FFT // 2 + 1, dtype=np.float32)[:, None] * 0.2
    kw = dict(cropsize=64, reduction_rate=0.0, reduction_weight=ramp,
              mixup_rate=0.0, mixup_alpha=1.0, seed=7, mono_rate=0.0)
    kw.update(aug)
    return (jdataset.TrainingSet(jts * 3, **kw),
            dataset.TrainingSet(tts * 3, **kw))


@pytest.mark.parametrize("aug", [
    {},
    {"reduction_rate": 0.5, "mixup_rate": 0.5, "mono_rate": 0.5},
], ids=["fast_path", "reduction_mixup_mono"])
def test_training_set_items_are_byte_identical_to_jax(roots, aug,
                                                      monkeypatch):
    """Epochs 0 and 1. The JAX package is held on its numpy branch of the
    magnitude fast path (the port has no native/vrtnative.c)."""
    monkeypatch.setattr(jnative, "load_crop_abs", lambda *a, **k: None)
    jset, tset = _sets(roots, **aug)
    assert len(tset) == len(jset) == 12
    for epoch in (0, 1):
        jset.set_epoch(epoch)
        tset.set_epoch(epoch)
        for i in range(len(tset)):
            (jx, jy), (tx, ty) = jset[i], tset[i]
            assert tx.dtype == jx.dtype == np.float32
            assert tx.shape == (2, N_FFT // 2 + 1, 64)
            assert np.array_equal(tx, jx) and np.array_equal(ty, jy), \
                (epoch, i)


@pytest.mark.parametrize("num_workers", [1, 3])
def test_loader_batches_are_identical_to_jax(roots, num_workers,
                                             monkeypatch):
    monkeypatch.setattr(jnative, "load_crop_abs", lambda *a, **k: None)
    jset, tset = _sets(roots, mixup_rate=0.3)
    jl = JLoader(jset, batchsize=5, shuffle=True, num_workers=num_workers,
                 seed=11)
    tl = Loader(tset, batchsize=5, shuffle=True, num_workers=num_workers,
                seed=11)
    for _ in range(2):  # epochs 0 and 1
        jb, tb = list(jl), list(tl)
        assert [len(b[0]) for b in tb] == [5, 5, 2]
        for (jx, jy), (tx, ty) in zip(jb, tb, strict=True):
            assert np.array_equal(tx, jx) and np.array_equal(ty, jy)
    # set_epoch (resume) continues the stream
    tl2 = Loader(tset, batchsize=5, shuffle=True, num_workers=num_workers,
                 seed=11)
    tl2.set_epoch(1)
    jl.set_epoch(1)
    for (jx, _), (tx, _) in zip(list(jl), list(tl2), strict=True):
        assert np.array_equal(tx, jx)


def test_validation_patches_are_identical_to_jax(roots, tmp_path):
    jroot, root = roots
    jfiles = jpairing.make_pair(os.path.join(jroot, "mixtures"),
                                os.path.join(jroot, "instruments"))[:2]
    tfiles = pairing.make_pair(os.path.join(root, "mixtures"),
                               os.path.join(root, "instruments"))[:2]
    jp = jdataset.make_validation_set(jfiles, 256, SR, HOP, N_FFT, 64,
                                      patch_root=str(tmp_path / "pj"))
    tp = dataset.make_validation_set(tfiles, 256, SR, HOP, N_FFT, 64,
                                     patch_root=str(tmp_path / "pt"))
    assert [os.path.relpath(p, tmp_path / "pt") for p in tp] == \
        [os.path.relpath(p, tmp_path / "pj") for p in jp]
    assert len(tp) > 2
    jv, tv = jdataset.ValidationSet(jp), dataset.ValidationSet(tp)
    for i in range(len(tv)):
        with np.load(jp[i]) as a, np.load(tp[i]) as b:
            assert np.array_equal(a["X"], b["X"])
            assert np.array_equal(a["y"], b["y"])
        (jx, jy), (tx, ty) = jv[i], tv[i]
        assert tx.dtype == np.float32 and tx.shape == (2, 129, 256)
        assert np.array_equal(tx, jx) and np.array_equal(ty, jy)


def test_oracle_data_matches_jax():
    rng = np.random.default_rng(33)
    X = rng.standard_normal((20, 2, 3, 4)).astype(np.float32)
    y = rng.standard_normal((20, 2, 3, 4)).astype(np.float32)
    loss = rng.uniform(size=20)
    a = dataset.get_oracle_data(X, y, loss, 0.2, 0.5,
                                np.random.default_rng(1))
    b = jdataset.get_oracle_data(X, y, loss, 0.2, 0.5,
                                 np.random.default_rng(1))
    for u, v in zip(a, b, strict=True):
        assert np.array_equal(u, v)
