"""GPU port, the rest of training: the device-resident dataset
(data/device_cache.py), the counterparts of the JAX package's
tests/test_device_cache.py (but its data-parallel case, ROADMAP A10).
At float32 a device batch equals the host path's batch bit for bit, and
the JAX package's DeviceTrainingSource.gather of the same magnitudes bit
for bit in float32 and bf16 residency (with the reduction on, within the
one rounding XLA's fused multiply-add saves); the reduction
augmentation matches the host's complex path within JAX's 2e-6; two
epochs of training and a validation pass give the host path's losses
exactly; the memory check refuses what does not fit."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vocal_remover_tpu.data.device_cache import (
    DeviceTrainingSource as JDeviceTrainingSource,
)
from vocal_remover_tpu_torch.data import cache, dataset, device_cache, pairing
from vocal_remover_tpu_torch.data.device_cache import (
    DeviceLoader,
    DeviceTrainingSource,
    DeviceValidationSource,
)
from vocal_remover_tpu_torch.data.loader import Loader
from vocal_remover_tpu_torch.models.cascaded import CascadedNet
from vocal_remover_tpu_torch.train.step import Trainer
from vocal_remover_tpu_torch.utils import audio

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def fresh_resident_count(monkeypatch):
    """The process-wide resident byte count starts at 0 in every test."""
    monkeypatch.setattr(device_cache, "_RESIDENT_BYTES", 0)


@pytest.fixture(scope="module")
def songs(tmp_path_factory):
    """3 cached 8 kHz songs -> (training_set [(X_path, y_path, coef)],
    the (mixture, instruments) wav pairs)."""
    root = tmp_path_factory.mktemp("device_cache_songs")
    mix, inst = root / "mixtures", root / "instruments"
    mix.mkdir()
    inst.mkdir()
    sr = 8000
    rng = np.random.default_rng(7)
    for i in range(3):
        t = np.arange(sr * 3) / sr
        y = 0.4 * np.sin(2 * np.pi * (200 + 60 * i) * t)
        v = 0.3 * np.sin(2 * np.pi * (900 + 90 * i) * t)
        v += 0.02 * rng.standard_normal(t.shape)
        stereo_y = np.stack([y, 0.9 * y]).astype(np.float32)
        stereo_x = stereo_y + np.stack([v, 1.1 * v]).astype(np.float32)
        audio.write_wav(str(mix / f"song{i}.wav"), stereo_x, sr)
        audio.write_wav(str(inst / f"song{i}.wav"), stereo_y, sr)
    pairs = pairing.make_pair(str(mix), str(inst))
    return cache.make_training_set(pairs, sr, 128, 256), pairs


@pytest.mark.parametrize("kw", [{"is_complex": True}, {"mixup_rate": 0.5},
                                {"mono_rate": 0.2}, {"empty": True}],
                         ids=["complex", "mixup", "mono", "empty"])
def test_source_rejects_unsupported(songs, kw):
    tset = [] if kw.pop("empty", False) else songs[0]
    with pytest.raises(ValueError):
        DeviceTrainingSource(tset, cropsize=32, device="cpu", **kw)
    if kw.get("is_complex"):
        with pytest.raises(ValueError):
            DeviceValidationSource([], is_complex=True, device="cpu")


def test_device_batches_equal_host_bit_for_bit(songs):
    """Two epochs: every device batch is the host loader's (the fast
    path, two workers) at float32, bit for bit."""
    tset = songs[0]
    host = Loader(dataset.TrainingSet(tset * 2, 32, 0, None, 0, 1, seed=3),
                  batchsize=4, shuffle=True, num_workers=2, seed=11)
    src = DeviceTrainingSource(tset * 2, cropsize=32, seed=3,
                               dtype=torch.float32, device="cpu")
    dev = DeviceLoader(src, batchsize=4, shuffle=True, seed=11)
    n = 0
    for _ in range(2):
        for (Xh, yh), idx in zip(host, dev, strict=True):
            Xd, yd = src.gather(*idx)
            assert Xd.dtype == torch.float32 and Xd.is_contiguous()
            assert np.array_equal(Xd.numpy(), Xh)
            assert np.array_equal(yd.numpy(), yh)
            n += 1
    assert n == 2 * len(dev) == 4


@pytest.mark.parametrize("resident", ["float32", "bfloat16"])
@pytest.mark.parametrize("reduction", [0.0, 1.0])
def test_gather_equals_jax(songs, resident, reduction):
    """The same magnitudes through both packages' from_magnitudes: equal
    index batches and gathered batches (bf16 residency: the same bf16
    values, cast to float32 before the arithmetic). Bit for bit, except
    that with the reduction XLA computes y - v * rweight as one fused
    multiply-add where the port (as the host path's numpy) rounds the
    product first: there y is held to one rounding of the product,
    2**-24 of max |X|, and to numpy's two-rounding formula bit for bit."""
    tset = songs[0]
    mags = [(device_cache._magnitudes(X, c), device_cache._magnitudes(y, c))
            for X, y, c in tset]
    F = mags[0][0].shape[1]
    ramp = np.linspace(1, 0, F, dtype=np.float32)[:, None] * 0.4
    kw = dict(cropsize=32, patches=2, reduction_rate=reduction,
              reduction_weight=ramp, seed=5)
    src = DeviceTrainingSource.from_magnitudes(
        mags, dtype=getattr(torch, resident), device="cpu", **kw)
    jsrc = JDeviceTrainingSource.from_magnitudes(
        mags, dtype=getattr(jnp, resident), **kw)
    plain = DeviceTrainingSource.from_magnitudes(
        mags, dtype=getattr(torch, resident), device="cpu",
        **(kw | {"reduction_rate": 0.0}))
    for b in (np.arange(6), np.array([5, 0, 3])):
        idx, jidx = src.index_batch(b), jsrc.index_batch(b)
        for a, ja in zip(idx, jidx):
            assert np.array_equal(a, ja)
        X, y = (a.numpy() for a in src.gather(*idx))
        jX, jy = (np.asarray(a) for a in jsrc.gather(*jidx))
        assert np.array_equal(X, jX)
        if not reduction:
            assert np.array_equal(y, jy)
            continue
        assert idx[1].all()
        np.testing.assert_allclose(y, jy, rtol=0,
                                   atol=2.0**-24 * np.abs(X).max())
        # numpy's formula on the unreduced batch (no instrumental-as-
        # mixture item in these batches, so X is the mixture)
        assert not idx[3].any()
        X0, y0 = (a.numpy() for a in plain.gather(idx[0], 0 * idx[1],
                                                  idx[2], idx[3]))
        v = np.maximum(X0 - y0, np.float32(0))
        v = v * (v > y0)
        assert np.array_equal(y, np.maximum(y0 - v * ramp, np.float32(0)))


def test_reduction_matches_host_complex_path(songs):
    """Vocal reduction on resident magnitudes == the host's complex
    path followed by |.| (reference lib/dataset.py:49-57, 104-119),
    within JAX's 2e-6."""
    tset = songs[0]
    ramp = np.linspace(1, 0, 129, dtype=np.float32)[:, None] * 0.4
    host = dataset.TrainingSet(tset, 32, 1.0, ramp, 0, 1, seed=5)
    src = DeviceTrainingSource(tset, cropsize=32, reduction_rate=1.0,
                               reduction_weight=ramp, seed=5,
                               dtype=torch.float32, device="cpu")
    idx = next(iter(DeviceLoader(src, batchsize=3, shuffle=False)))
    Xd, yd = src.gather(*idx)
    for j in range(3):
        Xh, yh = host[j]
        np.testing.assert_allclose(Xd[j].numpy(), Xh, rtol=0, atol=2e-6)
        np.testing.assert_allclose(yd[j].numpy(), yh, rtol=0, atol=2e-6)


def test_training_trajectory_equals_host(songs):
    """Two epochs through the Trainer: the host path's losses and final
    weights, exactly."""
    tset = songs[0]
    model = CascadedNet(256, 128, 4, 8,
                        generator=torch.Generator().manual_seed(0))
    host = Loader(dataset.TrainingSet(tset, 160, 0, None, 0, 1, seed=3),
                  batchsize=2, shuffle=True, num_workers=1, seed=11)
    t_host = Trainer(model, 1e-3, dropout=False, device="cpu")
    src = DeviceTrainingSource(tset, cropsize=160, seed=3,
                               dtype=torch.float32, device="cpu")
    dev = DeviceLoader(src, batchsize=2, shuffle=True, seed=11)
    t_dev = Trainer(CascadedNet(256, 128, 4, 8,
                                generator=torch.Generator().manual_seed(0)),
                    1e-3, dropout=False, device="cpu")
    host_losses = [t_host.train_epoch(host) for _ in range(2)]
    dev_losses = [t_dev.train_epoch_device(src, dev) for _ in range(2)]
    assert dev_losses == host_losses and np.isfinite(host_losses).all()
    for (k, a), b in zip(t_host.model.state_dict().items(),
                         t_dev.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_device_validation_equals_host(songs, tmp_path):
    patch_list = dataset.make_validation_set(
        songs[1][:2], cropsize=160, sr=8000, hop_length=128, n_fft=256,
        offset=15, patch_root=str(tmp_path))
    t = Trainer(CascadedNet(256, 128, 4, 8), 1e-3, device="cpu")
    host = t.validate_epoch(Loader(dataset.ValidationSet(patch_list),
                                   batchsize=3, num_workers=2))
    src = DeviceValidationSource(patch_list, dtype=torch.float32,
                                 device="cpu")
    assert len(src) == len(patch_list) > 3
    assert src.nbytes == 2 * 4 * src.X.numel()
    assert t.validate_epoch_device(src, batchsize=3) == host


def test_check_hbm_fit_refuses_what_does_not_fit(monkeypatch):
    """0.6 of the card's memory, counting every source of the process;
    the CPU has no limit."""
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: SimpleNamespace(total_memory=1000))
    card = torch.device("cuda")
    device_cache._check_hbm_fit(400, card)
    with pytest.raises(ValueError, match="--device_data_cache"):
        device_cache._check_hbm_fit(201, card)  # 601 of 1000 jointly
    assert device_cache._RESIDENT_BYTES == 400
    device_cache._check_hbm_fit(10**12, torch.device("cpu"))


def test_index_upload_is_packed():
    """A step uploads 4 bytes of crop start and 3 flag bytes an item."""
    starts = np.array([7, 2**20, 3, 0], np.int32)
    flags = [np.array([1, 0, 0, 1], bool), np.array([0, 1, 0, 0], bool),
             np.array([0, 0, 1, 1], bool)]
    buf = device_cache.pack_indices(starts, *flags)
    assert buf.dtype == np.uint8 and buf.nbytes == 28
    t = torch.from_numpy(buf)
    assert np.array_equal(t[:16].view(torch.int32).numpy(), starts)
    assert np.array_equal(t[16:].view(3, 4).bool().numpy(), np.stack(flags))
