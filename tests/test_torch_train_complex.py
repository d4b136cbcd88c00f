"""GPU port, complex-mask training: the port's complex items
(`TrainingSet` / `ValidationSet(is_complex=True)`) byte for byte against
the JAX package's, the complex validation loss against JAX's `Trainer`,
what the trainer refuses, and `cli.train --is_complex --wave_loss sdr`
on the CPU, whose checkpoint serves through `cli.inference` and
`cli.evaluate`. The gradients are held against JAX's in
test_torch_train_grads_complex*.py."""

import glob
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from vocal_remover_tpu.data import cache as jcache
from vocal_remover_tpu.data import dataset as jdataset
from vocal_remover_tpu.data import pairing as jpairing
from vocal_remover_tpu.models import convert as jconvert
from vocal_remover_tpu.models.cascaded import CascadedNet as JCascadedNet
from vocal_remover_tpu.nn import config as jconfig
from vocal_remover_tpu.train.step import Trainer as JTrainer
from vocal_remover_tpu.utils import audio as jaudio
from vocal_remover_tpu_torch.cli import evaluate as eval_cli
from vocal_remover_tpu_torch.cli import inference as inference_cli
from vocal_remover_tpu_torch.cli import train as train_cli
from vocal_remover_tpu_torch.data import cache, dataset, pairing
from vocal_remover_tpu_torch.models import convert
from vocal_remover_tpu_torch.models.cascaded import CascadedNet
from vocal_remover_tpu_torch.nn import config as tconfig
from vocal_remover_tpu_torch.train.step import Trainer

from torch_port_helpers import TINY, tiny_batch, tiny_weights

torch.set_num_threads(1)

SR = 8000
N_FFT, HOP = 256, 128


def _write_songs(root, seconds=(3.0, 2.5, 4.0)):
    rng = np.random.default_rng(61)
    for sub in ("mixtures", "instruments"):
        os.makedirs(os.path.join(root, sub))
    for i, s in enumerate(seconds):
        t = np.arange(int(SR * s)) / SR
        inst = 0.3 * np.sin(2 * np.pi * (150 + 30 * i) * t) \
            + 0.05 * rng.standard_normal(t.size)
        voice = 0.25 * np.sin(2 * np.pi * 660 * t * (1 + 0.01 * np.sin(t)))
        y = np.stack([inst, 0.8 * inst]).astype(np.float32)
        jaudio.write_wav(os.path.join(root, "instruments", f"s{i}.wav"), y,
                         SR)
        jaudio.write_wav(os.path.join(root, "mixtures", f"s{i}.wav"),
                         y + np.stack([voice, 0.7 * voice]).astype(
                             np.float32), SR)


@pytest.fixture
def roots(tmp_path):
    """Two copies of one dataset: the JAX package's and the port's."""
    _write_songs(str(tmp_path / "jax"))
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    return str(tmp_path / "jax"), str(tmp_path / "port")


def _pairs(root, pkg):
    return pkg.make_pair(os.path.join(root, "mixtures"),
                         os.path.join(root, "instruments"))


@pytest.mark.parametrize("aug", [
    {},
    {"reduction_rate": 0.5, "mixup_rate": 0.5, "mono_rate": 0.5},
], ids=["no_aug", "reduction_mixup_mono"])
def test_complex_training_items_are_byte_identical_to_jax(roots, aug):
    """(4, F, crop) float32 [real; imaginary] stacks, epochs 0 and 1."""
    jroot, root = roots
    jts = jcache.make_training_set(_pairs(jroot, jpairing), SR, HOP, N_FFT)
    tts = cache.make_training_set(_pairs(root, pairing), SR, HOP, N_FFT)
    ramp = np.linspace(0, 1, N_FFT // 2 + 1, dtype=np.float32)[:, None] * 0.2
    kw = dict(cropsize=64, reduction_rate=0.0, reduction_weight=ramp,
              mixup_rate=0.0, mixup_alpha=1.0, seed=9, is_complex=True,
              mono_rate=0.0)
    kw.update(aug)
    jset = jdataset.TrainingSet(jts * 3, **kw)
    tset = dataset.TrainingSet(tts * 3, **kw)
    for epoch in (0, 1):
        jset.set_epoch(epoch)
        tset.set_epoch(epoch)
        for i in range(len(tset)):
            (jx, jy), (tx, ty) = jset[i], tset[i]
            assert tx.dtype == np.float32 and tx.shape == (4, 129, 64)
            assert np.array_equal(tx, jx) and np.array_equal(ty, jy), \
                (epoch, i)
    # the magnitude items of the same set are the first two channels'
    # moduli (the fast path stays for magnitude sets only)
    kw["is_complex"] = False
    mset = dataset.TrainingSet(tts * 3, **kw)
    mset.set_epoch(1)
    if not aug:
        mx, _ = mset[4]
        tx, _ = tset[4]
        np.testing.assert_allclose(mx, np.hypot(tx[:2], tx[2:]), rtol=1e-6)


def test_complex_validation_items_are_byte_identical_to_jax(roots,
                                                            tmp_path):
    jroot, root = roots
    jp = jdataset.make_validation_set(_pairs(jroot, jpairing), 256, SR, HOP,
                                      N_FFT, 64,
                                      patch_root=str(tmp_path / "pj"))
    tp = dataset.make_validation_set(_pairs(root, pairing), 256, SR, HOP,
                                     N_FFT, 64,
                                     patch_root=str(tmp_path / "pt"))
    jv = jdataset.ValidationSet(jp, is_complex=True)
    tv = dataset.ValidationSet(tp, is_complex=True)
    assert len(tv) == len(jv) > 3
    for i in range(len(tv)):
        (jx, jy), (tx, ty) = jv[i], tv[i]
        assert tx.dtype == np.float32 and tx.shape == (4, 129, 256)
        assert np.array_equal(tx, jx) and np.array_equal(ty, jy)


@pytest.fixture(scope="module")
def complex_weights():
    return tiny_weights(14, is_complex=True)


def test_complex_validate_epoch_matches_jax(complex_weights):
    """Trimmed magnitudes of mask (*) X against the centre-cropped |y|,
    in float32: within 1e-5 relative of JAX's. Both run in `highest`,
    set here: the precision mode is process-wide, and a test of another
    file that left either package in bfloat16 would change this one."""
    X, y = (a.astype(np.float32) for a in tiny_batch(is_complex=True))
    data = [(X, y), (X[:1] * 0.5, y[:1])]
    jt = JTrainer(JCascadedNet(*TINY, is_complex=True), complex_weights,
                  learning_rate=1e-3)
    model = convert.from_jax_variables(CascadedNet(*TINY, is_complex=True),
                                       complex_weights)
    trainer = Trainer(model, learning_rate=1e-3, device="cpu")
    with jconfig.precision("highest"), tconfig.precision("highest"):
        want = jt.validate_epoch(data)
        got = trainer.validate_epoch(data)
    assert np.isfinite(got) and abs(got - want) <= 1e-5 * want


def test_trainer_refuses_what_jax_refuses(complex_weights):
    """An unknown wave_loss, and a wave_loss on a magnitude model: the
    same ValueError as JAX's `Trainer`."""
    mag = tiny_weights(15)
    for is_complex, v, wave_loss in ((True, complex_weights, "l2"),
                                     (False, mag, "sdr")):
        with pytest.raises(ValueError) as want:
            JTrainer(JCascadedNet(*TINY, is_complex=is_complex), v, 1e-3,
                     wave_loss=wave_loss)
        model = convert.from_jax_variables(
            CascadedNet(*TINY, is_complex=is_complex), v)
        with pytest.raises(ValueError) as got:
            Trainer(model, 1e-3, wave_loss=wave_loss, device="cpu")
        assert str(got.value) == str(want.value)


FLAGS = ["--gpu", "-1", "--sr", str(SR), "-f", str(N_FFT), "-H", str(HOP),
         "-C", "256", "-B", "2", "-p", "2", "-v", "0.34", "-w", "2"]


def test_cli_trains_a_complex_model_that_serves(tmp_path, monkeypatch):
    """cli.train --is_complex --wave_loss sdr: finite losses, a .vrt.npz
    whose config says is_complex (read by the JAX package's load_native
    too), then that checkpoint through cli.inference (the stems add back
    to the mixture) and cli.evaluate (finite SDRs)."""
    data = str(tmp_path / "data")
    _write_songs(data)
    monkeypatch.chdir(tmp_path)
    out = str(tmp_path / "models")
    train_cli.main(FLAGS + ["-d", data, "-E", "1", "--output_dir", out,
                            "--is_complex", "--wave_loss", "sdr"])
    with open(glob.glob(str(tmp_path / "loss_*.json"))[0]) as f:
        log = json.load(f)
    assert len(log) == 1 and np.isfinite(log).all()
    ckpt = glob.glob(os.path.join(out, "model_iter*.vrt.npz"))[0]
    _, config = jconvert.load_native(ckpt)
    assert config["is_complex"] is True and config["n_fft"] == N_FFT
    model = convert.load_model(ckpt, N_FFT, HOP)
    assert model.is_complex and model.nin == 4

    song = os.path.join(data, "mixtures", "s0.wav")
    sep = str(tmp_path / "sep")
    inference_cli.main(["-P", ckpt, "-i", song, "-r", str(SR), "-f",
                        str(N_FFT), "-H", str(HOP), "-B", "2", "-o", sep,
                        "--gpu", "-1"])
    mix, _ = jaudio.read_wav(song)
    stems = [jaudio.read_wav(os.path.join(sep, f"s0_{s}.wav"))[0]
             for s in ("Instruments", "Vocals")]
    n = HOP * (mix.shape[-1] // HOP)
    assert np.abs(stems[0] + stems[1] - mix)[:, :n].max() * 32768 <= 2

    eval_cli.main(["-P", ckpt, "-m", os.path.join(data, "mixtures"), "-i",
                   os.path.join(data, "instruments"), "-r", str(SR), "-f",
                   str(N_FFT), "-H", str(HOP), "-B", "2", "--gpu", "-1",
                   "--json", str(tmp_path / "eval.json")])
    with open(tmp_path / "eval.json") as f:
        res = json.load(f)
    assert len(res["songs"]) == 3
    assert all(np.isfinite(v) for v in res["mean"].values())


def test_cli_wave_loss_without_is_complex_fails_with_jax_reason(
        tmp_path, monkeypatch):
    data = str(tmp_path / "data")
    _write_songs(data)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="wave_loss requires a complex-mask "
                                         "model"):
        train_cli.main(FLAGS + ["-d", data, "-E", "1", "--output_dir",
                                str(tmp_path / "models"), "--wave_loss",
                                "sdr"])
    with open(glob.glob(str(tmp_path / "train_*.log"))[0]) as f:
        assert "training failed" in f.read()
