"""GPU port, training slice: `python -m vocal_remover_tpu_torch.cli.train`
on the CPU (`--gpu -1`) on a synthetic 8 kHz dataset: the files it
writes, its checkpoint read by the JAX package's `convert.load_native`,
resume against an uninterrupted run, the refused flag, and a failure
that exits non-zero. The JAX training CLI is not run here: its
full-width compile on the CPU takes minutes."""

import glob
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from vocal_remover_tpu.cli.train import reduction_weight_ramp as jramp
from vocal_remover_tpu.models import convert as jconvert
from vocal_remover_tpu.parallel import mesh as jmesh
from vocal_remover_tpu.utils import audio as jaudio
from vocal_remover_tpu_torch.cli import train as cli
from vocal_remover_tpu_torch.models import convert
from vocal_remover_tpu_torch.train import checkpoint

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 8000
FLAGS = ["--gpu", "-1", "--sr", "8000", "-f", "256", "-H", "128", "-C",
         "256", "-B", "2", "-p", "2", "-v", "0.5", "-w", "2"]


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("songs")
    rng = np.random.default_rng(41)
    for sub in ("mixtures", "instruments"):
        (root / sub).mkdir()
    for name in ("one", "two"):
        t = np.arange(SR * 5) / SR
        inst = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 300) * t) \
            + 0.05 * rng.standard_normal(t.size)
        voice = 0.2 * np.sin(2 * np.pi * rng.uniform(500, 900) * t)
        y = np.stack([inst, 0.9 * inst]).astype(np.float32)
        jaudio.write_wav(str(root / "instruments" / f"{name}.wav"), y, SR)
        jaudio.write_wav(str(root / "mixtures" / f"{name}.wav"),
                         y + voice.astype(np.float32), SR)
    return str(root)


def run(argv, cwd, monkeypatch, saved=None):
    """cli.train.main in `cwd`; `saved` collects (path, a copy of the
    port's to_jax_variables of the model, flattened) at each model
    checkpoint."""
    monkeypatch.chdir(cwd)
    if saved is not None:
        def save_model(path, model, _orig=checkpoint.save_model):
            flat = convert._flatten(convert.to_jax_variables(model))
            saved.append((path, {k: a.copy() for k, a in flat.items()}))
            _orig(path, model)
        monkeypatch.setattr(checkpoint, "save_model", save_model)
    cli.main(argv)
    logs = sorted(glob.glob(os.path.join(cwd, "loss_*.json")))
    with open(logs[-1]) as f:
        return json.load(f)


def test_cli_trains_writes_its_files_and_resumes(dataset_dir, tmp_path,
                                                 monkeypatch):
    straight_dir, split_dir = tmp_path / "straight", tmp_path / "split"
    straight_dir.mkdir()
    split_dir.mkdir()
    saved = []
    out = str(split_dir / "models")
    log = run(FLAGS + ["-d", dataset_dir, "-E", "2", "--output_dir", out],
              split_dir, monkeypatch, saved)
    assert len(log) == 2 and np.isfinite(log).all()
    state = os.path.join(out, checkpoint.STATE_NAME)
    assert os.path.exists(state) and os.path.exists(state + ".meta.json")
    assert glob.glob(str(split_dir / "val_*.json"))
    assert glob.glob(str(split_dir / "train_*.log"))
    ckpts = sorted(glob.glob(os.path.join(out, "model_iter*.vrt.npz")))
    assert ckpts and [p for p, _ in saved] == ckpts
    # the JAX package reads the checkpoint into the port's arrays
    for path, want in saved:
        jtree, config = jconvert.load_native(path)
        got = convert._flatten(jtree)
        assert set(got) == set(want) and len(got) > 500
        for k in want:
            assert np.array_equal(got[k], want[k]), k
        assert config == {"n_fft": 256, "hop_length": 128, "nout": 32,
                          "nout_lstm": 128, "is_complex": False,
                          "arch": "CascadedNet"}

    # a third epoch from the state equals three epochs straight
    resumed = run(FLAGS + ["-d", dataset_dir, "-E", "3", "--output_dir", out,
                           "--resume", state], split_dir, monkeypatch)
    straight_out = str(straight_dir / "models")
    straight = run(FLAGS + ["-d", dataset_dir, "-E", "3", "--output_dir",
                            straight_out], straight_dir, monkeypatch)
    assert straight[:2] == log and resumed == straight[2:]
    a = torch.load(state, weights_only=True)
    b = torch.load(os.path.join(straight_out, checkpoint.STATE_NAME),
                   weights_only=True)
    for k, t in b["model"].items():
        assert torch.equal(a["model"][k], t), k
    with open(state + ".meta.json") as f:
        meta = json.load(f)
    assert meta["epoch"] == 2 and meta["step_counter"] == 3


@pytest.mark.parametrize("n", [2, 0])
def test_cli_data_parallel_in_a_world_of_one(n, dataset_dir, tmp_path,
                                             monkeypatch):
    """Without a launcher the world is this one process: a 2-rank mesh
    raises JAX's mesh assertion (before any file is written), and
    --data_parallel 0 trains on a mesh of one; neither leaves a process
    group behind. Multi-rank runs: tests/test_torch_parallel_serving.py."""
    import torch.distributed as dist

    argv = FLAGS + ["-d", dataset_dir, "-E", "1", "--output_dir",
                    str(tmp_path / "models"), "--data_parallel", str(n)]
    if n == 2:
        monkeypatch.chdir(tmp_path)
        with pytest.raises(AssertionError) as want:
            jmesh.make_mesh(n_data=2, devices=jax.devices()[:1])
        with pytest.raises(AssertionError) as got:
            cli.main(argv)
        assert str(got.value) == str(want.value)
        assert not os.listdir(tmp_path)
    else:
        log = run(argv, tmp_path, monkeypatch)
        assert len(log) == 1 and np.isfinite(log).all()
        with open(glob.glob(str(tmp_path / "train_*.log"))[0]) as f:
            assert "data-parallel mesh: {'data': 1, 'model': 1}" in f.read()
    assert not dist.is_initialized()


def test_cli_failure_exits_non_zero_and_is_logged(tmp_path):
    """JAX's root train.py logs a failure and exits 0; the port's CLI
    exits non-zero (here: a dataset directory that does not exist)."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run(
        [sys.executable, "-m", "vocal_remover_tpu_torch.cli.train", "-d",
         str(tmp_path / "missing"), "--gpu", "-1"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "FileNotFoundError" in r.stderr
    logs = glob.glob(str(tmp_path / "train_*.log"))
    with open(logs[0]) as f:
        assert "training failed" in f.read()


def test_cli_runs_on_the_card_unless_asked_for_the_cpu(dataset_dir, tmp_path,
                                                       monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-d", dataset_dir, "-E", "1"])


@pytest.mark.parametrize("n_fft,sr", [(2048, 44100), (256, 8000),
                                      (1024, 16000)])
def test_reduction_ramp_matches_jax(n_fft, sr):
    a, b = cli.reduction_weight_ramp(n_fft, sr, 0.2), jramp(n_fft, sr, 0.2)
    assert a.dtype == b.dtype and np.array_equal(a, b)
