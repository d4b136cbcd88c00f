"""GPU port, parallelism on the serving and CLI paths, on CPU gloo worlds
of two ranks: `Separator(mesh=).separate_wave` (sequence parallelism)
against the JAX package's `Separator(mesh=make_mesh())` and against one
process; `cli.inference --data_parallel 2 --gpu -1` (a single file and
--input_dir) and `cli.train --data_parallel 2 --gpu -1 -E 1` launched by
torch.distributed.run against the same CLIs in one process: the same
stems and losses, and one set of output files, written by rank 0.

The three launches and the world of the Separator run side by side,
started once for the file; the references are computed here meanwhile.
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vocal_remover_tpu.models.cascaded import CascadedNet as JCascadedNet
from vocal_remover_tpu.parallel import mesh as jmesh
from vocal_remover_tpu.separate.separator import Separator as JSeparator
from vocal_remover_tpu_torch.cli import inference as inference_cli
from vocal_remover_tpu_torch.cli import train as train_cli
from vocal_remover_tpu_torch.models import convert
from vocal_remover_tpu_torch.models.cascaded import CascadedNet
from vocal_remover_tpu_torch.separate.separator import Separator
from vocal_remover_tpu_torch.utils import audio

import torch_parallel_worker as worker
from test_torch_parallel_grads import tiny_tree
from torch_port_helpers import TINY, max_lsb

torch.set_num_threads(1)

SR = 8000
INFER = ["-r", str(SR), "-f", "64", "-H", "32", "-c", "256", "-B", "2",
         "--precision", "highest", "--gpu", "-1"]
# one optimizer step an epoch: in float32 a mesh's gradients differ from
# one process's in the last digits, and Adam's step on the ~zero ones
# then moves later losses by more than 1e-6 (float64: test_torch_
# parallel_adam.py holds four steps to 1e-8)
TRAIN = ["--gpu", "-1", "--sr", str(SR), "-f", "256", "-H", "128", "-C",
         "256", "-B", "2", "-p", "1", "-v", "0.34", "-w", "2", "-b", "2",
         "-E", "1"]


def _song(seconds, k):
    rng = np.random.default_rng(40 + k)
    t = np.arange(int(SR * seconds)) / SR
    inst = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 300) * t) \
        + 0.05 * rng.standard_normal(t.size)
    voc = 0.2 * np.sin(2 * np.pi * rng.uniform(400, 900) * t)
    inst = np.stack([inst, 0.9 * inst])
    return inst.astype(np.float32), (inst + voc).astype(np.float32)


def _torchrun(module, argv, cwd):
    env = dict(os.environ, PYTHONPATH=worker.ROOT, OMP_NUM_THREADS="1")
    log = open(os.path.join(cwd, "launch.log"), "w")
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", module, *argv, "--data_parallel",
         "2"], cwd=cwd, env=env, stdout=log, stderr=subprocess.STDOUT), log


def _wait(launch, timeout=240):
    proc, log = launch
    try:
        proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    with open(log.name) as f:
        text = f.read()
    assert proc.returncode == 0, text[-4000:]
    return text


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel_serving")
    tree = tiny_tree(13)
    ckpt = str(root / "tiny.vrt.npz")
    model = convert.from_jax_variables(CascadedNet(*TINY), tree)
    convert.save_native(ckpt, tree, convert.model_config(model))
    songs = root / "songs"
    data = root / "data"
    for sub in ("", "mixtures", "instruments"):
        (data / sub).mkdir(parents=True, exist_ok=True)
    songs.mkdir()
    for k, (name, seconds) in enumerate((("b", 2.0), ("a", 1.0),
                                         ("c", 2.5))):
        inst, mix = _song(seconds, k)
        audio.write_wav(str(songs / f"{name}.wav"), mix, SR)
    for k, name in enumerate(("one", "two", "three")):
        inst, mix = _song(5.0, 10 + k)
        audio.write_wav(str(data / "instruments" / f"{name}.wav"), inst, SR)
        audio.write_wav(str(data / "mixtures" / f"{name}.wav"), mix, SR)
    wave = (np.random.default_rng(7).standard_normal((2, 32 * 4000))
            * 0.3).astype(np.float32)
    dirs = {k: root / k for k in ("single", "dir", "train", "train1",
                                  "train0")}
    for d in dirs.values():
        d.mkdir()
    single = INFER + ["-P", ckpt, "-i", str(songs / "b.wav"), "-o", "out"]
    batch = INFER + ["-P", ckpt, "--input_dir", str(songs), "-o", "out"]
    train = TRAIN + ["-d", str(data), "--output_dir", "models"]
    launches = {
        "world": worker.launch(root / "world", (2, 1), ["separate"], {
            "weights": {"config": TINY, "tree": tree}, "wave": wave}),
        "single": _torchrun("vocal_remover_tpu_torch.cli.inference", single,
                            dirs["single"]),
        "dir": _torchrun("vocal_remover_tpu_torch.cli.inference", batch,
                         dirs["dir"]),
        "train": _torchrun("vocal_remover_tpu_torch.cli.train", train,
                           dirs["train"]),
    }
    try:
        jsp = JSeparator(JCascadedNet(*TINY), tree, batchsize=2,
                         cropsize=256, mesh=jmesh.make_mesh())
        want = {"jax": jsp.separate_wave(wave)}
        sp = Separator(model, batchsize=2, cropsize=256, device="cpu")
        want["pcm16"] = sp.separate_wave(wave, pcm16_io=True)
        want["tta"] = sp.separate_wave(wave, tta=True, pcm16_io=True)
        cwd = os.getcwd()
        try:
            os.chdir(root)
            inference_cli.main(single[:-1] + [str(root / "one_single")])
            inference_cli.main(batch[:-1] + [str(root / "one_dir")])
            os.chdir(dirs["train1"])
            train_cli.main(train)
            os.chdir(dirs["train0"])  # a mesh of one: this one process
            train_cli.main(train + ["--data_parallel", "0"])
        finally:
            os.chdir(cwd)
    finally:
        got = {"world": launches.pop("world").join(timeout=240)}
        got.update({k: _wait(v) for k, v in launches.items()})
    return root, dirs, want, got


def test_sequence_parallel_separation_matches_jax_and_one_process(runs):
    """Two ranks, each its share of the patch stream in chunks of 2: the
    float stems within JAX's own mesh bound of JAX's mesh separation
    (atol 2e-4, tests/test_sharding.py), the PCM16 stems (also with TTA)
    within 1 LSB of one process's."""
    _, _, want, got = runs
    out = got["world"]
    for a, b in zip(out["separate"], want["jax"]):
        np.testing.assert_allclose(a, b, atol=2e-4)
    for key, ref in (("separate_pcm16", want["pcm16"]),
                     ("separate_tta", want["tta"])):
        for a, b in zip(out[key], ref):
            assert a.dtype == np.int16 and a.shape == b.shape
            assert max_lsb(a, b) <= 1, key


def _stems(d):
    return sorted(os.listdir(d))


@pytest.mark.parametrize("mode", ["single", "dir"])
def test_cli_inference_data_parallel_writes_one_process_stems(runs, mode):
    """`--data_parallel 2` under torchrun writes the stems of the run
    without the flag (within 1 LSB), once: rank 0 alone writes and
    prints the `done` lines."""
    root, dirs, _, got = runs
    out, one = dirs[mode] / "out", root / f"one_{mode}"
    assert _stems(out) == _stems(one) and len(_stems(one)) in (2, 6)
    for name in _stems(one):
        a, sr = audio.read_wav(str(out / name))
        b, _ = audio.read_wav(str(one / name))
        assert sr == SR and a.shape == b.shape
        assert max_lsb(np.round(a * 32768), np.round(b * 32768)) <= 1, name
    if mode == "dir":
        for name in ("a", "b", "c"):
            assert got[mode].count(f"{name} done") == 1


def _losses(d):
    with open(glob.glob(str(d / "loss_*.json"))[0]) as f:
        return np.array(json.load(f))


def test_cli_train_data_parallel_matches_one_process(runs):
    """`cli.train --data_parallel 2 -E 1`: one set of files (rank 0
    writes the log, the loss and validation lists and the checkpoints),
    and the losses of the same run in one process (`--data_parallel 0`,
    a mesh of one) within 1e-6 relative. Against the run without a mesh
    the training loss (taken before the step) is within 1e-6 too; the
    validation loss, after one Adam step, within 1e-5: the two programs
    compute float32 batch norm statistics differently (torch's kernel;
    float64 sums over the mesh), the last-digit difference flips a few
    ReLU branches and so the sign of Adam's step on the ~zero gradients
    (2e-6 here, for a mesh of one as for two)."""
    _, dirs, _, _ = runs
    mesh_dir = dirs["train"]
    names = sorted(n for n in os.listdir(mesh_dir) if n != "launch.log")
    assert [n.split("_")[0] for n in names] == [
        "cs256", "loss", "models", "train", "val"]
    assert sorted(os.listdir(mesh_dir / "models")) == [
        "model_iter0.vrt.npz", "train_state.pt", "train_state.pt.meta.json"]
    got, one, plain = (_losses(dirs[k]) for k in ("train", "train0",
                                                   "train1"))
    assert got.shape == one.shape == plain.shape == (1, 2)
    np.testing.assert_allclose(got, one, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got[:, 0], plain[:, 0], rtol=1e-6, atol=0)
    np.testing.assert_allclose(got[:, 1], plain[:, 1], rtol=1e-5, atol=0)
    with open(glob.glob(str(mesh_dir / "train_*.log"))[0]) as f:
        assert "data-parallel mesh: {'data': 2, 'model': 1}" in f.read()
