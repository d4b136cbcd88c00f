"""GPU port, the rest of training: `cli.train --resume` from a
`train_state.msgpack` (the JAX package's layout, written by the port's
writer from the CLI's `train_state.pt`) continues at the next epoch as
the resume from the `.pt` does, bit for bit; `--device_data_cache` and
`--transfer_dtype int8` with `--is_complex` fail with the JAX package's
reasons. On the CPU (`--gpu -1`), on the small setup of
test_torch_train_cli.py."""

import glob
import json
import os
import shutil

import pytest
import torch

from test_torch_train_cli import FLAGS, dataset_dir, run  # noqa: F401
from vocal_remover_tpu_torch.cli import train as cli
from vocal_remover_tpu_torch.models.cascaded import CascadedNet
from vocal_remover_tpu_torch.train import checkpoint
from vocal_remover_tpu_torch.train.plateau import ReduceLROnPlateau
from vocal_remover_tpu_torch.train.step import Trainer

torch.set_num_threads(1)


def test_cli_resumes_from_msgpack_as_from_pt(dataset_dir, tmp_path,
                                             monkeypatch):
    first = tmp_path / "first"
    first.mkdir()
    out = str(first / "models")
    run(FLAGS + ["-d", dataset_dir, "-E", "1", "--output_dir", out], first,
        monkeypatch)
    pt = os.path.join(out, checkpoint.STATE_NAME)

    # the .pt state through the port's writer into the flax layout
    trainer = Trainer(CascadedNet(256, 128, 32, 128), 1e-3, device="cpu")
    sched = ReduceLROnPlateau(lr=1e-3)
    epoch, best = checkpoint.load_train_state(pt, trainer, sched)
    mp = str(tmp_path / "train_state.msgpack")
    checkpoint.save_train_state(mp, trainer, sched, epoch, best)
    with open(pt + ".meta.json") as f, open(mp + ".meta.json") as g:
        assert json.load(f) == json.load(g)

    results = {}
    for name, state in (("pt", pt), ("msgpack", mp)):
        cwd = tmp_path / name
        cwd.mkdir()
        res_out = str(cwd / "models")
        shutil.copytree(out, res_out)
        log = run(FLAGS + ["-d", dataset_dir, "-E", "2", "--output_dir",
                           res_out, "--resume", state], cwd, monkeypatch)
        with open(glob.glob(str(cwd / "train_*.log"))[0]) as f:
            assert f"resumed from {state} at epoch 1" in f.read()
        results[name] = log, torch.load(
            os.path.join(res_out, checkpoint.STATE_NAME), weights_only=True)
    (log_pt, st_pt), (log_mp, st_mp) = results["pt"], results["msgpack"]
    assert len(log_pt) == 1 and log_mp == log_pt
    for k, t in st_pt["model"].items():
        # the JAX state keeps no num_batches_tracked (nothing reads it:
        # the momentum is fixed)
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(st_mp["model"][k], t), k
    # Adam's state; the msgpack resume also holds the zero moments of
    # aux_out, which no gradient reaches without --aux_lambda
    adam_pt, adam_mp = (st["optimizer"]["state"] for st in (st_pt, st_mp))
    assert len(adam_pt) > 100 and set(adam_pt) <= set(adam_mp)
    for i, a in adam_pt.items():
        assert all(torch.equal(a[k], adam_mp[i][k]) for k in a), i


@pytest.mark.parametrize("argv,reason", [
    (["--device_data_cache"], "complex-mask training needs the host path"),
    (["--transfer_dtype", "int8"], "int8 staging quantizes nonnegative"),
], ids=["device_cache", "int8"])
def test_cli_refuses_complex(argv, reason, dataset_dir, tmp_path,
                             monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match=reason):
        cli.main(FLAGS + ["-d", dataset_dir, "-E", "1", "--is_complex",
                          "--output_dir", str(tmp_path / "m")] + argv)
