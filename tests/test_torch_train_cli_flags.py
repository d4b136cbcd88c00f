"""GPU port, the rest of training: `cli.train` on the CPU (`--gpu -1`)
with each flag of this slice, alone and combined, on the small setup of
test_torch_train_cli.py: every epoch's losses finite, the model
checkpoint and the train state written, the log naming the mode."""

import glob
import os

import numpy as np
import pytest
import torch

from test_torch_train_cli import FLAGS, dataset_dir, run  # noqa: F401
from vocal_remover_tpu_torch.data import device_cache
from vocal_remover_tpu_torch.nn import config
from vocal_remover_tpu_torch.train import checkpoint

torch.set_num_threads(1)


@pytest.mark.parametrize("argv,logged", [
    (["--remat"], "batch staging dtype: float32"),
    (["--precision", "bfloat16"], "batch staging dtype: bfloat16"),
    (["--transfer_dtype", "int8"], "batch staging dtype: int8"),
    (["--device_data_cache"], "device-resident dataset: 1 songs"),
    (["--remat", "--precision", "bfloat16", "--device_data_cache"],
     "device-resident validation"),
], ids=["remat", "bf16", "int8", "device_cache", "combined"])
def test_cli_trains_with_flag(argv, logged, dataset_dir, tmp_path,
                              monkeypatch):
    monkeypatch.setattr(device_cache, "_RESIDENT_BYTES", 0)
    out = str(tmp_path / "models")
    try:
        log = run(FLAGS + ["-d", dataset_dir, "-E", "1", "--output_dir", out]
                  + argv, tmp_path, monkeypatch)
    finally:
        config.set_precision("highest")
    assert len(log) == 1 and np.isfinite(log).all() and log[0][1] > 0
    assert glob.glob(os.path.join(out, "model_iter0.vrt.npz"))
    state = os.path.join(out, checkpoint.STATE_NAME)
    assert os.path.exists(state) and os.path.exists(state + ".meta.json")
    with open(glob.glob(str(tmp_path / "train_*.log"))[0]) as f:
        assert logged in f.read()
