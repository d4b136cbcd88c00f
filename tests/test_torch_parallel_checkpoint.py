"""GPU port, parallelism: the checkpoints of a trainer on CPU gloo worlds
of (data, model) = (2, 1) and (2, 2) ranks (rank 0 writes, shards
gathered: a one-process run's files; a state saved on the mesh loads
back into a fresh trainer on the mesh, which continues as the saved
one), and the device-resident dataset on the (2, 1) world against its
host path. JAX's `load_train_state` brings a state onto its mesh the
same way (train/checkpoint.py:77-82); neither needs a JAX computation
here. Each world is started once (tests/torch_parallel_worker.py)."""

import numpy as np
import pytest
import torch

from vocal_remover_tpu_torch.models.cascaded import CascadedNet
from vocal_remover_tpu_torch.train import checkpoint

import torch_parallel_worker as worker
from test_torch_parallel_adam import mags
from test_torch_parallel_grads import tiny_tree
from torch_port_helpers import TINY

torch.set_num_threads(1)

SHAPES = {(2, 1): ["checkpoint", "device_cache"], (2, 2): ["checkpoint"]}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    rng = np.random.default_rng(33)
    songs = []
    for frames in (300, 420, 350):
        X = np.abs(rng.standard_normal((2, 33, frames))).astype(np.float32)
        songs.append((X, (X * rng.uniform(0, 1, X.shape)).astype(np.float32)))
    patch_dir = tmp_path_factory.mktemp("patches")
    patches = []
    for i in range(5):  # batches of 3: one runs whole, one is split
        c = rng.standard_normal((2, 2, 33, 160)) + 0j
        patches.append(str(patch_dir / f"p{i}.npz"))
        np.savez(patches[-1], X=c[0].astype(np.complex64),
                 y=(c[0] * 0.5 + 0.1 * c[1]).astype(np.complex64))
    inputs = {"weights": {"config": TINY, "tree": tiny_tree(12)},
              "ckpt_batches": [mags(rng, 2, np.float32) for _ in range(2)],
              "songs": songs, "val_patches": patches}
    worlds = {s: worker.launch(tmp_path_factory.mktemp(f"w{s[0]}x{s[1]}"), s,
                               tasks, inputs)
              for s, tasks in SHAPES.items()}
    return {s: (w.join(timeout=240), w.tmp) for s, w in worlds.items()}


@pytest.mark.parametrize("shape", list(SHAPES), ids=lambda s: f"{s[0]}x{s[1]}")
def test_mesh_checkpoints(results, shape, tmp_path):
    """save_model on the mesh writes the arrays one process writes for
    the same state, byte for byte; a state saved on the mesh (.pt and
    the JAX package's .msgpack) loads into a fresh trainer on the mesh,
    which then takes the same step as the trainer that saved it."""
    out, world_dir = results[shape]
    saved, loss, state, resumed = out["checkpoint"]
    one = CascadedNet(*TINY)
    one.load_state_dict({k: torch.from_numpy(v) for k, v in saved.items()})
    checkpoint.save_model(str(tmp_path / "one.vrt.npz"), one)
    with np.load(world_dir / "mesh.vrt.npz") as a, \
            np.load(tmp_path / "one.vrt.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == \
                b[k].tobytes(), k
    for name, (epoch, best, r_loss, r_state) in resumed.items():
        assert (epoch, best) == (0, 1.0), name
        assert r_loss == loss, name
        for k, v in state.items():
            if name.endswith(".msgpack") and k.endswith("num_batches_tracked"):
                continue  # JAX's state has no such counter
            assert np.array_equal(r_state[k], v), (name, k)


def test_mesh_device_cache_matches_its_host_path(results):
    """On (2, 1): the device-resident epoch (each rank gathers its two
    rows of a batch of four) and validation give the host path's losses
    on the same mesh and batches."""
    out = results[(2, 1)][0]
    (dev_train, dev_val), (host_train, host_val) = out["device_cache"]
    assert out["device_cache_rows"].tolist() == [2]
    assert np.isfinite(dev_train) and dev_train > 0
    assert abs(dev_train - host_train) <= 1e-6 * host_train
    assert abs(dev_val - host_val) <= 1e-6 * host_val
