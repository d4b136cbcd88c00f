"""One rank of a CPU gloo world for the GPU port's parallel tests
(tests/test_torch_parallel_*.py), and the launcher the tests use.

    python tests/torch_parallel_worker.py DIR RANK WORLD N_DATA N_MODEL TASK...

A world joins through a file store in DIR (no ports), reads DIR/inputs.pkl
(numpy weights and batches written by the test), runs each TASK on a
(N_DATA, N_MODEL) mesh and writes its results to DIR/rank<RANK>.pkl. It
imports torch and the port only; the JAX references are computed in the
pytest process.
"""

import os
import pickle
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def launch(tmp, shape, tasks, inputs):
    """Start a world of n_data x n_model ranks running `tasks` on
    `inputs` (a dict pickled into `tmp`); returns a `World` to `join`."""
    n_data, n_model = shape
    world = n_data * n_model
    os.makedirs(tmp, exist_ok=True)
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = []
    for r in range(world):
        log = open(os.path.join(tmp, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(tmp), str(r),
             str(world), str(n_data), str(n_model), *tasks],
            env=env, stdout=log, stderr=subprocess.STDOUT), log))
    return World(tmp, procs)


class World:
    def __init__(self, tmp, procs):
        self.tmp, self.procs = tmp, procs

    def join(self, timeout=120.0):
        """Wait for every rank (each wait bounded by what is left of
        `timeout`); on a failure or a hang kill them all and raise with
        the ranks' logs. Returns rank 0's results."""
        deadline = time.monotonic() + timeout
        try:
            for p, _ in self.procs:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            pass
        failed = [p.returncode for p, _ in self.procs]
        for p, log in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
        if any(rc != 0 for rc in failed):
            logs = []
            for r in range(len(self.procs)):
                with open(os.path.join(self.tmp, f"rank{r}.log")) as f:
                    logs.append(f"--- rank {r} (rc {failed[r]}):\n"
                                + f.read()[-3000:])
            raise AssertionError("world failed:\n" + "\n".join(logs))
        with open(os.path.join(self.tmp, "rank0.pkl"), "rb") as f:
            return pickle.load(f)


# ----------------------------------------------------------------------
# the ranks' side
# ----------------------------------------------------------------------

def _model(weights, dtype):
    import torch

    from vocal_remover_tpu_torch.models import convert
    from vocal_remover_tpu_torch.models.cascaded import CascadedNet

    model = convert.from_jax_variables(CascadedNet(*weights["config"]),
                                       weights["tree"])
    return model.to(dtype)


def _full_state(model):
    """The model's whole state dict as numpy (shards gathered)."""
    from vocal_remover_tpu_torch.parallel import policy

    with policy.unsharded(model):
        return {k: v.detach().clone().numpy()
                for k, v in model.state_dict().items()}


def task_grads(mesh, inp, out):
    """float64 compute_grads on the mesh; the model's state must be left
    as it was; the sharded leaves counted."""
    import torch

    from vocal_remover_tpu_torch.nn import config
    from vocal_remover_tpu_torch.train.step import Trainer

    config.set_compute_dtype(torch.float64)
    try:
        model = _model(inp["weights"], torch.float64)
        trainer = Trainer(model, 1e-3, dropout=False, device="cpu",
                          mesh=mesh)
        before = _full_state(model)
        X, y = inp["grads_batch"]
        loss, grads = trainer.compute_grads(X, y)
        after = _full_state(model)
        out["grads"] = (loss, {k: g.numpy() for k, g in grads.items()})
        out["grads_state_kept"] = all(
            (before[k] == after[k]).all() for k in before)
        out["sharded"] = len(getattr(model, "_tp_leaves", ()))
    finally:
        config.set_compute_dtype(torch.float32)


def task_validate(mesh, inp, out):
    """float32 validate_epoch (a batch that does not divide by the data
    axis among them)."""
    import torch

    from vocal_remover_tpu_torch.train.step import Trainer

    model = _model(inp["weights"], torch.float32)
    trainer = Trainer(model, 1e-3, device="cpu", mesh=mesh)
    out["validate"] = trainer.validate_epoch(inp["val_batches"])


def task_adam(mesh, inp, out):
    """Four float64 Adam steps: the losses, then every parameter and BN
    statistic (shards gathered)."""
    import torch

    from vocal_remover_tpu_torch.nn import config
    from vocal_remover_tpu_torch.train.step import Trainer

    config.set_compute_dtype(torch.float64)
    try:
        model = _model(inp["weights"], torch.float64)
        trainer = Trainer(model, 1e-3, dropout=False, device="cpu",
                          mesh=mesh)
        losses = [trainer.train_epoch([b]) for b in inp["adam_batches"]]
        out["adam"] = (losses, _full_state(model))
    finally:
        config.set_compute_dtype(torch.float32)


def task_checkpoint(mesh, inp, out):
    """save_model and save_train_state / load_train_state on the mesh:
    rank 0 writes (shards gathered), a fresh trainer on the mesh loads
    the state and continues as the saved one does."""
    import torch

    from vocal_remover_tpu_torch.train import checkpoint
    from vocal_remover_tpu_torch.train.plateau import ReduceLROnPlateau
    from vocal_remover_tpu_torch.train.step import Trainer

    tmp = inp["dir"]
    b1, b2 = inp["ckpt_batches"]
    model = _model(inp["weights"], torch.float32)
    trainer = Trainer(model, 1e-3, dropout=False, device="cpu", mesh=mesh)
    trainer.train_epoch([b1])
    checkpoint.save_model(os.path.join(tmp, "mesh.vrt.npz"), model)
    saved = _full_state(model)
    sched = ReduceLROnPlateau(lr=1e-3)
    state = os.path.join(tmp, "mesh_state.pt")
    checkpoint.save_train_state(state, trainer, sched, 0, 1.0)
    checkpoint.save_train_state(os.path.join(tmp, "mesh_state.msgpack"),
                                trainer, sched, 0, 1.0)
    torch.distributed.barrier()  # rank 0 has written
    resumed = {}
    for name in ("mesh_state.pt", "mesh_state.msgpack"):
        other = Trainer(_model(inp["weights"], torch.float32), 1e-3,
                        dropout=False, device="cpu", mesh=mesh)
        epoch, best = checkpoint.load_train_state(
            os.path.join(tmp, name), other, ReduceLROnPlateau(lr=1e-3))
        resumed[name] = (epoch, best, other.train_epoch([b2]),
                         _full_state(other.model))
    out["checkpoint"] = (saved, trainer.train_epoch([b2]),
                         _full_state(model), resumed)


def task_device_cache(mesh, inp, out):
    """A device-resident epoch and validation on the mesh against the
    host path on the same mesh, fed the same batches."""
    import numpy as np
    import torch

    from vocal_remover_tpu_torch.data.device_cache import (
        DeviceLoader,
        DeviceTrainingSource,
        DeviceValidationSource,
    )
    from vocal_remover_tpu_torch.train.step import Trainer

    songs, patches = inp["songs"], inp["val_patches"]
    kw = dict(cropsize=160, patches=2, reduction_rate=0.5, seed=3,
              dtype=torch.float32, device="cpu")
    src = DeviceTrainingSource.from_magnitudes(songs, mesh=mesh, **kw)
    host_src = DeviceTrainingSource.from_magnitudes(songs, **kw)
    loader = DeviceLoader(src, batchsize=4, shuffle=True, seed=5)
    host_batches = []
    for idx in DeviceLoader(host_src, batchsize=4, shuffle=True, seed=5):
        X, y = host_src.gather(*idx)
        host_batches.append((X.numpy(), y.numpy()))
    val = DeviceValidationSource(patches, dtype=torch.float32, device="cpu",
                                 mesh=mesh)
    dev = Trainer(_model(inp["weights"], torch.float32), 1e-3, device="cpu",
                  mesh=mesh)
    host = Trainer(_model(inp["weights"], torch.float32), 1e-3,
                   device="cpu", mesh=mesh)
    out["device_cache"] = (
        (dev.train_epoch_device(src, loader), dev.validate_epoch_device(
            val, 3)),
        (host.train_epoch(host_batches), host.validate_epoch(
            _val_batches(patches, 3))))
    out["device_cache_rows"] = np.asarray(
        [src.gather(*src.index_batch(np.arange(4)))[0].shape[0]])


def _val_batches(patches, bs):
    import numpy as np

    Xs, ys = [], []
    for p in patches:
        with np.load(p) as d:
            Xs.append(np.abs(d["X"]).astype(np.float32))
            ys.append(np.abs(d["y"]).astype(np.float32))
    return [(np.stack(Xs[i:i + bs]), np.stack(ys[i:i + bs]))
            for i in range(0, len(Xs), bs)]


def task_separate(mesh, inp, out):
    """Separator(mesh=).separate_wave, float and PCM16, with and
    without TTA."""
    import torch

    from vocal_remover_tpu_torch.separate.separator import Separator

    sp = Separator(_model(inp["weights"], torch.float32), batchsize=2,
                   cropsize=256, device="cpu", mesh=mesh)
    wave = inp["wave"]
    out["separate"] = sp.separate_wave(wave)
    out["separate_pcm16"] = sp.separate_wave(wave, pcm16_io=True)
    out["separate_tta"] = sp.separate_wave(wave, tta=True, pcm16_io=True)


def main(argv):
    tmp, rank, world, n_data, n_model = argv[:5]
    rank, world, n_data, n_model = map(int, (rank, world, n_data, n_model))
    import torch

    torch.set_num_threads(1)
    from vocal_remover_tpu_torch.parallel import distributed
    from vocal_remover_tpu_torch.parallel import mesh as mesh_lib

    with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    inp["dir"] = tmp
    distributed.initialize(f"file://{os.path.join(tmp, 'store')}", world,
                           rank, device="cpu")
    try:
        mesh = mesh_lib.make_mesh(n_data, n_model)
        out = {}
        for task in argv[5:]:
            globals()[f"task_{task}"](mesh, inp, out)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main(sys.argv[1:])
