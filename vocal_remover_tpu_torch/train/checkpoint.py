"""Training-state checkpoints (atomic, resumable) and model checkpoints.

Counterpart of vocal_remover_tpu/train/checkpoint.py. The full training
state (the model's parameters and BatchNorm statistics, Adam's state and
learning rate) is one file with the JAX package's `.meta.json` beside it
(epoch, best loss, step counter, plateau scheduler); both are written
atomically. The file is told by its suffix: `train_state.pt` (what the
CLI writes) is a `torch.save` of the state dicts; a `.msgpack` is the
JAX package's flax state (train/flax_state.py), so a run started under
the JAX package continues here, and the other way. `save_model` writes
the native `.vrt.npz` that inference (and the JAX package's
`convert.load_native`) loads.

Under a mesh (parallel/mesh.py) every rank calls these: the saves gather
the model axis's shards (a collective) and rank 0 alone writes, so the
files are a one-process run's; `load_train_state` reads on rank 0,
broadcasts the bytes, and every rank keeps its shards of them.
"""

from __future__ import annotations

import io
import json
import os
import tempfile

import torch
import torch.distributed as dist

from vocal_remover_tpu_torch.models import convert
from vocal_remover_tpu_torch.parallel import distributed, policy
from vocal_remover_tpu_torch.train import flax_state

STATE_NAME = "train_state.pt"


def _atomic_write(path: str, data: bytes):
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _is_flax(path: str) -> bool:
    return path.endswith(".msgpack")


def save_train_state(path: str, trainer, scheduler, epoch: int,
                     best_loss: float, extra: dict | None = None):
    """Write the trainer's and scheduler's state to `path` (a `.msgpack`
    path: the JAX package's layout) and its meta (epoch, best loss, step
    counter, scheduler, `extra`) to `path + ".meta.json"`; under a mesh
    every rank enters and rank 0 writes."""
    with policy.unsharded(trainer.model, trainer.optimizer):
        if not distributed.is_writer():
            return
        if _is_flax(path):
            blob = flax_state.state_bytes(trainer)
        else:
            buf = io.BytesIO()
            torch.save({"model": trainer.model.state_dict(),
                        "optimizer": trainer.optimizer.state_dict()}, buf)
            blob = buf.getvalue()
    meta = {
        "epoch": epoch,
        "best_loss": best_loss,
        "step_counter": trainer._step_counter,
        "scheduler": scheduler.state_dict(),
        "extra": extra or {},
    }
    _atomic_write(path, blob)
    _atomic_write(path + ".meta.json", json.dumps(meta).encode())


def _read(path: str, mesh):
    """(state bytes, meta dict): read here, or under a mesh read on rank
    0 and broadcast to every rank."""
    got = [None, None]
    if mesh is None or distributed.is_writer():
        with open(path, "rb") as f:
            got[0] = f.read()
        with open(path + ".meta.json") as f:
            got[1] = json.load(f)
    if mesh is not None:
        dist.broadcast_object_list(got, src=0)
    return got


def load_train_state(path: str, trainer, scheduler):
    """Restore a trainer and scheduler in place from either format;
    returns (epoch, best_loss) of the saved epoch."""
    blob, meta = _read(path, getattr(trainer, "mesh", None))
    with policy.unsharded(trainer.model, trainer.optimizer):
        if _is_flax(path):
            flax_state.load(trainer, blob)
        else:
            # on the CPU: load_state_dict moves each tensor to its
            # parameter's device, and keeps Adam's step counts on the
            # host as Adam makes them
            state = torch.load(io.BytesIO(blob), map_location="cpu",
                               weights_only=True)
            trainer.model.load_state_dict(state["model"])
            trainer.optimizer.load_state_dict(state["optimizer"])
    scheduler.load_state_dict(meta["scheduler"])
    trainer._step_counter = meta["step_counter"]
    return meta["epoch"], meta["best_loss"]


def save_model(path: str, model):
    """Model-only checkpoint in the native format (what inference loads)."""
    with policy.unsharded(model):
        if distributed.is_writer():
            convert.save_native(path, convert.to_jax_variables(model),
                                convert.model_config(model))
