"""GPU port, the rest of training: the port's msgpack codec against
flax.serialization, and the JAX package's `train_state.msgpack` read
into the port's Trainer (and written by it) bit for bit, on JAX's tiny
configuration. The port imports neither flax nor msgpack."""

import ast
import os

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from torch_port_helpers import TINY, tiny_batch, tiny_weights
from vocal_remover_tpu.models.cascaded import CascadedNet as JCascadedNet
from vocal_remover_tpu.train import checkpoint as jcheckpoint
from vocal_remover_tpu.train.plateau import ReduceLROnPlateau as JPlateau
from vocal_remover_tpu.train.step import Trainer as JTrainer
from vocal_remover_tpu_torch.models import convert
from vocal_remover_tpu_torch.models.cascaded import CascadedNet
from vocal_remover_tpu_torch.train import checkpoint, flax_state
from vocal_remover_tpu_torch.train.plateau import ReduceLROnPlateau
from vocal_remover_tpu_torch.train.step import Trainer

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree():
    rng = np.random.default_rng(5)
    return {
        "f32": rng.standard_normal((3, 4)).astype(np.float32),
        "f64": rng.standard_normal(7),
        "i32": np.arange(-5, 5, dtype=np.int32).reshape(2, 5),
        "u8": np.arange(256, dtype=np.uint8),
        "bool": np.array([True, False]),
        "scalar0d": np.asarray(3, np.int32),
        "empty": np.zeros((0, 3), np.float32),
        "npscalar": np.float32(1.5),
        "npint": np.int64(-7),
        "complex": complex(1.25, -2.5),
        "nested": {"a": {"b": np.ones((2, 2, 2), np.float16)}, "c": {}},
        "ints": {"small": 5, "neg": -3, "u8": 200, "u16": 60000,
                 "u32": 2**31, "u64": 2**40, "i8": -100, "i16": -30000,
                 "i32": -2**31, "i64": -2**40},
        "float": 0.1,
        "bool_py": True,
        "none": None,
        "str": "x" * 40,
        "long_str": "y" * 300,
        "bytes": b"\x00\x01" * 200,
        "list": [1, "two", 3.0],
        "wide_map": {str(i): i for i in range(20)},
    }


def _equal(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    elif isinstance(a, np.generic):
        assert type(a) is type(b) and a.tobytes() == b.tobytes()
    else:
        assert type(a) is type(b) and a == b, (a, b)


def test_codec_bytes_equal_flax_and_round_trip():
    tree = _tree()
    # in place: flax's copy (jax.tree_util.tree_map) would sort the keys
    want = serialization.msgpack_serialize(_tree(), in_place=True)
    got = flax_state.msgpack_serialize(tree)
    assert got == want
    _equal(flax_state.msgpack_restore(want),
           serialization.msgpack_restore(want))
    _equal(flax_state.msgpack_restore(got), tree)


def test_codec_chunked_arrays(monkeypatch):
    """flax splits arrays over MAX_CHUNK_SIZE bytes (2**30) into chunk
    maps; with the limit made small in both, the bytes and the restored
    arrays agree."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(flax_state, "MAX_CHUNK_SIZE", 64)
    a = np.arange(100, dtype=np.float32).reshape(4, 25)
    tree = {"big": a, "inner": {"big": a[:2].astype(np.float64) * 2},
            "small": np.ones(3, np.float32)}
    want = serialization.msgpack_serialize(
        {k: (dict(v) if isinstance(v, dict) else v) for k, v in tree.items()},
        in_place=True)
    got = flax_state.msgpack_serialize(tree)
    assert got == want
    assert b"__msgpack_chunked_array__" in got
    for blob in (got, want):
        _equal(flax_state.msgpack_restore(blob),
               serialization.msgpack_restore(blob))
        _equal(flax_state.msgpack_restore(blob), tree)


def test_codec_refuses_malformed():
    with pytest.raises(ValueError):
        flax_state.unpackb(flax_state.packb({"a": 1})[:-1])
    with pytest.raises(ValueError):
        flax_state.unpackb(flax_state.packb(1) + b"\x00")
    with pytest.raises(TypeError):
        flax_state.packb({"a": object()})


def _jax_state(tmp_path, steps=2):
    """A JAX Trainer on the tiny net (float32, dropout off) after `steps`
    Adam steps at lr 3e-3, saved by JAX's save_train_state."""
    w = tiny_weights(21)
    jt = JTrainer(JCascadedNet(*TINY), w, learning_rate=3e-3, dropout=False)
    X, y = (a.astype(np.float32) for a in tiny_batch())
    jt.train_epoch([(X, y)] * steps)
    sched = JPlateau(lr=3e-3)
    sched.step(0.5)
    path = str(tmp_path / "train_state.msgpack")
    jcheckpoint.save_train_state(path, jt, sched, epoch=4, best_loss=0.5)
    return w, jt, path


def _port_trainer(weights=None, lr=1e-3):
    model = CascadedNet(*TINY)
    if weights is not None:
        convert.from_jax_variables(model, weights)
    return Trainer(model, learning_rate=lr, dropout=False, device="cpu")


def _port_adam_as_jax(trainer):
    """{"mu": flat, "nu": flat} of the port's Adam state in JAX paths and
    layouts (zeros where Adam has not stepped a parameter: aux_out without
    aux_lambda gets no gradient), and the set of steps."""
    out, steps = {"mu": {}, "nu": {}}, set()
    for name, p in trainer.model.named_parameters():
        st = trainer.optimizer.state[p]
        path = "/".join(convert._jax_path(name))
        for k, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            out[k][path] = convert._to_jax_layout(
                st.get(key, torch.zeros_like(p)).detach().numpy())
        if "step" in st:
            steps.add(int(st["step"]))
    return out, steps


def test_jax_state_loads_bit_for_bit(tmp_path):
    _, jt, path = _jax_state(tmp_path)
    trainer = _port_trainer()
    sched = ReduceLROnPlateau(lr=1e-3)
    epoch, best = checkpoint.load_train_state(path, trainer, sched)
    assert (epoch, best) == (4, 0.5)
    assert trainer._step_counter == 2
    assert sched.state_dict() == JPlateau(lr=3e-3).state_dict() | {
        "best": 0.5}
    assert trainer.learning_rate == float(np.float32(3e-3))

    got = convert._flatten(convert.to_jax_variables(trainer.model))
    want = convert._flatten(jt.variables)
    assert set(got) == set(want) and len(got) > 100
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    adam, steps = _port_adam_as_jax(trainer)
    inner = jt.opt_state.inner_state[0]
    assert steps == {int(inner.count)} == {2}
    for name in ("mu", "nu"):
        ref = convert._flatten(jax.tree_util.tree_map(
            np.asarray, getattr(inner, name)))
        assert set(adam[name]) == set(ref)
        for k in ref:
            assert adam[name][k].dtype == np.float32
            assert np.array_equal(adam[name][k], ref[k]), (name, k)


def test_port_writer_restores_in_jax_bit_for_bit(tmp_path):
    """The port's state (two Adam steps on the CPU), written as
    .msgpack, restores into JAX's Trainer through its load_train_state;
    and the port reads its own file back to the same state."""
    trainer = _port_trainer(tiny_weights(22), lr=2e-3)
    X, y = (a.astype(np.float32) for a in tiny_batch())
    trainer.train_epoch([(X, y)] * 2)
    sched = ReduceLROnPlateau(lr=2e-3)
    path = str(tmp_path / "train_state.msgpack")
    checkpoint.save_train_state(path, trainer, sched, epoch=1, best_loss=0.7)

    jt = JTrainer(JCascadedNet(*TINY), tiny_weights(3), learning_rate=1e-3,
                  dropout=False)
    assert jcheckpoint.load_train_state(path, jt, JPlateau(lr=1e-3)) == (1, 0.7)
    assert jt._step_counter == 2
    assert abs(jt.learning_rate - 2e-3) < 1e-10
    want = convert._flatten(convert.to_jax_variables(trainer.model))
    got = convert._flatten(jax.tree_util.tree_map(np.asarray, jt.variables))
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    adam, _ = _port_adam_as_jax(trainer)
    inner = jt.opt_state.inner_state[0]
    assert int(inner.count) == 2 and int(jt.opt_state.count) == 2
    for name in ("mu", "nu"):
        ref = convert._flatten(jax.tree_util.tree_map(
            np.asarray, getattr(inner, name)))
        for k in ref:
            assert np.array_equal(adam[name][k], ref[k]), (name, k)

    again = _port_trainer()
    checkpoint.load_train_state(path, again, ReduceLROnPlateau(lr=1e-3))
    for (k, a), b in zip(trainer.model.state_dict().items(),
                         again.model.state_dict().values()):
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(a, b), k
    adam2, steps2 = _port_adam_as_jax(again)
    assert steps2 == {2}
    for name in ("mu", "nu"):
        for k in adam[name]:
            assert np.array_equal(adam[name][k], adam2[name][k])


def test_state_refuses_other_adam(tmp_path):
    _, _, path = _jax_state(tmp_path, steps=1)
    with open(path, "rb") as f:
        state = serialization.msgpack_restore(f.read())
    state["opt_state"]["hyperparams"]["b1"] = np.asarray(0.8, np.float32)
    with pytest.raises(ValueError, match="b1"):
        flax_state.load(_port_trainer(), serialization.msgpack_serialize(
            state))


def test_port_imports_no_flax_or_msgpack():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "vocal_remover_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import)
                     else [node.module] if isinstance(node, ast.ImportFrom)
                     and node.module else [])
            for mod in names:
                assert mod.split(".")[0] not in ("flax", "msgpack", "optax"), (
                    f"{os.path.relpath(path, ROOT)} imports {mod}")
