"""GPU port, the rest of training: a JAX `train_state.msgpack` (two Adam
steps of JAX's tiny configuration in float32) resumed by the port and by
the JAX package, then one more step each in float64 with dropout off on
the same batch: every parameter and BN statistic within 1e-9 of its
leaf's largest |value| of JAX's, Adam's moments too, except that a
moment whose gradient is zero in exact arithmetic (the dense head's bias
feeds a batch norm: cancellation residue, as in check_grads_match_jax)
is held to 1e-12 of the largest |value| of that moment over the model.
A file of its own:
a float64 JAX compile takes about half a minute on the CPU."""

import jax
import numpy as np
import pytest
import torch

from torch_port_helpers import (  # noqa: F401
    TINY,
    float64_mode,
    tiny_batch,
    tiny_weights,
)
from vocal_remover_tpu.models.cascaded import CascadedNet as JCascadedNet
from vocal_remover_tpu.train import checkpoint as jcheckpoint
from vocal_remover_tpu.train.plateau import ReduceLROnPlateau as JPlateau
from vocal_remover_tpu.train.step import Trainer as JTrainer
from vocal_remover_tpu_torch.models import convert
from vocal_remover_tpu_torch.models.cascaded import CascadedNet
from vocal_remover_tpu_torch.train import checkpoint
from vocal_remover_tpu_torch.train.plateau import ReduceLROnPlateau
from vocal_remover_tpu_torch.train.step import Trainer

torch.set_num_threads(1)

RTOL = 1e-9


@pytest.fixture(scope="module")
def state(tmp_path_factory):
    """Written in float32, before the float64 mode."""
    w = tiny_weights(23)
    jt = JTrainer(JCascadedNet(*TINY), w, learning_rate=3e-3, dropout=False)
    X, y = (a.astype(np.float32) for a in tiny_batch())
    jt.train_epoch([(X, y)] * 2)
    path = str(tmp_path_factory.mktemp("state") / "train_state.msgpack")
    jcheckpoint.save_train_state(path, jt, JPlateau(lr=3e-3), 1, 0.5)
    return w, path


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64)
        if np.issubdtype(np.asarray(a).dtype, np.floating) else a, tree)


def test_resumed_float64_step_matches_jax(state, float64_mode):
    w, path = state
    X, y = tiny_batch()

    jt = JTrainer(JCascadedNet(*TINY), _f64(w), learning_rate=1e-3,
                  dropout=False)
    # Adam's betas and eps as float64 values, as the fresh trainer made
    # them (the file holds them in float32; torch's Adam takes Python
    # floats); the learning rate is the file's, in both
    fresh = dict(jt.opt_state.hyperparams)
    jcheckpoint.load_train_state(path, jt, JPlateau(lr=1e-3))
    jt.params, jt.stats, jt.opt_state = (
        _f64(jt.params), _f64(jt.stats), _f64(jt.opt_state))
    for k in ("b1", "b2", "eps", "eps_root"):
        jt.opt_state.hyperparams[k] = fresh[k]
    jt.train_epoch([(X, y)])

    trainer = Trainer(CascadedNet(*TINY).double(), learning_rate=1e-3,
                      dropout=False, device="cpu")
    checkpoint.load_train_state(path, trainer, ReduceLROnPlateau(lr=1e-3))
    trainer.train_epoch([(X, y)])

    want = convert._flatten(jax.tree_util.tree_map(np.asarray, jt.variables))
    got = convert._flatten(convert.to_jax_variables(trainer.model))
    assert set(got) == set(want) and len(got) > 100
    for k, ref in want.items():
        assert got[k].dtype == np.float64, k
        np.testing.assert_allclose(got[k], ref, rtol=0,
                                   atol=RTOL * np.abs(ref).max(), err_msg=k)
    inner = jt.opt_state.inner_state[0]
    for name, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        ref = convert._flatten(jax.tree_util.tree_map(
            np.asarray, getattr(inner, name)))
        scale = max(np.abs(a).max() for a in ref.values())
        for pname, p in trainer.model.named_parameters():
            k = "/".join(convert._jax_path(pname))
            m = convert._to_jax_layout(
                trainer.optimizer.state[p][key].numpy())
            tol = max(RTOL * np.abs(ref[k]).max(), 1e-12 * scale)
            np.testing.assert_allclose(m, ref[k], rtol=0, atol=tol,
                                       err_msg=f"{name} {k}")
