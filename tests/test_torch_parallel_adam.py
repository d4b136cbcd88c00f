"""GPU port, parallelism: four float64 Adam steps on CPU gloo worlds of
(data, model) = (2, 1) and (2, 2) ranks against the JAX package's and
against one process.

Each world is started once (tests/torch_parallel_worker.py); the JAX
reference, JAX's single-device trajectory (its own tests hold each of
its mesh layouts to that, tests/test_sharding.py), is computed here
meanwhile. Checkpoints and the device cache on a mesh:
test_torch_parallel_checkpoint.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vocal_remover_tpu.models.cascaded import CascadedNet as JCascadedNet
from vocal_remover_tpu.nn import config as jconfig
from vocal_remover_tpu.train.step import Trainer as JTrainer
from vocal_remover_tpu_torch.models import convert
from vocal_remover_tpu_torch.models.cascaded import CascadedNet
from vocal_remover_tpu_torch.nn import config
from vocal_remover_tpu_torch.train.step import Trainer

import torch_parallel_worker as worker
from test_torch_parallel_grads import tiny_tree
from torch_port_helpers import TINY

torch.set_num_threads(1)

SHAPES = [(2, 1), (2, 2)]


def mags(rng, n, dtype):
    """(X, y) magnitude batches of n (2, 33, 160) items, y = X * U[0, 1)."""
    X = np.abs(rng.standard_normal((n, 2, 33, 160))).astype(dtype)
    return X, (X * rng.uniform(0, 1, X.shape)).astype(dtype)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(32)
    return {"weights": {"config": TINY, "tree": tiny_tree(12)},
            "adam_batches": [mags(rng, 2, np.float64) for _ in range(4)]}


def _jax_trajectory(variables, batches):
    """JAX's `Trainer(dropout=False)` taking one Adam step a batch, as its
    fused step does (value_and_grad, then optax's update), through the
    trainer's own two jitted pieces, `_grad` (compute_grads' program,
    which test_torch_parallel_grads.py and test_torch_train_grads.py
    compile too, so a suite compiles it once) and `_apply`. -> (losses,
    JAX's flat variables after the steps)."""
    jt = JTrainer(JCascadedNet(*TINY), variables, learning_rate=1e-3,
                  dropout=False)
    losses = []
    for step, (X, y) in enumerate(batches):
        rng = jax.random.fold_in(jt.base_key, step)  # unused: no dropout
        (loss, jt.stats), grads = jt._grad(jt.params, jt.stats, X, y, rng)
        jt.params, jt.opt_state, _ = jt._apply(jt.params, jt.opt_state,
                                                grads)
        losses.append(float(loss))
    return losses, convert._flatten(jt.variables)


@pytest.fixture(scope="module")
def results(inputs, tmp_path_factory):
    worlds = {s: worker.launch(tmp_path_factory.mktemp(f"w{s[0]}x{s[1]}"), s,
                               ["adam"], inputs) for s in SHAPES}
    try:
        v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                   inputs["weights"]["tree"])
        jax.config.update("jax_enable_x64", True)
        jconfig.set_compute_dtype(jnp.float64)
        try:
            want = _jax_trajectory(v, inputs["adam_batches"])
        finally:
            jax.config.update("jax_enable_x64", False)
            jconfig.set_compute_dtype(jnp.float32)
        config.set_compute_dtype(torch.float64)
        try:
            model = convert.from_jax_variables(
                CascadedNet(*TINY), inputs["weights"]["tree"]).double()
            trainer = Trainer(model, 1e-3, dropout=False, device="cpu")
            one = ([trainer.train_epoch([b])
                    for b in inputs["adam_batches"]],
                   _jax_flat({k: v.numpy()
                              for k, v in model.state_dict().items()}))
        finally:
            config.set_compute_dtype(torch.float32)
    finally:
        got = {s: w.join(timeout=240) for s, w in worlds.items()}
    return (want, one), got


def _jax_flat(state):
    """A port state dict of numpy arrays as JAX's flat variables (a holder
    of the arrays' float dtype, so that nothing is rounded)."""
    dtype = torch.from_numpy(state["out.weight"]).dtype
    holder = CascadedNet(*TINY).to(dtype)
    holder.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return convert._flatten(convert.to_jax_variables(holder))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_mesh_adam_trajectory_matches_jax(results, shape):
    """Each step's loss within 1e-9 of JAX's. After four steps every
    parameter and BN statistic is within 1e-8 of one process's
    trajectory (test_torch_train_step.py's bound), and within JAX's own
    bound for a mesh against one device (atol 1e-9, rtol 1e-7,
    tests/test_sharding.py) of JAX's: here one process is itself up to
    6e-8 from JAX's on the BN scales, whose gradients sit near Adam's
    eps, where a difference in the last digits of the gradient moves
    the step."""
    ((jlosses, jflat), (losses1, flat1)), got = results
    losses, state = got[shape]["adam"]
    assert all(abs(a - b) < 1e-9 for a, b in zip(losses, jlosses))
    flat = _jax_flat(state)
    assert set(flat) == set(jflat) == set(flat1)
    for k, want in jflat.items():
        np.testing.assert_allclose(flat[k], flat1[k], rtol=0, atol=1e-8,
                                   err_msg=k)
        np.testing.assert_allclose(flat[k], want, rtol=1e-7, atol=1e-9,
                                   err_msg=k)
