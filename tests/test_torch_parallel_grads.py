"""GPU port, parallelism: float64 `Trainer.compute_grads` on CPU gloo
worlds of (data, model) = (2, 1), (1, 2) and (2, 2) ranks against the JAX
package's, and float32 `validate_epoch` on them against one process.

Each world is started once (tests/torch_parallel_worker.py) and runs all
of this file's checks; the JAX reference is computed here meanwhile. It
is JAX's single-device `compute_grads`: JAX computes the single-device
program on every mesh layout and holds each to it within 1e-9 in its own
tests (tests/test_sharding.py), and one float64 JAX compile of the tiny
net takes about a minute on the CPU. Batch norm takes the global batch's
statistics: with each rank's own, the (2, 1) and (2, 2) gradients would
be those of two batches of one.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vocal_remover_tpu.models.cascaded import CascadedNet as JCascadedNet
from vocal_remover_tpu.nn import config as jconfig
from vocal_remover_tpu.nn.partition import partition
from vocal_remover_tpu.train.step import Trainer as JTrainer
from vocal_remover_tpu_torch.models import convert
from vocal_remover_tpu_torch.models.cascaded import CascadedNet
from vocal_remover_tpu_torch.train.step import Trainer

import torch_parallel_worker as worker
from torch_port_helpers import TINY, perturb_bn, tiny_batch

torch.set_num_threads(1)

SHAPES = [(2, 1), (1, 2), (2, 2)]


def tiny_tree(seed):
    """Weights of the tiny net made by the port (no JAX compile), BN
    perturbed, as a JAX variables tree of numpy arrays."""
    model = CascadedNet(*TINY, generator=torch.Generator().manual_seed(seed))
    return perturb_bn(convert.to_jax_variables(model),
                      np.random.default_rng(seed))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(31)

    def mags(n):
        X = np.abs(rng.standard_normal((n, 2, 33, 160))).astype(np.float32)
        return X, (X * rng.uniform(0, 1, X.shape)).astype(np.float32)

    return {"weights": {"config": TINY, "tree": tiny_tree(11)},
            "grads_batch": tiny_batch(),
            # 3 and 1 do not divide by 2 data ranks: run whole on each
            "val_batches": [mags(3), mags(2), mags(1)]}


@pytest.fixture(scope="module")
def results(inputs, tmp_path_factory):
    worlds = {s: worker.launch(tmp_path_factory.mktemp(f"w{s[0]}x{s[1]}"), s,
                               ["grads", "validate"], inputs)
              for s in SHAPES}
    try:
        v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                   inputs["weights"]["tree"])
        jax.config.update("jax_enable_x64", True)
        jconfig.set_compute_dtype(jnp.float64)
        try:
            jt = JTrainer(JCascadedNet(*TINY), v, learning_rate=1e-3,
                          dropout=False)
            want = jt.compute_grads(*inputs["grads_batch"])
        finally:
            jax.config.update("jax_enable_x64", False)
            jconfig.set_compute_dtype(jnp.float32)
        one = Trainer(convert.from_jax_variables(
            CascadedNet(*TINY), inputs["weights"]["tree"]), 1e-3,
            device="cpu").validate_epoch(inputs["val_batches"])
    finally:
        got = {s: w.join(timeout=240) for s, w in worlds.items()}
    return want, one, got


def _as_jax_params(grads):
    """The port's {name: gradient} as JAX's params tree, flattened."""
    holder = CascadedNet(*TINY).double()
    with torch.no_grad():
        for name, p in holder.named_parameters():
            p.copy_(torch.from_numpy(grads[name]))
    return convert._flatten(partition(convert.to_jax_variables(holder))[0])


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_mesh_grads_match_jax(results, shape):
    """The loss within 1e-10 relative; each leaf within 1e-9 of its
    largest |g| (leaves zero in exact arithmetic: 1e-12 of the model's
    largest), check_grads_match_jax's bounds. compute_grads leaves the
    state as it was; a model axis shards more than ten leaves."""
    (jloss, jgrads), _, got = results
    out = got[shape]
    loss, grads = out["grads"]
    assert abs(loss - jloss) <= 1e-10 * abs(jloss)
    jflat = convert._flatten(jgrads)
    flat = _as_jax_params(grads)
    assert set(flat) == set(jflat) and len(flat) > 100
    scale = max(np.abs(g).max() for g in jflat.values())
    for k, g_ref in jflat.items():
        tol = max(1e-9 * np.abs(g_ref).max(), 1e-12 * scale)
        np.testing.assert_allclose(flat[k], g_ref, rtol=0, atol=tol,
                                   err_msg=k)
    assert out["grads_state_kept"]
    assert (out["sharded"] > 10) == (shape[1] > 1)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_mesh_validate_matches_one_process(results, shape):
    """The global per-sample mean within 1e-6 of one process's, JAX's
    bound for its own mesh (tests/test_sharding.py), batches that do not
    divide by the data axis included."""
    _, one, got = results
    assert abs(got[shape]["validate"] - one) < 1e-6
