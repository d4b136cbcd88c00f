"""GPU port, the rest of training: `remat` (CascadedNet.forward(remat=
True): each band net under torch.utils.checkpoint, recomputed in the
backward pass) against the plain step of the same port, in float64, on
JAX's tiny configuration with dropout ON and the aux head trained
(aux_lambda 0.1): the recompute must draw the forward's dropout masks and
must not update the BN running buffers a second time, neither of which a
gradient test alone sees. Tolerance 1e-12 of each leaf's largest |value|
(the recompute runs the same ops on the same inputs)."""

import copy

import pytest
import torch

from torch_port_helpers import (  # noqa: F401
    TINY,
    float64_mode,
    tiny_batch,
    tiny_weights,
)
from vocal_remover_tpu_torch.models import convert
from vocal_remover_tpu_torch.models.cascaded import CascadedNet
from vocal_remover_tpu_torch.train.step import Trainer

torch.set_num_threads(1)

TOL = 1e-12


@pytest.fixture(scope="module")
def weights():
    """Made in float32, before the float64 mode."""
    return tiny_weights(15)


def _trainers(weights):
    model = convert.from_jax_variables(CascadedNet(*TINY), weights).double()
    return [Trainer(copy.deepcopy(model), learning_rate=1e-3, seed=3,
                    aux_lambda=0.1, remat=remat, device="cpu")
            for remat in (False, True)]


def _close(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    scale = b.abs().max().item() if b.is_floating_point() else 0
    assert (a - b).abs().max().item() <= TOL * max(scale, 1e-300), what


def test_remat_grads_with_dropout_equal_plain(weights, float64_mode):
    plain, remat = _trainers(weights)
    X, y = tiny_batch()
    lp, gp = plain.compute_grads(X, y)
    lr, gr = remat.compute_grads(X, y)
    assert abs(lr - lp) <= TOL * abs(lp)
    assert set(gp) == set(gr) and len(gp) > 100
    for k in gp:
        _close(gr[k], gp[k], k)
    # dropout really drew: the step's masks are not all ones
    off = Trainer(copy.deepcopy(plain.model), 1e-3, seed=3, aux_lambda=0.1,
                  dropout=False, device="cpu")
    assert abs(off.compute_grads(X, y)[0] - lp) > 1e-6 * abs(lp)


def test_remat_train_epoch_leaves_buffers_and_params_as_plain(
        weights, float64_mode):
    """Two Adam steps with dropout: BN running mean / var,
    num_batches_tracked and every parameter as after the plain steps."""
    plain, remat = _trainers(weights)
    X, y = tiny_batch()
    batches = [(X, y), (X[::-1].copy(), y[::-1].copy())]
    for t in (plain, remat):
        t.train_epoch(batches)
    want = plain.model.state_dict()
    got = remat.model.state_dict()
    assert set(got) == set(want)
    for k, b in want.items():
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == int(b) == 2, k
        else:
            _close(got[k], b, k)
    moved = plain.model.stg1_low_band_net[0].enc1.conv[1].running_mean
    assert not torch.equal(moved, torch.zeros_like(moved))
