"""GPU port, the rest of training: with `remat` (each band net
recomputed in the backward pass), the port's `Trainer.compute_grads`
against the JAX package's `Trainer(dropout=False, remat=True)` at
aux_lambda 0.1, in float64, on JAX's tiny configuration with the same
weights and batch (check_grads_match_jax: each leaf within 1e-9 of its
largest |g|). A file of its own: a float64 JAX compile takes about half
a minute on the CPU."""

import pytest
import torch

from torch_port_helpers import (  # noqa: F401
    check_grads_match_jax,
    float64_mode,
    tiny_weights,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def weights():
    """Made in float32, before the float64 mode."""
    return tiny_weights(14)


def test_remat_grads_match_jax_in_float64(weights, float64_mode):
    check_grads_match_jax(weights, aux_lambda=0.1, remat=True)
