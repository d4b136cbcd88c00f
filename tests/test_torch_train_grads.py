"""GPU port, training slice: the training gradient of the port's
`Trainer.compute_grads` against the JAX package's
`Trainer(dropout=False).compute_grads` at aux_lambda 0, in float64 (in
float32, forward rounding flips ReLU / LeakyReLU branches between the
frameworks; float64 checks the backward math), on JAX's tiny
configuration with the same weights and batch. Each aux_lambda has a
file of its own: a float64 JAX compile takes about half a minute on the
CPU."""

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
    return tiny_weights(11)


def test_compute_grads_match_jax_in_float64(weights, float64_mode):
    check_grads_match_jax(weights, aux_lambda=0.0)
