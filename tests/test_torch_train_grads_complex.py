"""GPU port, complex-mask training: the training gradient of the port's
`Trainer.compute_grads` against the JAX package's
`Trainer(dropout=False).compute_grads` for the complex-mask tiny net
(without the wave term), in float64 (in float32, forward rounding flips
ReLU / LeakyReLU branches between the frameworks; float64 checks the
backward math), with the same weights and (N, 4, F, T) re/im batch. Each
case has a file of its own: a float64 JAX compile takes about half a
minute on the CPU."""

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
    return tiny_weights(13, is_complex=True)


def test_complex_compute_grads_match_jax_in_float64(
        weights, float64_mode):
    check_grads_match_jax(weights, aux_lambda=0.0, is_complex=True,
                          wave_loss=None)
