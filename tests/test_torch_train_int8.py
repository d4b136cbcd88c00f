"""GPU port, the rest of training: `--transfer_dtype int8` staging. The
port's `quantize_u8` gives the bytes and scale of the JAX package's
`Trainer._quantize_u8` as it runs here (the built C quantizer,
native/vrtnative.c), on random magnitudes, an all-zero batch, NaN and
negative values, exact .5 boundaries and an infinity; the device's
dequantization equals JAX's `_upcast` bit for bit; a short run stays
inside JAX's test_int8_batch_staging envelope of the float32 loss and
learns; complex-mask models are refused, as in JAX."""

import numpy as np
import pytest
import torch

from torch_port_helpers import TINY, tiny_weights
from vocal_remover_tpu import native
from vocal_remover_tpu.train.step import Trainer as JTrainer
from vocal_remover_tpu_torch.models import convert
from vocal_remover_tpu_torch.models.cascaded import CascadedNet
from vocal_remover_tpu_torch.train.step import Trainer, quantize_u8

torch.set_num_threads(1)


def _batch():
    """JAX's test_int8_batch_staging data: y + v magnitudes, float32."""
    rng = np.random.default_rng(0)
    y = np.abs(rng.standard_normal((8, 2, 33, 160))).astype(np.float32) * 0.5
    v = np.abs(rng.standard_normal((8, 2, 33, 160))).astype(np.float32) * 0.3
    return y + v, y


CASES = {
    "random": lambda: _batch()[0],
    "zeros": lambda: np.zeros((2, 2, 33, 160), np.float32),
    "nan_negative": lambda: np.array(
        [[np.nan, -1.0, 0.5, 3.0], [-np.inf, 2.0, np.nan, 0.0]], np.float32),
    "half_boundaries": lambda: np.arange(511, dtype=np.float32) / 2,
    "scaled_halves": lambda: (np.arange(511, dtype=np.float32) / 2) * 0.37,
    "infinity": lambda: np.array([np.inf, 1.0, 0.25], np.float32),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_quantizer_bytes_equal_jax(case):
    assert native.get() is not None, "the JAX package's C quantizer is built"
    a = CASES[case]()
    want = JTrainer._quantize_u8(a)
    q, scale = quantize_u8(a)
    assert q.dtype == np.uint8 and q.shape == a.shape
    assert np.array_equal(q, want["q"])
    assert type(scale) is np.float32 and scale == want["scale"]
    # the dequantized batch: q * scale on the device, JAX's _upcast
    deq = Trainer._upcast((torch.from_numpy(q), float(scale)))
    ref = np.asarray(JTrainer._upcast(want))
    assert deq.dtype == torch.float32
    assert np.array_equal(deq.numpy(), ref, equal_nan=True)  # inf: 0 * inf


def _trainers(dropout=False):
    w = tiny_weights(16)
    return [Trainer(convert.from_jax_variables(CascadedNet(*TINY), w), 1e-3,
                    dropout=dropout, transfer_dtype=td, device="cpu")
            for td in (None, "int8")]


def test_int8_loss_within_envelope_and_learns():
    X, y = _batch()
    tf, tq = _trainers()
    loss_f, _ = tf.compute_grads(X[:4], y[:4])
    loss_q, _ = tq.compute_grads(X[:4], y[:4])
    # JAX's bound: one quantization step of the pair's larger scale
    step = max(float(X.max()), float(y.max())) / 255.0
    assert 0 < abs(loss_q - loss_f) < step, (loss_f, loss_q)

    pairs = [(X[:4], y[:4]), (X[4:], y[4:])]
    seq = [tq.train_epoch(pairs) for _ in range(6)]
    assert np.isfinite(seq).all() and seq[-1] < seq[0]
    # validation takes the same staging: the dequantized batches
    val = tq.validate_epoch(pairs)
    model = tq.model
    with torch.no_grad():
        model.eval()
        deq = [tuple(Trainer._upcast((torch.from_numpy(q), float(s)))
                     for q, s in map(quantize_u8, p)) for p in pairs]
    ref = Trainer(model, 1e-3, device="cpu").validate_epoch(
        [(a.numpy(), b.numpy()) for a, b in deq])
    assert val == ref


def test_int8_refuses_complex():
    model = CascadedNet(*TINY, is_complex=True)
    with pytest.raises(ValueError, match="int8 staging quantizes"):
        Trainer(model, 1e-3, transfer_dtype="int8", device="cpu")
