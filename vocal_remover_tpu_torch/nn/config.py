"""Numerics configuration for the port.

Counterpart of vocal_remover_tpu/nn/config.py: one global precision
mode, and the compute dtype that follows from it.

  * "highest"  - every float32 convolution and matrix product runs in
                 full float32. cuDNN runs float32 convolutions in TF32 by
                 default, which would put the stems far off the JAX f32
                 path, so this mode turns TF32 off for cuDNN and cuBLAS.
  * "default"  - float32 activations, and the card's reduced-precision
                 multiply allowed: TF32 on for cuDNN and cuBLAS. The JAX
                 package's `default` lets the TPU's matrix unit multiply
                 in bf16 while activations stay f32; the H100 has no such
                 mode for f32 tensors. Its counterpart ("a faster, less
                 exact multiply that the hardware offers, f32 in and
                 out") is TF32, so `default` on the card is TF32 and NOT
                 bf16.
  * "bfloat16" - bf16 activations and weights, f32 accumulation (the
                 tensor cores' bf16 mode; the flat-conv kernel
                 accumulates in f32 too). The parts that stay float32
                 (BiLSTM, its dense head, the mask head) run with TF32
                 off.

The mask head and the BiLSTM's dense head run in full float32 in every
mode (`full_float32`), as the JAX package pins them to HIGHEST.

int8 serving is not a mode here but a weight transform
(models/serving.quantize_int8) that runs under `bfloat16`, as in the JAX
package; `calibration` routes the float convs' input amax into a
recorder while an activation-scale calibration runs.
"""

from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("highest", "default", "bfloat16")

_precision = "highest"
_compute_dtype = torch.float32
_calibration_recorder = None


def get_calibration_recorder():
    """dict (id of a conv's weight tensor -> input amax) while an int8
    activation-scale calibration runs (models/serving.
    calibrate_act_scales), else None."""
    return _calibration_recorder


@contextlib.contextmanager
def calibration(recorder: dict):
    """Route every float conv2d's input amax into `recorder` for the
    duration."""
    global _calibration_recorder
    old = _calibration_recorder
    _calibration_recorder = recorder
    try:
        yield recorder
    finally:
        _calibration_recorder = old


def _set_tf32(allow: bool):
    torch.backends.cudnn.allow_tf32 = allow
    torch.backends.cuda.matmul.allow_tf32 = allow


def _get_tf32() -> tuple[bool, bool]:
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


def set_precision(p: str = "highest"):
    global _precision, _compute_dtype
    if p not in PRECISIONS:
        raise ValueError(f"precision {p!r}: expected one of {PRECISIONS} "
                         "(int8 is a weight transform, models/serving."
                         "quantize_int8, that runs under 'bfloat16')")
    _precision = p
    _compute_dtype = torch.bfloat16 if p == "bfloat16" else torch.float32
    _set_tf32(p == "default")


def get_precision() -> str:
    return _precision


def get_compute_dtype() -> torch.dtype:
    """The dtype convolutions cast their input and weight to."""
    return _compute_dtype


def set_compute_dtype(dt: torch.dtype):
    """Override the compute dtype (the JAX package's `set_compute_dtype`).
    The gradient parity tests set torch.float64: in float32, forward
    noise flips ReLU / LeakyReLU branches between frameworks, and only
    float64 checks the backward math tightly. `precision()` restores it."""
    global _compute_dtype
    _compute_dtype = dt


def at_least_float32(t: torch.Tensor) -> torch.Tensor:
    """`t` in float32, or as it is when it is float64 (the float64
    parity mode): the parts pinned to float32 (BiLSTM, dense head, mask
    head) run in "float32 or wider", as the JAX package's do."""
    return t if t.dtype == torch.float64 else t.float()


@contextlib.contextmanager
def precision(p: str):
    """Run a block under precision `p`; restores the mode, the compute
    dtype and both TF32 switches."""
    global _precision, _compute_dtype
    old = (_precision, _compute_dtype, _get_tf32())
    set_precision(p)
    try:
        yield
    finally:
        _precision, _compute_dtype, (cudnn, matmul) = old
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.backends.cuda.matmul.allow_tf32 = matmul


@contextlib.contextmanager
def full_float32():
    """TF32 off for the block, whatever the mode (the mask head and the
    BiLSTM's dense head)."""
    cudnn, matmul = _get_tf32()
    _set_tf32(False)
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.backends.cuda.matmul.allow_tf32 = matmul
