"""The references' float32: TF32 off for cuDNN and cuBLAS (the card
would otherwise multiply float32 in TF32). `tf32(True)` is the control's
precision, the step below float32."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def tf32(allow: bool):
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = allow
    torch.backends.cuda.matmul.allow_tf32 = allow
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old
