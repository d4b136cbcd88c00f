"""Numerics configuration for the port.

Only `highest` precision exists in this slice: every float32 convolution
and matrix product runs in full float32. cuDNN runs float32 convolutions
in TF32 by default, which would put the stems far off the JAX f32 path,
so `set_precision("highest")` turns TF32 off for cuDNN and for cuBLAS.
The faster modes (`default`, `bfloat16`) come with the serving slice.
"""

from __future__ import annotations

import torch

PRECISIONS = ("highest",)


def set_precision(p: str = "highest"):
    if p not in PRECISIONS:
        raise ValueError(
            f"precision {p!r} is not ported yet (only 'highest'); the "
            "bf16 modes come with the serving slice"
        )
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
