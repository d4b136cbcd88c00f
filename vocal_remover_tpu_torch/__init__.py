"""PyTorch/CUDA port of vocal_remover_tpu for NVIDIA Hopper (H100).

Same modules, checkpoints (`.vrt.npz`) and outputs as the JAX package,
in PyTorch's idiom (NCHW `nn.Module`s, explicit devices and generators).
What the JAX package runs as Pallas TPU kernels runs here as hand-written
CUDA kernels (csrc/*.cu, built by build.py at first use). Entry points
run on `cuda` unless the caller asks for the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means `cuda`. Raises when CUDA is
    asked for (or defaulted to) and no card is present: the port never
    falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (CLI: --gpu -1) "
            "to run on the CPU"
        )
    return dev
