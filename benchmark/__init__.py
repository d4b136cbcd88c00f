"""The benchmark of vocal_remover_tpu_torch on NVIDIA cards (see run.py)."""
