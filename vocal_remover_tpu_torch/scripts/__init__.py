"""Measurement tools of the port, run as `python -m
vocal_remover_tpu_torch.scripts.<tool>`."""
