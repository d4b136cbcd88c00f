"""The system under test, as the benchmark builds it: the port's
CascadedNet with the benchmark's weights, in the serving form that the
separation CLI gives a precision (cli/inference.py `_load_checkpoint`).
"""

from __future__ import annotations


def model(config: dict, state_dict: dict, device, precision: str):
    """The port's CascadedNet of `config` on `device` holding
    `state_dict`; for `bfloat16` and `int8` serving-transformed
    (BatchNorm folded, weights cast or quantized), in eval mode."""
    from vocal_remover_tpu_torch.models import serving
    from vocal_remover_tpu_torch.models.cascaded import CascadedNet

    net = CascadedNet(config["n_fft"], config["hop_length"], config["nout"],
                      config["nout_lstm"]).to(device)
    net.load_state_dict(state_dict)
    if precision in ("bfloat16", "int8"):
        net = serving.serving_variables(net, precision)
    return net.eval()


def compute_precision(precision: str) -> str:
    """The mode a separation runs in: int8 runs under bfloat16."""
    return "bfloat16" if precision == "int8" else precision
