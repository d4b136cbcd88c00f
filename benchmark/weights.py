"""Seeded weights for the published CascadedNet, made on the device.

The benchmark makes the weights and hands the same state dict to the
measured program and to the reference (benchmark/reference/nets.py), whose
keys are the published ones. One `torch.rand` call draws every float,
and two `repeat_interleave` calls spread each tensor's range over it:
  * conv and linear weights (and linear biases): U(-1/sqrt(fan_in),
    1/sqrt(fan_in)), torch's layer defaults;
  * LSTM tensors: U(-1/sqrt(hidden), 1/sqrt(hidden));
  * batch norm: weight U(0.9, 1.1), bias and running mean U(-0.05, 0.05),
    running variance U(0.9, 1.1), so that folding them (the serving
    transform) is not an identity; `num_batches_tracked` 0.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from benchmark.reference import nets

WEIGHTS_STREAM = 0x3E1


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one use (`stream`) of the run's `seed`."""
    ss = np.random.SeedSequence([int(seed) % 2**64, stream])
    return int(ss.generate_state(1, np.uint64)[0] >> 1)


def reference_model(config: dict, device,
                    state_dict: dict | None = None) -> nets.CascadedNet:
    """The plain CascadedNet of `config`, built on `device`, holding
    `state_dict` when one is given."""
    with torch.device(device):
        model = nets.CascadedNet(config["n_fft"], config["hop_length"],
                                 config["nout"], config["nout_lstm"])
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return model


def _ranges(model: nn.Module):
    """(key, shape, low, high) of every float tensor of the state dict."""
    out = []
    for prefix, m in model.named_modules():
        p = f"{prefix}." if prefix else ""
        if isinstance(m, nn.Conv2d):
            b = 1.0 / math.sqrt(m.weight[0].numel())
            out.append((p + "weight", m.weight.shape, -b, b))
        elif isinstance(m, nn.Linear):
            b = 1.0 / math.sqrt(m.in_features)
            out += [(p + "weight", m.weight.shape, -b, b),
                    (p + "bias", m.bias.shape, -b, b)]
        elif isinstance(m, nn.LSTM):
            b = 1.0 / math.sqrt(m.hidden_size)
            out += [(p + k, t.shape, -b, b) for k, t in m.named_parameters()]
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            out += [(p + "weight", m.weight.shape, 0.9, 1.1),
                    (p + "bias", m.bias.shape, -0.05, 0.05),
                    (p + "running_mean", m.running_mean.shape, -0.05, 0.05),
                    (p + "running_var", m.running_var.shape, 0.9, 1.1)]
    return out


def make_state_dict(config: dict, seed: int, device) -> dict:
    """The state dict of the published keys, every float tensor drawn
    from `seed` on `device` in float32."""
    with torch.device("meta"):
        template = nets.CascadedNet(config["n_fft"], config["hop_length"],
                                    config["nout"], config["nout_lstm"])
    ranges = _ranges(template)
    sizes = [math.prod(shape) for _, shape, _, _ in ranges]
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, WEIGHTS_STREAM))
    u = torch.rand(sum(sizes), generator=g, device=device)
    counts = torch.tensor(sizes, device=device)
    low = torch.tensor([r[2] for r in ranges], device=device)
    high = torch.tensor([r[3] for r in ranges], device=device)
    flat = (low.repeat_interleave(counts)
            + (high - low).repeat_interleave(counts) * u)
    sd = {k: t.view(shape) for (k, shape, _, _), t in
          zip(ranges, flat.split(sizes))}
    for k, t in template.state_dict().items():
        if k not in sd:  # num_batches_tracked
            sd[k] = torch.zeros(t.shape, dtype=t.dtype, device=device)
    return sd
