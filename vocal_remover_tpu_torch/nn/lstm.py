"""Bidirectional LSTM: input projection in PyTorch, recurrence in the
kernel.

Counterpart of vocal_remover_tpu/nn/lstm.py `bilstm` and
nn/lstm_pallas.py `bilstm_pallas`, with the same contract: the input
projection for all timesteps is one matrix product outside the kernel
(as XLA computes it outside Pallas), the backward direction is reversed
in time and stacked on the batch axis, and the recurrence
(nn/lstm_kernel.py) runs both directions at once in float32. Gate order
follows torch: input, forget, cell, output. The whole BiLSTM runs in
float32 or wider in every precision mode (vocal_remover_tpu/nn/lstm.py:54):
a bf16 input and bf16-resident weights are cast up on the way in, a
float64 input (the gradient parity tests) stays float64.

In training (`train=True`, a BiLSTM module in train mode) the recurrence
is `lstm_kernel.recurrence_plain` under autograd, as JAX trains with its
`lax.scan`; the op, and so the kernel, has no gradient (the JAX
package's Pallas recurrence has no backward either). Eval, validation
included, runs the op: the kernel on the card. The training loop is
traced (utils/trace.py) as `lstm.recurrence_plain` and its backward as
`lstm.recurrence_backward`.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from vocal_remover_tpu_torch.nn import config, lstm_kernel
from vocal_remover_tpu_torch.utils import trace


def bilstm(params, x, train: bool = False):
    """(T, N, In) -> (T, N, 2H), zero initial state.

    params: {"fwd": d, "bwd": d} with d = {"w_ih": (In, 4H), "w_hh":
    (H, 4H), "b_ih": (4H,), "b_hh": (4H,)} (the JAX package's layout)."""
    x = config.at_least_float32(x)
    pf, pb = ({k: v.to(x.dtype) for k, v in params[d].items()}
              for d in ("fwd", "bwd"))
    n = x.shape[1]
    xg_f = torch.einsum("tni,ih->tnh", x, pf["w_ih"]) + pf["b_ih"] + pf["b_hh"]
    xg_b = (torch.einsum("tni,ih->tnh", x.flip(0), pb["w_ih"])
            + pb["b_ih"] + pb["b_hh"])
    xg = torch.cat([xg_f, xg_b], dim=1)  # (T, 2N, 4H), contiguous
    if train:
        with trace.span("lstm.recurrence_plain"):
            hs = lstm_kernel.recurrence_plain(
                xg, torch.stack([pf["w_hh"], pb["w_hh"]]))
        trace.backward_span("lstm.recurrence_backward", hs, xg)
    else:
        # (2, 4H, H): the kernel's layout, torch's weight_hh_l0 stacked
        w_cols = torch.stack([pf["w_hh"].t(), pb["w_hh"].t()])
        hs = lstm_kernel.recurrence_cols(xg, w_cols)  # (T, 2N, H)
    return torch.cat([hs[:, :n], hs[:, n:].flip(0)], dim=-1)


class BiLSTM(nn.Module):
    """Parameter holder with torch `nn.LSTM(bidirectional=True)` names
    and layouts (weight_ih_l0 (4H, In), ..., *_reverse), so state_dict
    keys match the reference's; the forward is `bilstm`."""

    def __init__(self, input_size: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        for sfx in ("", "_reverse"):
            self.register_parameter(f"weight_ih_l0{sfx}", nn.Parameter(
                torch.empty(4 * hidden, input_size)))
            self.register_parameter(f"weight_hh_l0{sfx}", nn.Parameter(
                torch.empty(4 * hidden, hidden)))
            self.register_parameter(f"bias_ih_l0{sfx}", nn.Parameter(
                torch.empty(4 * hidden)))
            self.register_parameter(f"bias_hh_l0{sfx}", nn.Parameter(
                torch.empty(4 * hidden)))

    def reset_parameters(self, generator: torch.Generator):
        """torch nn.LSTM default: every tensor U(-1/sqrt(H), 1/sqrt(H))."""
        bound = 1.0 / math.sqrt(self.hidden)
        with torch.no_grad():
            for p in self.parameters():
                p.uniform_(-bound, bound, generator=generator)

    def params(self):
        def direction(sfx):
            return {
                "w_ih": getattr(self, f"weight_ih_l0{sfx}").t(),
                "w_hh": getattr(self, f"weight_hh_l0{sfx}").t(),
                "b_ih": getattr(self, f"bias_ih_l0{sfx}"),
                "b_hh": getattr(self, f"bias_hh_l0{sfx}"),
            }

        return {"fwd": direction(""), "bwd": direction("_reverse")}

    def forward(self, x):
        return bilstm(self.params(), x, train=self.training)
