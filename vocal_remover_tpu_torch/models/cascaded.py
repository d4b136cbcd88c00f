"""CascadedNet, the flagship 3-stage multi-band mask model (NCHW).

Counterpart of vocal_remover_tpu/models/cascaded.py (reference
lib/nets.py:44-141): stage 1 runs low/high half-band U-Nets, stage 2
re-refines each band on [band input (+) stage-1 output], stage 3 runs the
full band on [input (+) aux1 (+) aux2], and a 1x1 float32 head gives a
sigmoid mask (or the tanh-bounded complex mask), edge-padded from
max_bin to output_bin frequency bins.

Inputs are (N, 2, output_bin, T) magnitudes (or (N, 4, output_bin, T)
re/im pairs in complex mode). Attribute paths are the reference's
state_dict keys: the stage-1/2 low nets are Sequential(BaseNet,
Conv2DBNActiv) ('stg1_low_band_net.0.', '.1.').

CascadedNet(2048, 1024, 32, 128) has 14,740,882 trainable parameters.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from vocal_remover_tpu_torch.models.base_net import BaseNet
from vocal_remover_tpu_torch.nn import config
from vocal_remover_tpu_torch.nn.layers import (
    Conv2d,
    Conv2DBNActiv,
    reset_parameters,
)


class CascadedNet(nn.Module):
    def __init__(self, n_fft, hop_length, nout=32, nout_lstm=128,
                 is_complex=False, generator: torch.Generator | None = None):
        """Parameters are made on the CPU from `generator` (a fresh one
        seeded 0 when None) with the torch layer defaults; move the
        module with `.to(device)`."""
        super().__init__()
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.is_complex = is_complex
        self.max_bin = n_fft // 2
        self.output_bin = n_fft // 2 + 1
        self.nin_lstm = self.max_bin // 2
        self.offset = 64
        self.nout = nout
        self.nout_lstm = nout_lstm
        nin = 4 if is_complex else 2
        self.nin = nin

        self.stg1_low_band_net = nn.Sequential(
            BaseNet(nin, nout // 2, self.nin_lstm // 2, nout_lstm),
            Conv2DBNActiv(nout // 2, nout // 4, 1, 1, 0),
        )
        self.stg1_high_band_net = BaseNet(
            nin, nout // 4, self.nin_lstm // 2, nout_lstm // 2
        )
        self.stg2_low_band_net = nn.Sequential(
            BaseNet(nout // 4 + nin, nout, self.nin_lstm // 2, nout_lstm),
            Conv2DBNActiv(nout, nout // 2, 1, 1, 0),
        )
        self.stg2_high_band_net = BaseNet(
            nout // 4 + nin, nout // 2, self.nin_lstm // 2, nout_lstm // 2
        )
        self.stg3_full_band_net = BaseNet(
            3 * nout // 4 + nin, nout, self.nin_lstm, nout_lstm
        )
        self.out = Conv2d(nout, nin, 1)
        self.aux_out = Conv2d(3 * nout // 4, nin, 1)

        if generator is None:
            generator = torch.Generator().manual_seed(0)
        reset_parameters(self, generator)

    def forward(self, x, aux: bool = False, generator=None,
                remat: bool = False):
        """(N, nin, >= max_bin, T) -> mask (N, nin, output_bin, T); with
        `aux`, (mask, aux_mask), the aux head's mask on [aux1 (+) aux2]
        (JAX `apply(aux=True)`; the reference has the head but never
        calls it). `generator` draws the channel dropout in train mode
        (none: no dropout). `remat` recomputes each of the five band nets
        in the backward pass instead of keeping its activations (JAX
        `apply(remat=True)`, `jax.checkpoint` per stage; the squeeze
        convs are kept, as in JAX): see `_stage`."""
        if x.dim() != 4 or x.shape[2] < self.max_bin:
            raise ValueError(
                f"CascadedNet expects (N, C, >={self.max_bin} bins, T) "
                f"input (n_fft={self.n_fft}), got {tuple(x.shape)}"
            )
        x = x[:, :, :self.max_bin]
        # bf16 mode: cast once at the top, so the stage concats do not
        # promote back to float32
        dt = config.get_compute_dtype()
        if dt == torch.bfloat16 and x.dtype == torch.float32:
            x = x.to(dt)
        bandw = x.shape[2] // 2
        l1_in = x[:, :, :bandw]
        h1_in = x[:, :, bandw:]
        low1, low2 = self.stg1_low_band_net, self.stg2_low_band_net

        def stage(net, xin):
            return _stage(net, xin, generator, remat)

        l1 = low1[1](stage(low1[0], l1_in))
        h1 = stage(self.stg1_high_band_net, h1_in)
        aux1 = torch.cat([l1, h1], dim=2)

        l2 = low2[1](stage(low2[0], torch.cat([l1_in, l1], dim=1)))
        h2 = stage(self.stg2_high_band_net, torch.cat([h1_in, h1], dim=1))
        aux2 = torch.cat([l2, h2], dim=2)

        f3 = stage(self.stg3_full_band_net, torch.cat([x, aux1, aux2], dim=1))
        mask = self._head(self.out, f3)
        if aux:
            return mask, self._head(self.aux_out,
                                    torch.cat([aux1, aux2], dim=1))
        return mask

    def _head(self, conv, feat):
        """The mask head always runs in full float32 (float64 in the
        parity mode), whatever the precision mode and the weights'
        resident dtype. Under tensor parallelism (`conv.tp`) the 1x1
        conv computes this rank's channels, gathered before the mask's
        nonlinearity (the complex one mixes channels)."""
        feat = config.at_least_float32(feat)
        if conv.tp is not None:
            feat = conv.tp.enter(feat)
        with config.full_float32():
            m = torch.nn.functional.conv2d(feat, conv.weight.to(feat.dtype))
        if conv.tp is not None:
            m = conv.tp.gather(m)
        if self.is_complex:
            m = self.bounded_mask(m)
        else:
            m = torch.sigmoid(m)
        pad = self.output_bin - m.shape[2]
        if pad > 0:  # replicate-pad frequency up to output_bin
            m = torch.nn.functional.pad(m, (0, 0, 0, pad), mode="replicate")
        return m

    def bounded_mask(self, m, eps=1e-8):
        """tanh-bounded complex mask on stacked re/im channels."""
        re, im = m[:, :2], m[:, 2:]
        mag = torch.sqrt(torch.clamp_min(re * re + im * im, 1e-24))
        scale = torch.tanh(mag) / (mag + eps)
        return torch.cat([re * scale, im * scale], dim=1)

    def predict_mask(self, x):
        """Eval mask with the offset trimmed off both ends of time."""
        mask = self(x)
        if self.offset > 0:
            mask = mask[:, :, :, self.offset:-self.offset]
            if mask.shape[3] <= 0:
                raise ValueError("input shorter than 2 * offset frames")
        return mask

    def predict(self, x):
        """The masked spectrogram x * mask, offset-trimmed in time (JAX
        `predict`, reference nets.py:133-141): what validation scores.
        Runs in the module's mode; the trainer calls it in eval."""
        pred = x * self(x)
        if self.offset > 0:
            pred = pred[:, :, :, self.offset:-self.offset]
            if pred.shape[3] <= 0:
                raise ValueError("input shorter than 2 * offset frames")
        return pred


def _stage(net, x, generator, remat):
    """`net(x, generator)`; with `remat`, under a non-reentrant
    `torch.utils.checkpoint`, whose recompute in the backward pass
    replays the forward exactly, as `jax.checkpoint` does:

      * the channel dropout draws the same masks: checkpoint saves the
        default generators only, not one passed as an argument, so the
        recompute draws from a copy of `generator` as it stood when the
        forward entered this stage (the forward's own draws, and so the
        stream of the later stages, are those of the plain forward);
      * batch norm's running buffers (and `num_batches_tracked`) are
        updated once: the recompute's second update is undone."""
    if not remat:
        return net(x, generator)
    state = None if generator is None else generator.get_state()
    calls = []

    def run(xin):
        calls.append(None)
        if len(calls) == 1:  # the forward
            return net(xin, generator)
        replay = None
        if state is not None:
            replay = torch.Generator(device=generator.device)
            replay.set_state(state)
        buffers = list(net.buffers())
        saved = [b.clone() for b in buffers]
        try:
            return net(xin, replay)
        finally:
            with torch.no_grad():
                for b, s in zip(buffers, saved):
                    b.copy_(s)

    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


def param_count(model: nn.Module) -> int:
    """Trainable parameter count (BN running statistics are buffers)."""
    return sum(p.numel() for p in model.parameters())
