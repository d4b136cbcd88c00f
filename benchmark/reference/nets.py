"""The published CascadedNet in plain PyTorch: the benchmark's reference.

Written after tsurumeso/vocal-remover `lib/nets.py` and `lib/layers.py`
(v5 CascadedNet): `nn.Conv2d` / `nn.BatchNorm2d` / `nn.LSTM`, bilinear
resizes by `F.interpolate(align_corners=True)`, NCHW. It imports nothing
of the measured package, and its state-dict keys are the published ones,
so the benchmark's seeded weights load into both.

Departures from the published code, each for the benchmark's check:
  * the ASPP's channel dropout draws from a `generator` passed to the
    forward (`torch.rand` of (N, C, 1, 1), kept where u < 0.9, scaled by
    1 / 0.9), so a training step can follow a given mask stream; no
    generator is no dropout;
  * `forward` returns the mask alone in train mode too (the published
    training loss reads the main mask only).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

DROPOUT = 0.1


def crop_center(skip, x):
    """Centre-crop `skip` along time to x's width."""
    if skip.shape[3] == x.shape[3]:
        return skip
    s = (skip.shape[3] - x.shape[3]) // 2
    return skip[:, :, :, s:s + x.shape[3]]


def dropout2d(x, generator):
    if generator is None:
        return x
    u = torch.rand((x.shape[0], x.shape[1], 1, 1), generator=generator,
                   device=x.device)
    return torch.where(u < 1.0 - DROPOUT, x / (1.0 - DROPOUT),
                       torch.zeros((), dtype=x.dtype, device=x.device))


class Conv2DBNActiv(nn.Module):
    def __init__(self, nin, nout, ksize=3, stride=1, pad=1, dilation=1,
                 activ=nn.ReLU):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(nin, nout, ksize, stride, pad, dilation, bias=False),
            nn.BatchNorm2d(nout),
            activ(),
        )

    def forward(self, x):
        return self.conv(x)


class Encoder(nn.Module):
    def __init__(self, nin, nout, ksize=3, stride=1, pad=1,
                 activ=nn.LeakyReLU):
        super().__init__()
        self.conv1 = Conv2DBNActiv(nin, nout, ksize, stride, pad, activ=activ)
        self.conv2 = Conv2DBNActiv(nout, nout, ksize, 1, pad, activ=activ)

    def forward(self, x):
        return self.conv2(self.conv1(x))


class Decoder(nn.Module):
    def __init__(self, nin, nout, ksize=3, stride=1, pad=1, activ=nn.ReLU):
        super().__init__()
        self.conv1 = Conv2DBNActiv(nin, nout, ksize, 1, pad, activ=activ)

    def forward(self, x, skip=None):
        x = F.interpolate(x, scale_factor=2, mode="bilinear",
                          align_corners=True)
        if skip is not None:
            x = torch.cat([x, crop_center(skip, x)], dim=1)
        return self.conv1(x)


class ASPPModule(nn.Module):
    def __init__(self, nin, nout, dilations=((4, 2), (8, 4), (12, 6)),
                 activ=nn.ReLU):
        super().__init__()
        self.conv1 = nn.Sequential(
            nn.AdaptiveAvgPool2d((1, None)),
            Conv2DBNActiv(nin, nout, 1, 1, 0, activ=activ),
        )
        self.conv2 = Conv2DBNActiv(nin, nout, 1, 1, 0, activ=activ)
        self.conv3 = Conv2DBNActiv(nin, nout, 3, 1, dilations[0],
                                   dilations[0], activ=activ)
        self.conv4 = Conv2DBNActiv(nin, nout, 3, 1, dilations[1],
                                   dilations[1], activ=activ)
        self.conv5 = Conv2DBNActiv(nin, nout, 3, 1, dilations[2],
                                   dilations[2], activ=activ)
        self.bottleneck = Conv2DBNActiv(nout * 5, nout, 1, 1, 0, activ=activ)

    def forward(self, x, generator=None):
        h, w = x.shape[2:]
        feat1 = F.interpolate(self.conv1(x), size=(h, w), mode="bilinear",
                              align_corners=True)
        out = torch.cat([feat1, self.conv2(x), self.conv3(x), self.conv4(x),
                         self.conv5(x)], dim=1)
        out = self.bottleneck(out)
        if self.training:
            out = dropout2d(out, generator)
        return out


class LSTMModule(nn.Module):
    def __init__(self, nin_conv, nin_lstm, nout_lstm):
        super().__init__()
        self.conv = Conv2DBNActiv(nin_conv, 1, 1, 1, 0)
        self.lstm = nn.LSTM(input_size=nin_lstm, hidden_size=nout_lstm // 2,
                            bidirectional=True)
        self.dense = nn.Sequential(nn.Linear(nout_lstm, nin_lstm),
                                   nn.BatchNorm1d(nin_lstm), nn.ReLU())

    def forward(self, x):
        n, _, nbins, nframes = x.shape
        h = self.conv(x)[:, 0].permute(2, 0, 1)  # (frames, N, bins)
        h, _ = self.lstm(h)
        h = self.dense(h.reshape(-1, h.shape[-1]))
        return h.reshape(nframes, n, 1, nbins).permute(1, 2, 3, 0)


class BaseNet(nn.Module):
    def __init__(self, nin, nout, nin_lstm, nout_lstm,
                 dilations=((4, 2), (8, 4), (12, 6))):
        super().__init__()
        self.enc1 = Conv2DBNActiv(nin, nout, 3, 1, 1)
        self.enc2 = Encoder(nout, nout * 2, 3, 2, 1)
        self.enc3 = Encoder(nout * 2, nout * 4, 3, 2, 1)
        self.enc4 = Encoder(nout * 4, nout * 6, 3, 2, 1)
        self.enc5 = Encoder(nout * 6, nout * 8, 3, 2, 1)
        self.aspp = ASPPModule(nout * 8, nout * 8, dilations)
        self.dec4 = Decoder(nout * (6 + 8), nout * 6, 3, 1, 1)
        self.dec3 = Decoder(nout * (4 + 6), nout * 4, 3, 1, 1)
        self.dec2 = Decoder(nout * (2 + 4), nout * 2, 3, 1, 1)
        self.lstm_dec2 = LSTMModule(nout * 2, nin_lstm, nout_lstm)
        self.dec1 = Decoder(nout * (1 + 2) + 1, nout * 1, 3, 1, 1)

    def forward(self, x, generator=None):
        e1 = self.enc1(x)
        e2 = self.enc2(e1)
        e3 = self.enc3(e2)
        e4 = self.enc4(e3)
        e5 = self.enc5(e4)
        h = self.aspp(e5, generator)
        h = self.dec4(h, e4)
        h = self.dec3(h, e3)
        h = self.dec2(h, e2)
        h = torch.cat([h, self.lstm_dec2(h)], dim=1)
        return self.dec1(h, e1)


class CascadedNet(nn.Module):
    def __init__(self, n_fft, hop_length, nout=32, nout_lstm=128):
        super().__init__()
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.max_bin = n_fft // 2
        self.output_bin = n_fft // 2 + 1
        self.nin_lstm = self.max_bin // 2
        self.offset = 64
        nin = 2
        self.stg1_low_band_net = nn.Sequential(
            BaseNet(nin, nout // 2, self.nin_lstm // 2, nout_lstm),
            Conv2DBNActiv(nout // 2, nout // 4, 1, 1, 0),
        )
        self.stg1_high_band_net = BaseNet(nin, nout // 4, self.nin_lstm // 2,
                                          nout_lstm // 2)
        self.stg2_low_band_net = nn.Sequential(
            BaseNet(nout // 4 + nin, nout, self.nin_lstm // 2, nout_lstm),
            Conv2DBNActiv(nout, nout // 2, 1, 1, 0),
        )
        self.stg2_high_band_net = BaseNet(nout // 4 + nin, nout // 2,
                                          self.nin_lstm // 2, nout_lstm // 2)
        self.stg3_full_band_net = BaseNet(3 * nout // 4 + nin, nout,
                                          self.nin_lstm, nout_lstm)
        self.out = nn.Conv2d(nout, nin, 1, bias=False)
        self.aux_out = nn.Conv2d(3 * nout // 4, nin, 1, bias=False)

    def forward(self, x, generator=None):
        """(N, 2, >= max_bin, T) magnitudes -> mask (N, 2, output_bin, T)."""
        x = x[:, :, :self.max_bin]
        bandw = x.shape[2] // 2
        l1_in, h1_in = x[:, :, :bandw], x[:, :, bandw:]
        low1, low2 = self.stg1_low_band_net, self.stg2_low_band_net
        l1 = low1[1](low1[0](l1_in, generator))
        h1 = self.stg1_high_band_net(h1_in, generator)
        aux1 = torch.cat([l1, h1], dim=2)
        l2 = low2[1](low2[0](torch.cat([l1_in, l1], dim=1), generator))
        h2 = self.stg2_high_band_net(torch.cat([h1_in, h1], dim=1), generator)
        aux2 = torch.cat([l2, h2], dim=2)
        f3 = self.stg3_full_band_net(torch.cat([x, aux1, aux2], dim=1),
                                     generator)
        mask = torch.sigmoid(self.out(f3))
        return F.pad(mask, (0, 0, 0, self.output_bin - mask.shape[2]),
                     mode="replicate")
