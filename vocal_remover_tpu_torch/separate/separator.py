"""Whole-song separation: wave in, instruments and vocals out.

Counterpart of vocal_remover_tpu/separate/separator.py
`Separator.separate_wave` (`_build_wave_fn`): STFT -> |X| / max|X| ->
256-frame patches -> CascadedNet eval forward in chunks of `batchsize`
patches -> stitch -> mask * X and (1 - mask) * X -> iSTFT, with PCM16 in
and out. PyTorch runs eagerly, so the chunk loop is a Python loop; the
patch count is still rounded up to whole chunks, as in the JAX package,
so both run the model on the same patches.

Normalisation quirks kept from the reference: without TTA the input is
scaled by max|X| of the unpadded spectrogram; with TTA each pass is
scaled by |numpy-lexicographic max| of its own padded spectrogram.
"""

from __future__ import annotations

import numpy as np
import torch

from vocal_remover_tpu_torch import resolve_device
from vocal_remover_tpu_torch.nn import config
from vocal_remover_tpu_torch.ops.stft import istft, num_frames, stft
from vocal_remover_tpu_torch.ops.windowing import (
    extract_patches,
    make_padding,
    num_patches,
    stitch_masks,
)
from vocal_remover_tpu_torch.utils.audio import pcm16_encode


def _lexmax_abs(re, im):
    """|numpy-lexicographic max| of a complex array given as re/im: the
    reference's `X_spec_pad.max()` (inference.py:87)."""
    r_star = re.max()
    i_star = torch.where(re == r_star, im, -torch.inf).max()
    return torch.sqrt(r_star * r_star + i_star * i_star)


def _to_i16(w):
    """The PCM_16 WAV conversion: clip, scale by 32768, round half to
    even."""
    w = torch.clamp(w, -1.0, 1.0 - 1.0 / 32768.0)
    return torch.round(w * 32768.0).to(torch.int16)


class Separator:
    def __init__(self, model, batchsize: int = 4, cropsize: int = 256,
                 device=None, precision: str = "highest"):
        """Moves `model` to `device` (default `cuda`; raises without a
        card unless the CPU is asked for). Every separation runs under
        `precision` (nn/config.py; default full float32, no TF32). A
        serving-transformed model (models/serving.py) is taken as it
        is; `bfloat16` pairs with bf16-cast weights."""
        if precision not in config.PRECISIONS:
            raise ValueError(f"precision {precision!r}: expected one of "
                             f"{config.PRECISIONS}")
        self.precision = precision
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.offset = model.offset
        self.batchsize = max(1, batchsize)
        self.cropsize = cropsize

    def _masks(self, re_pad, im_pad, inv_scale, roi):
        """Padded spectrogram -> stitched mask over the padded interior."""
        if self.model.is_complex:
            feats = torch.cat([re_pad, im_pad], dim=0) * inv_scale
        else:
            feats = torch.sqrt(re_pad * re_pad + im_pad * im_pad) * inv_scale
        # (P, C, F, crop); P is a whole number of chunks by construction
        x = extract_patches(feats, self.cropsize, roi, self.offset)
        bs = self.batchsize
        out = torch.cat([self.model(x[i:i + bs])
                         for i in range(0, x.shape[0], bs)])
        return stitch_masks(out, self.offset)  # (C, F, P * roi)

    @torch.inference_mode()
    def _run(self, wave, n_samples: int, tta: bool):
        model = self.model
        n_fft, hop = model.n_fft, model.hop_length
        crop, off, bs = self.cropsize, self.offset, self.batchsize
        n_frame = num_frames(n_samples, n_fft, hop)
        pad_l0, pad_r0, roi = make_padding(n_frame, crop, off)
        shift = roi // 2

        def bucketed(pad_l, pad_r):
            """Round the patch count up to whole chunks."""
            n = num_patches(pad_l + n_frame + pad_r, roi, off)
            return pad_l, pad_r + (-(-n // bs) * bs - n) * roi

        re, im = stft(wave, n_fft, hop)  # (2, F, T)

        def padded(pad_l, pad_r):
            cfg = bucketed(pad_l, pad_r)
            pad = torch.nn.functional.pad
            return pad(re, cfg), pad(im, cfg)

        if tta:
            re1, im1 = padded(pad_l0, pad_r0)
            m1 = self._masks(re1, im1, 1.0 / _lexmax_abs(re1, im1), roi)
            re2, im2 = padded(pad_l0 + shift, pad_r0 + shift)
            m2 = self._masks(re2, im2, 1.0 / _lexmax_abs(re2, im2), roi)
            mask = (m1[..., :n_frame] + m2[..., shift:shift + n_frame]) * 0.5
        else:
            inv = 1.0 / torch.sqrt(re * re + im * im).max()
            re1, im1 = padded(pad_l0, pad_r0)
            mask = self._masks(re1, im1, inv, roi)[..., :n_frame]

        if model.is_complex:  # y = m (*) X, v = X - y
            mr, mi = mask[:2], mask[2:]
            y_re, y_im = mr * re - mi * im, mr * im + mi * re
            v_re, v_im = re - y_re, im - y_im
        else:
            y_re, y_im = mask * re, mask * im
            v_re, v_im = (1 - mask) * re, (1 - mask) * im
        return (istft(y_re, y_im, n_fft, hop, n_samples),
                istft(v_re, v_im, n_fft, hop, n_samples))

    def separate_wave(self, wave: np.ndarray, tta: bool = False,
                      pcm16_io: bool = False, bucket: int | None = None):
        """(2, n_samples) wave -> (instruments_wave, vocals_wave).

        pcm16_io: take and return int16 PCM (a float input is quantised
        on the host first). bucket: zero-pad the song to a multiple of
        `bucket` samples (outputs trimmed back), as the JAX package does
        to share compiled executables; kept so both give the same
        samples."""
        n_orig = wave.shape[-1]
        if bucket:
            padded = -(-n_orig // bucket) * bucket
            if padded != n_orig:
                wave = np.pad(wave, ((0, 0), (0, padded - n_orig)))
        if pcm16_io and wave.dtype != np.int16:
            wave = pcm16_encode(wave)
        x = torch.from_numpy(np.ascontiguousarray(wave)).to(self.device)
        x = x.float() / 32768.0 if pcm16_io else x.float()
        with config.precision(self.precision):
            y, v = self._run(x, wave.shape[-1], tta)
        if pcm16_io:
            y, v = _to_i16(y), _to_i16(v)
        return y.cpu().numpy()[:, :n_orig], v.cpu().numpy()[:, :n_orig]
