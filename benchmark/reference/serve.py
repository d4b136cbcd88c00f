"""The published separation pipeline in plain PyTorch, on int16 PCM.

After tsurumeso/vocal-remover `inference.py` (`Separator.separate`) and
`lib/spec_utils.py`, on the device: centred STFT (reflect padding,
periodic Hann), |X| padded by `make_padding` and scaled by its maximum,
`cropsize`-frame patches every roi frames in batches, the masks' central
roi frames stitched, instruments = mask * X and vocals = (1 - mask) * X,
iSTFT at its natural length (hop x (frames - 1) samples: the published
separator writes no sample past the last frame's hop, so the stems end
there, at most a hop short of the song), PCM16 (clip to [-1, 1 - 2^-15],
x 32768, round half to even). What the separation CLIs add around it is
kept: the song zero-padded to a whole number of `bucket` samples and
the stems trimmed back, and, with `vocals_residual`, vocals as
clip(mixture - instruments) in int16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def make_padding(width: int, cropsize: int, offset: int):
    left = offset
    roi_size = cropsize - left * 2
    if roi_size == 0:
        roi_size = cropsize
    right = roi_size - (width % roi_size) + left
    return left, right, roi_size


def to_pcm16(w: torch.Tensor) -> torch.Tensor:
    w = torch.clamp(w, -1.0, 1.0 - 1.0 / 32768.0)
    return torch.round(w * 32768.0).to(torch.int16)


@torch.no_grad()
def masks(model, mag_pad, cropsize: int, roi: int, batchsize: int):
    """(2, F, T_pad) scaled magnitudes -> stitched mask (2, F, P * roi)."""
    offset = model.offset
    patches = (mag_pad.shape[2] - 2 * offset) // roi
    out = []
    for i in range(0, patches, batchsize):
        batch = torch.stack([mag_pad[:, :, j * roi:j * roi + cropsize]
                             for j in range(i, min(i + batchsize, patches))])
        pred = model(batch)[:, :, :, offset:-offset]
        out.append(torch.cat(list(pred), dim=2))
    return torch.cat(out, dim=2)


@torch.no_grad()
def separate(model, wave, cropsize: int, batchsize: int, bucket: int = 0,
             vocals_residual: bool = False):
    """int16 (2, n) song on the model's device -> (instruments, vocals),
    int16 (2, m) tensors, m <= n (see the module docstring). `model` is a
    reference CascadedNet in eval."""
    n_fft, hop = model.n_fft, model.hop_length
    n = wave.shape[-1]
    x = wave.float() / 32768.0
    if bucket:
        x = F.pad(x, (0, -(-n // bucket) * bucket - n))
    window = torch.hann_window(n_fft, periodic=True, device=x.device)
    X = torch.stft(x, n_fft, hop, window=window, center=True,
                   pad_mode="reflect", return_complex=True)
    mag = X.abs()
    n_frame = mag.shape[2]
    pad_l, pad_r, roi = make_padding(n_frame, cropsize, model.offset)
    mag_pad = F.pad(mag, (pad_l, pad_r))
    mag_pad = mag_pad / mag_pad.max()
    mask = masks(model, mag_pad, cropsize, roi, batchsize)[:, :, :n_frame]

    def wave_of(spec):
        y = torch.istft(spec, n_fft, hop, window=window, center=True)
        return to_pcm16(y[:, :n])

    inst = wave_of(mask * X)
    if vocals_residual:
        voc = torch.clamp(wave[:, :inst.shape[1]].int() - inst.int(),
                          -32768, 32767).short()
    else:
        voc = wave_of((1 - mask) * X)
    return inst, voc
