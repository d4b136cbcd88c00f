"""Whole-song separation: waves in, instruments and vocals out.

Counterpart of vocal_remover_tpu/separate/separator.py
`Separator.separate_wave` (`_build_wave_fn`) and `separate_waves`
(`_build_multiwave_fn`): STFT -> |X| / max|X| -> `cropsize`-frame patches
-> CascadedNet eval forward in chunks of `batchsize` patches -> stitch ->
mask * X and (1 - mask) * X -> iSTFT, with PCM16 in and out.

One path serves a stack of S equal-length songs, S = 1 for one song:
each song keeps its own normalisation and stitch, and the patches of all
songs run as one stream, cut into chunks of `batchsize` (cross-song patch
batching: at crop 1024 a 60 s song is 3 patches, so 8 songs fill a chunk
of 24). PyTorch runs eagerly, so the chunk loop is a Python loop. The last
chunk is topped up with zero patches whose masks are dropped, as the JAX
package does for a stack; for one song the JAX package pads frames
instead, which gives the same chunk count and the same kept masks (eval
patches do not see each other).

Normalisation quirks kept from the reference: without TTA each song is
scaled by its max|X| of the unpadded spectrogram; with TTA each pass is
scaled by |numpy-lexicographic max| of the song's own padded
spectrogram.

The spectrogram API (`separate`, `separate_tta`; JAX separator.py
`separate` / `separate_tta` / `_postprocess`, reference inference.py
:70-102) takes a host complex64 (2, F, T) spectrogram and returns host
`(y_spec, v_spec)`: the padding (patch count rounded up to whole
chunks) and the normalisation on the host, the masks on the device by
the same chunk loop, and with `postprocess` `merge_artifacts` on |mask|
(the mask's phase kept) before mask * X and (1 - mask) * X.

With a `mesh` (parallel/mesh.py; JAX `Separator(mesh=)`) the wave path
(`separate_wave`, `separate_waves`) is sequence parallel: the patch
stream rounds up to whole multiples of `batchsize` x the mesh's ranks,
each rank runs its contiguous share in chunks of `batchsize` (a chunk's
memory, as without a mesh), the masks are all-gathered and every rank
stitches. Patches are halo-free, so the stems are a one-process run's.
As in the JAX package, the spectrogram API runs unsharded.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from vocal_remover_tpu_torch import resolve_device
from vocal_remover_tpu_torch.native import pcm16_encode
from vocal_remover_tpu_torch.nn import config
from vocal_remover_tpu_torch.parallel import mesh as mesh_lib
from vocal_remover_tpu_torch.ops.stft import istft, num_frames, stft
from vocal_remover_tpu_torch.ops.windowing import (
    extract_patches,
    make_padding,
    num_patches,
    stitch_masks,
)
from vocal_remover_tpu_torch.utils.spec import merge_artifacts


def _lexmax_abs(re, im):
    """Per song of an (S, ...) stack given as re/im: |numpy-lexicographic
    max| of the complex array, the reference's `X_spec_pad.max()`
    (inference.py:87)."""
    dims = tuple(range(1, re.dim()))
    r_star = re.amax(dim=dims, keepdim=True)
    i_star = torch.where(re == r_star, im, -torch.inf).amax(dim=dims,
                                                            keepdim=True)
    return torch.sqrt(r_star * r_star + i_star * i_star).flatten()


def host_wave(wave, pcm16_io: bool) -> np.ndarray:
    """A host wave as the separation takes it, C-contiguous and writable
    (torch.from_numpy takes it): int16 PCM with `pcm16_io` (a float wave
    is quantised here by the native encoder, as in the JAX package),
    else float32."""
    if pcm16_io and wave.dtype != np.int16:
        wave = pcm16_encode(wave)
    return np.require(wave, np.int16 if pcm16_io else np.float32,
                      ("C", "W"))


def to_i16(w):
    """The PCM_16 WAV conversion: clip, scale by 32768, round half to
    even."""
    w = torch.clamp(w, -1.0, 1.0 - 1.0 / 32768.0)
    return torch.round(w * 32768.0).to(torch.int16)


class Separator:
    def __init__(self, model, batchsize: int = 4, cropsize: int = 256,
                 device=None, precision: str = "highest",
                 postprocess: bool = False, mesh=None):
        """Moves `model` to `device` (default `cuda`; raises without a
        card unless the CPU is asked for). Every separation runs under
        `precision` (nn/config.py; default full float32, no TF32). A
        serving-transformed model (models/serving.py) is taken as it
        is; `bfloat16` pairs with bf16-cast weights. `postprocess`
        applies `merge_artifacts` in the spectrogram API, which it
        then requires. `mesh`: shard the wave path's patches over all
        of the mesh's ranks (every rank calls with the same songs and
        gets the stems); the weights are replicated from rank 0."""
        if precision not in config.PRECISIONS:
            raise ValueError(f"precision {precision!r}: expected one of "
                             f"{config.PRECISIONS}")
        self.precision = precision
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.offset = model.offset
        self.batchsize = max(1, batchsize)
        self.cropsize = cropsize
        self.postprocess = postprocess
        self.mesh = mesh
        if mesh is not None:
            if mesh.device_type != self.device.type:
                raise ValueError(
                    f"the mesh is on {mesh.device_type} ranks but the "
                    f"separator on {self.device}")
            mesh_lib.replicate(mesh, self.model)

    def _forward(self, x, sharded: bool):
        """Masks of the (n, C, F, crop) patches, in chunks of `batchsize`
        (the last topped up with zero patches). `sharded` on a mesh: the
        stream rounds up to whole multiples of batchsize x ranks, this
        rank runs its contiguous share, and the masks are all-gathered."""
        bs = self.batchsize
        n_all = x.shape[0]
        mesh = self.mesh if sharded else None
        ranks = 1 if mesh is None else mesh.size()
        k = -(-n_all // (bs * ranks)) * bs  # this rank's patches
        if mesh is not None:
            x = x[mesh.get_rank() * k:][:k]
        out = []
        for i in range(0, k, bs):
            xb = x[i:i + bs]
            if xb.shape[0] < bs:  # topped up with zero patches
                xb = torch.cat([xb, xb.new_zeros(bs - xb.shape[0],
                                                 *x.shape[1:])])
            out.append(self.model(xb))
        out = torch.cat(out)
        if mesh is not None:
            parts = [torch.empty_like(out) for _ in range(ranks)]
            dist.all_gather(parts, out)
            out = torch.cat(parts)
        return out[:n_all]

    def _masks(self, re_pad, im_pad, inv_scale, roi, sharded=True):
        """Padded (S, 2, F, T) spectrograms and (S,) scales -> stitched
        masks (S, C, F, P * roi), the patches of all songs merged into one
        stream of whole chunks (over the mesh's ranks when `sharded`)."""
        scale = inv_scale.view(-1, 1, 1, 1)
        if self.model.is_complex:
            feats = torch.cat([re_pad, im_pad], dim=1) * scale
        else:
            feats = torch.sqrt(re_pad * re_pad + im_pad * im_pad) * scale
        x = extract_patches(feats, self.cropsize, roi, self.offset)
        n_p, n_s = x.shape[:2]  # (P, S, C, F, crop)
        x = x.transpose(0, 1).reshape(n_s * n_p, *x.shape[2:])
        out = self._forward(x, sharded)
        out = out.reshape(n_s, n_p, *out.shape[1:]).transpose(0, 1)
        return stitch_masks(out, self.offset)

    @torch.inference_mode()
    def _run(self, waves, tta: bool, only_instruments: bool = False):
        """(S, 2, n) float32 waves on the device -> (instruments, vocals),
        each (S, 2, n) float32; vocals None with `only_instruments` (its
        iSTFT is skipped)."""
        model = self.model
        n_fft, hop = model.n_fft, model.hop_length
        n_samples = waves.shape[-1]
        n_frame = num_frames(n_samples, n_fft, hop)
        pad_l, pad_r, roi = make_padding(n_frame, self.cropsize, self.offset)
        shift = roi // 2

        re, im = stft(waves, n_fft, hop)  # (S, 2, F, T)

        def padded(extra):
            cfg = (pad_l + extra, pad_r + extra)
            pad = torch.nn.functional.pad
            return pad(re, cfg), pad(im, cfg)

        if tta:
            re1, im1 = padded(0)
            m1 = self._masks(re1, im1, 1.0 / _lexmax_abs(re1, im1), roi)
            re2, im2 = padded(shift)
            m2 = self._masks(re2, im2, 1.0 / _lexmax_abs(re2, im2), roi)
            mask = (m1[..., :n_frame] + m2[..., shift:shift + n_frame]) * 0.5
        else:
            inv = 1.0 / torch.sqrt(re * re + im * im).amax(dim=(1, 2, 3))
            re1, im1 = padded(0)
            mask = self._masks(re1, im1, inv, roi)[..., :n_frame]

        if model.is_complex:  # y = m (*) X, v = X - y
            mr, mi = mask[:, :2], mask[:, 2:]
            y_re, y_im = mr * re - mi * im, mr * im + mi * re
            v_re, v_im = re - y_re, im - y_im
        else:
            y_re, y_im = mask * re, mask * im
            v_re, v_im = (1 - mask) * re, (1 - mask) * im
        y = istft(y_re, y_im, n_fft, hop, n_samples)
        if only_instruments:
            return y, None
        return y, istft(v_re, v_im, n_fft, hop, n_samples)

    def _separate(self, x, tta: bool, pcm16_io: bool,
                  only_instruments: bool = False):
        """(S, 2, n) tensor on the device, int16 with `pcm16_io` -> the
        stems as tensors on the device, int16 with `pcm16_io`, else
        float32. The caller holds the precision mode."""
        x = x.float() / 32768.0 if pcm16_io else x.float()
        y, v = self._run(x, tta, only_instruments)
        if pcm16_io:
            y, v = to_i16(y), (None if v is None else to_i16(v))
        return y, v

    def separate_waves(self, waves: np.ndarray, tta: bool = False,
                       pcm16_io: bool = False,
                       only_instruments: bool = False):
        """(S, 2, n_samples) stack of equal-length songs ->
        (instruments, vocals), each (S, 2, n_samples); vocals None with
        `only_instruments`.

        pcm16_io: take and return int16 PCM (a float input is quantised
        on the host first)."""
        if self.postprocess:
            raise ValueError("separate_waves is the device pipeline; "
                             "postprocess needs the spectrogram API "
                             "(separate / separate_tta)")
        waves = np.asarray(waves)
        if waves.ndim != 3:
            raise ValueError("separate_waves expects a (S, 2, n) stack")
        x = torch.from_numpy(host_wave(waves, pcm16_io)).to(self.device)
        with config.precision(self.precision):
            y, v = self._separate(x, tta, pcm16_io, only_instruments)
        return y.cpu().numpy(), (None if v is None else v.cpu().numpy())

    def separate_wave(self, wave: np.ndarray, tta: bool = False,
                      pcm16_io: bool = False, bucket: int | None = None,
                      only_instruments: bool = False):
        """(2, n_samples) wave -> (instruments_wave, vocals_wave); vocals
        None with `only_instruments`.

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
        y, v = self.separate_waves(np.asarray(wave)[None], tta, pcm16_io,
                                   only_instruments)
        return y[0, :, :n_orig], (None if v is None else v[0, :, :n_orig])

    # the spectrogram API: host complex spectrograms in and out

    def _pad_spec(self, X_spec: np.ndarray, extra_shift: int = 0):
        """(2, F, T) -> (padded spectrogram, roi): the windowing's
        padding, widened by `extra_shift` frames a side, and the right
        side by whole patches up to a whole number of chunks."""
        n_frame = X_spec.shape[2]
        pad_l, pad_r, roi = make_padding(n_frame, self.cropsize, self.offset)
        pad_l += extra_shift
        pad_r += extra_shift
        n = num_patches(pad_l + n_frame + pad_r, roi, self.offset)
        pad_r += (-(-n // self.batchsize) * self.batchsize - n) * roi
        return np.pad(X_spec, ((0, 0), (0, 0), (pad_l, pad_r))), roi

    @torch.inference_mode()
    def _spec_mask(self, X_pad: np.ndarray, roi: int,
                   inv_scale) -> np.ndarray:
        """Padded complex spectrogram -> host mask over its padded
        interior: real for magnitude models, complex for complex ones."""
        def upload(a):
            return torch.from_numpy(
                np.ascontiguousarray(a, np.float32)[None]).to(self.device)

        scale = torch.tensor([inv_scale], dtype=torch.float32,
                             device=self.device)
        with config.precision(self.precision):
            mask = self._masks(upload(X_pad.real), upload(X_pad.imag),
                               scale, roi, sharded=False)[0].cpu().numpy()
        if self.model.is_complex:
            mask = mask[:2] + 1j * mask[2:]
        return mask

    def separate(self, X_spec: np.ndarray):
        """(2, F, T) complex spectrogram -> (y_spec, v_spec)."""
        n_frame = X_spec.shape[2]
        X_pad, roi = self._pad_spec(X_spec)
        inv_scale = np.float32(1.0 / np.abs(X_spec).max())
        mask = self._spec_mask(X_pad, roi, inv_scale)[:, :, :n_frame]
        return self._postprocess(X_spec, mask)

    def separate_tta(self, X_spec: np.ndarray):
        """TTA: a second pass shifted by roi // 2 frames, the two masks
        averaged; each pass scaled by its own padded spectrogram's
        |lexicographic max|."""
        n_frame = X_spec.shape[2]
        X_pad, roi = self._pad_spec(X_spec)
        inv_scale = np.float32(1.0 / np.abs(X_pad.max()))
        mask = self._spec_mask(X_pad, roi, inv_scale)[:, :, :n_frame]

        X_pad2, _ = self._pad_spec(X_spec, extra_shift=roi // 2)
        inv_scale2 = np.float32(1.0 / np.abs(X_pad2.max()))
        mask_tta = self._spec_mask(X_pad2, roi, inv_scale2)[:, :, roi // 2:]
        mask = (mask + mask_tta[:, :, :n_frame]) * 0.5
        return self._postprocess(X_spec, mask)

    def _postprocess(self, X_spec, mask):
        if self.postprocess:
            mask = merge_artifacts(np.abs(mask)) * np.exp(1.0j * np.angle(mask))
        X_mag = np.abs(X_spec)
        X_phase = np.exp(1.0j * np.angle(X_spec))
        return mask * X_mag * X_phase, (1 - mask) * X_mag * X_phase
