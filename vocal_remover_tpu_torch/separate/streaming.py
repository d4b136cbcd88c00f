"""Streamed whole-song separation: songs of any length in fixed segments.

Counterpart of vocal_remover_tpu/separate/streaming.py
`StreamingSeparator`. Audio of any length runs in segments of K patches,
each a fixed amount of device work and memory, with the stems of the
monolithic path (`Separator.separate_wave`):

  * each segment recomputes its one-patch halo, so no state crosses
    segments; zeroed "virtual padding" frames reproduce the global
    spectrogram padding; the global normalisation statistics come from a
    streamed pass over the song first;
  * TTA (the half-roi shifted second pass) runs inside the segment;
  * `postprocess` (merge_artifacts) runs as two streamed phases: masks ->
    the host merges artifacts over the whole-song mask -> apply.

Geometry (in STFT frames; roi = crop - 2 * offset, pad_l = offset):
segment k owns patches [kK, (k+1)K), i.e. original frames [kK * roi,
(k+1)K * roi). It computes patches [kK - 1, (k+1)K + 1) (one halo patch
each side), so the masked frames its overlap-add needs are local. The TTA
pass takes patches from the same local spectrogram on the grid shifted
by -roi // 2 frames.

A producer thread runs the segments on the device (holding the
precision mode and inference mode for its life) up to `pipeline_depth`
segments ahead of the caller's thread, which copies each segment's
samples to the host.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from vocal_remover_tpu_torch import resolve_device
from vocal_remover_tpu_torch.nn import config
from vocal_remover_tpu_torch.ops.stft import (
    frame_spectrum,
    hann_window,
    num_frames,
    overlap_add,
)
from vocal_remover_tpu_torch.ops.windowing import extract_patches, stitch_masks
from vocal_remover_tpu_torch.separate import pipeline
from vocal_remover_tpu_torch.separate.separator import host_wave, to_i16
from vocal_remover_tpu_torch.utils.spec import merge_artifacts

_TINY = float(np.finfo(np.float32).tiny)


class StreamingSeparator:
    """Segment-streamed counterpart of Separator.separate_wave, with the
    same normalisation per mode: the global max |X| without TTA, the
    numpy-lexicographic complex max (zero padding included) with TTA."""

    def __init__(self, model, segment_patches: int = 32, batchsize: int = 8,
                 pcm16_io: bool = False, vocals_residual: bool = False,
                 pipeline_depth: int = 3, tta: bool = False,
                 postprocess: bool = False, device=None,
                 precision: str = "highest"):
        """pcm16_io: take and return int16 PCM. vocals_residual: compute
        only the instruments and reconstruct the vocals on the host as
        mixture - instruments. pipeline_depth: how many segments the
        device may run ahead of the host. tta: average in the half-roi
        shifted second pass. postprocess: merge_artifacts over the
        whole-song mask (two streamed phases; the host holds the mask).
        device: default `cuda` (raises without a card unless the CPU is
        asked for); precision: as `Separator`'s."""
        if getattr(model, "is_complex", False):
            raise ValueError(
                "StreamingSeparator feeds magnitude patches and applies "
                "the mask as a real multiplier; complex-mask checkpoints "
                "separate through Separator instead")
        if precision not in config.PRECISIONS:
            raise ValueError(f"precision {precision!r}: expected one of "
                             f"{config.PRECISIONS}")
        if model.offset * 2 > 256:
            raise ValueError(f"offset {model.offset}: streaming needs a "
                             "crop of 2 roi within 256 frames")
        if model.n_fft // 2 != model.hop_length:
            raise ValueError("streaming assumes the 50%-overlap STFT "
                             "geometry (hop == n_fft // 2)")
        self.precision = precision
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.bs = batchsize
        self.pcm16_io = pcm16_io
        self.vocals_residual = vocals_residual
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.tta = bool(tta)
        self.postprocess = bool(postprocess)
        # K + 2 (owned + halo patches) must fill whole chunks
        self.K = max(batchsize - 2,
                     -(-(segment_patches + 2) // batchsize) * batchsize - 2)
        self.offset = model.offset
        self.crop = 256 if model.offset == 64 else 4 * model.offset
        self.roi = self.crop - 2 * self.offset
        self.window = hann_window(model.n_fft, self.device)

    # -- static geometry -------------------------------------------------

    def _geometry(self):
        n_fft, hop = self.model.n_fft, self.model.hop_length
        K, roi, off, crop = self.K, self.roi, self.offset, self.crop
        pad = n_fft // 2
        seg_frames = (K + 3) * roi  # frames feeding K + 2 patches
        slice_len = (seg_frames - 1) * hop + n_fft
        return n_fft, hop, K, roi, off, crop, pad, seg_frames, slice_len

    # -- one segment on the device ---------------------------------------

    def _spectrogram(self, wave_slice, frame_valid):
        """Local STFT with the global padding frames zeroed: (2, F,
        seg_frames) re, im."""
        n_fft, hop = self.model.n_fft, self.model.hop_length
        x = wave_slice.float()
        if self.pcm16_io:
            x = x / 32768.0
        re, im = frame_spectrum(x, n_fft, hop)
        return re * frame_valid, im * frame_valid

    def _model_masks(self, feats):
        """(2, F, (K + 3) * roi) scaled magnitudes -> stitched mask;
        stitched index j covers original frame (a - 1) * roi + j."""
        patches = extract_patches(feats, self.crop, self.roi, self.offset)
        bs = self.bs
        out = torch.cat([self.model(patches[i:i + bs])
                         for i in range(0, patches.shape[0], bs)])
        return stitch_masks(out, self.offset)

    def _masked_span(self, re, im, inv_scale, lo, n_take):
        """Averaged (TTA) or plain stitched mask over the local frames
        [lo, lo + n_take) in pass-1 stitched coordinates."""
        roi, seg_frames = self.roi, self._geometry()[7]
        mag = torch.sqrt(re * re + im * im) * inv_scale
        m = self._model_masks(mag)[..., lo:lo + n_take]
        if self.tta:
            # the shifted grid: stitched2[j] = frame a * roi - shift + j,
            # so frame (a - 1) * roi + lo + t is j = lo + t + shift - roi;
            # indices >= (K + 1) * roi come from a zero dummy patch
            shift = roi // 2
            mag2 = torch.nn.functional.pad(mag, (0, roi))
            m2 = self._model_masks(
                mag2[..., roi - shift:roi - shift + seg_frames])
            lo2 = lo + shift - roi
            m = (m + m2[..., lo2:lo2 + n_take]) * 0.5
        return m

    def _reconstruct(self, m, re, im, frame_valid):
        """Masked span -> (instruments, vocals) emitted samples; vocals
        None with `vocals_residual`."""
        n_fft, hop, K, roi, off = self._geometry()[:5]
        emit = K * roi * hop  # OLA positions emitted per segment
        span = K * roi + 2  # masked frames feeding the OLA halo
        a = roi + off - 1
        xr, xi = re[..., a:a + span], im[..., a:a + span]
        window = self.window
        # the global window-sum-square over the emitted positions is the
        # local OLA of window^2 over the span's VALID frames (padding
        # frames carry no window energy); the same sum as the JAX
        # package's HIGHEST conv_transpose, exact in float32 here
        w2 = frame_valid[a:a + span, None] * (window * window)
        wss = overlap_add(w2[None], hop)[0, hop:hop + emit]

        def ola(sr, si):
            spec = torch.complex(sr, si).transpose(-1, -2)
            fr = torch.fft.irfft(spec, n=n_fft, dim=-1) * window
            acc = overlap_add(fr, hop)[:, hop:hop + emit]
            wav = torch.where(wss > _TINY, acc / wss.clamp_min(_TINY), acc)
            return to_i16(wav) if self.pcm16_io else wav

        y = ola(m * xr, m * xi)
        if self.vocals_residual:
            return y, None
        return y, ola((1 - m) * xr, (1 - m) * xi)

    def _segment_direct(self, win, valid, inv_scale):
        """Mask model and reconstruction in one pass."""
        re, im = self._spectrogram(win, valid)
        # masked frames needed for the OLA: [A - 1, B + 1); the stitched
        # index of frame A - 1 = a * roi - 1 is roi - 1
        span = self.K * self.roi + 2
        m = self._masked_span(re, im, inv_scale, self.roi - 1, span)
        return self._reconstruct(m, re, im, valid)

    def _segment_mask(self, win, valid, inv_scale):
        """Postprocess phase 1: the stitched mask of the owned frames
        [A, B) only; the neighbours cover the halo."""
        re, im = self._spectrogram(win, valid)
        return self._masked_span(re, im, inv_scale, self.roi,
                                 self.K * self.roi)

    def _segment_apply(self, win, valid, mask_span):
        """Postprocess phase 2: reconstruct from a given mask span."""
        re, im = self._spectrogram(win, valid)
        return self._reconstruct(mask_span, re, im, valid)

    # -- host orchestration ----------------------------------------------

    @staticmethod
    def _wave_window(wave, lo, hi):
        """wave samples [lo, hi) with librosa-style reflect padding beyond
        the ends (only the global edges ever reflect)."""
        n = wave.shape[-1]
        if lo >= 0 and hi <= n:
            return wave[:, lo:hi]
        idx = np.abs(np.arange(lo, hi))  # left reflect
        idx = np.where(idx >= n, 2 * n - 2 - idx, idx)  # right reflect
        return wave[:, np.clip(idx, 0, n - 1)]

    def _segments(self, n_segments, n_frame, wave):
        """(k, first emitted OLA position, wave slice, frame validity)
        per segment, the slice and validity on the device."""
        _, hop, K, roi, off, _, pad, seg_frames, slice_len = self._geometry()
        dev = self.device
        for k in range(n_segments):
            a = k * K  # first owned patch
            f0 = (a - 1) * roi - off  # first segment frame (orig coords)
            lo = f0 * hop - pad
            win = self._wave_window(wave, lo, lo + slice_len)
            t = np.arange(f0, f0 + seg_frames)
            valid = ((t >= 0) & (t < n_frame)).astype(np.float32)
            yield (k, a * roi * hop, torch.from_numpy(win).to(dev),
                   torch.from_numpy(valid).to(dev))

    def _pipelined(self, produce, consume):
        """Run `produce(put, stop)` in a thread that dispatches device
        work ahead (bounded by pipeline_depth) while this thread consumes
        the results in order; errors on either side reach the caller."""
        q: queue.Queue = queue.Queue(maxsize=self.pipeline_depth)
        stop = threading.Event()

        def put(item) -> bool:
            return pipeline.put(q, item, stop)

        def producer():
            try:
                with pipeline.model_thread(self.precision):
                    produce(put, stop)
            except BaseException as e:  # re-raised in the consumer
                put(e)
                return
            put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                consume(item)
        finally:
            # the producer restores the process-wide precision mode as it
            # exits: let it do so before the caller (or the next phase)
            # runs anything else
            stop.set()
            thread.join()

    def separate_wave(self, wave: np.ndarray):
        """(2, L) wave -> (instruments, vocals), streaming segments. With
        pcm16_io, takes float or int16 input and returns int16 PCM."""
        _, hop, K, roi, _, _, pad, _, _ = self._geometry()
        L = wave.shape[-1]
        n_frame = num_frames(L, self.model.n_fft, hop)
        n_valid = -(-n_frame // roi) * roi  # frames covered by patches
        n_segments = -(-n_valid // (K * roi))

        wave = host_wave(wave, self.pcm16_io)
        mag_max, r_star, i_star = self._global_spec_stats(wave)
        if self.tta:
            # the lexicographic complex max of the PADDED spectrogram:
            # zero padding adds a (0, 0) candidate
            if 0.0 > r_star or (0.0 == r_star and 0.0 > i_star):
                r_star, i_star = 0.0, 0.0
            scale = float(np.sqrt(r_star * r_star + i_star * i_star))
        else:
            scale = mag_max
        inv_scale = float(np.float32(1.0 / scale if scale > 0 else 1.0))

        out_dtype = np.int16 if self.pcm16_io else np.float32
        y_out = np.zeros((2, L), out_dtype)
        v_out = np.zeros((2, L), out_dtype)
        emit = K * roi * hop

        def drain_waves(item):
            p0, (y_seg, v_seg) = item
            # output samples [p0 - pad, p0 - pad + emit)
            s0 = p0 - pad
            src0, dst0 = max(0, -s0), max(0, s0)
            n_copy = min(emit - src0, L - dst0)
            if n_copy <= 0:
                return
            y_host = y_seg[:, src0:src0 + n_copy].cpu().numpy()
            y_out[:, dst0:dst0 + n_copy] = y_host
            if v_seg is not None:
                v_out[:, dst0:dst0 + n_copy] = \
                    v_seg[:, src0:src0 + n_copy].cpu().numpy()
                return
            x_host = wave[:, dst0:dst0 + n_copy]  # vocals by residual
            if self.pcm16_io:
                vv = x_host.astype(np.int32) - y_host.astype(np.int32)
                v_out[:, dst0:dst0 + n_copy] = np.clip(vv, -32768, 32767)
            else:
                v_out[:, dst0:dst0 + n_copy] = x_host - y_host

        if self.postprocess:
            self._separate_postprocess(wave, n_segments, n_frame, n_valid,
                                       inv_scale, drain_waves)
        else:
            def produce(put, stop):
                for _, p0, win, valid in self._segments(n_segments, n_frame,
                                                        wave):
                    if stop.is_set() or not put(
                            (p0, self._segment_direct(win, valid,
                                                      inv_scale))):
                        return

            self._pipelined(produce, drain_waves)

        # the centred iSTFT's natural length is hop * (n_frame - 1); the
        # monolithic path zero-pads beyond it
        natural = hop * (n_frame - 1)
        if natural < L:
            y_out[:, natural:] = 0
            v_out[:, natural:] = wave[:, natural:] if self.vocals_residual \
                else 0
        return y_out, v_out

    def _separate_postprocess(self, wave, n_segments, n_frame, n_valid,
                              inv_scale, drain_waves):
        """Two streamed phases: (1) each segment's stitched mask, gathered
        into the whole-song mask on the host, (2, F, T) float32, the only
        host buffer that grows with the song; merge_artifacts on it; (2)
        the segments again, applying the refined mask."""
        _, hop, K, roi = self._geometry()[:4]
        n_bins = self.model.n_fft // 2 + 1
        full_mask = np.zeros((2, n_bins, n_valid), np.float32)

        def produce_masks(put, stop):
            for k, _, win, valid in self._segments(n_segments, n_frame,
                                                   wave):
                if stop.is_set() or not put(
                        (k, self._segment_mask(win, valid, inv_scale))):
                    return

        def drain_masks(item):
            k, m = item
            f_lo = k * K * roi
            n_take = min(K * roi, n_valid - f_lo)
            full_mask[:, :, f_lo:f_lo + n_take] = \
                m[:, :, :n_take].cpu().numpy()

        self._pipelined(produce_masks, drain_masks)
        refined = merge_artifacts(full_mask[:, :, :n_frame])
        span = K * roi + 2

        def produce_apply(put, stop):
            for k, _, win, valid in self._segments(n_segments, n_frame,
                                                   wave):
                # the mask for frames [A - 1, B + 1); frames out of range
                # meet a zeroed spectrogram, so zeros serve there
                a_roi = k * K * roi
                lo = a_roi - 1
                m_span = np.zeros((2, n_bins, span), np.float32)
                s_lo, s_hi = max(0, lo), min(n_frame, lo + span)
                if s_hi > s_lo:
                    m_span[:, :, s_lo - lo:s_hi - lo] = \
                        refined[:, :, s_lo:s_hi]
                m_span = torch.from_numpy(m_span).to(self.device)
                if stop.is_set() or not put(
                        (a_roi * hop, self._segment_apply(win, valid,
                                                          m_span))):
                    return

        self._pipelined(produce_apply, drain_waves)

    # -- global normalisation statistics (streamed device pass) ----------

    def _global_spec_stats(self, wave, chunk_frames: int = 4096):
        """One streamed device pass over the song's STFT frames ->
        (max |X|, lexicographic-max real part, its max imaginary part):
        the frames of the global spectrogram, reflect-padded edges
        included. Only TTA reads the lexicographic max; without TTA
        (r, i) are zeros."""
        n_fft, hop = self.model.n_fft, self.model.hop_length
        pad = n_fft // 2
        n_frame = num_frames(wave.shape[-1], n_fft, hop)
        mag_max, cands = 0.0, []
        for t0 in range(0, n_frame, chunk_frames):
            n = min(chunk_frames, n_frame - t0)
            lo = t0 * hop - pad
            win = torch.from_numpy(
                self._wave_window(wave, lo, lo + (n - 1) * hop + n_fft))
            x = win.to(self.device).float()
            if self.pcm16_io:
                x = x / 32768.0
            re, im = frame_spectrum(x, n_fft, hop)
            mag_max = max(mag_max, torch.sqrt(re * re + im * im).max().item())
            if self.tta:
                r_max = re.max()
                i_at = torch.where(re == r_max, im, -torch.inf).max()
                cands.append((r_max.item(), i_at.item()))
        if self.tta:
            r_star = max(r for r, _ in cands)
            i_star = max(i for r, i in cands if r == r_star)
        else:
            r_star = i_star = 0.0
        return (mag_max if mag_max > 0 else 1.0), r_star, i_star
