"""What the serving drivers share: the songs, the warm-up, the benchmark's
spans around the separation layers, the work a window completed, and
the check of its stems."""

from __future__ import annotations

import gc
import threading
import time

import numpy as np
import torch

from benchmark import check_serve, flops, program, trace, traffic, weights


def inputs(r):
    """(songs, lengths, state dict) of a serving run, from its seed."""
    cfg, tr, dev = r.config, r.traffic, r.device
    lengths = traffic.pool_lengths(tr["songs"], cfg["sr"])
    songs = traffic.make_songs(lengths, cfg["sr"], tr["songs"]["tones"],
                               r.seed, dev)
    return songs, lengths, weights.make_state_dict(cfg, r.seed, dev)


def setup(r):
    """(songs, lengths, state dict, Separator) of a serving run."""
    from vocal_remover_tpu_torch.separate.separator import Separator

    cfg, tr, dev = r.config, r.traffic, r.device
    songs, lengths, sd = inputs(r)
    net = program.model(cfg, sd, dev, tr["precision"])
    sep = Separator(net, batchsize=tr["batchsize"], cropsize=tr["cropsize"],
                    device=dev,
                    precision=program.compute_precision(tr["precision"]))
    return songs, lengths, sd, sep


def bucket_samples(r) -> int:
    return int(r.traffic["bucket_s"] * r.config["sr"])


def warm(sep, songs, lengths, bucket: int, stacks=(1,), separate=None):
    """Build every shape the window will use: one bucket of the shortest
    song through `separate` (default `sep.separate_wave`): a chunk of the
    model and every op around it; then the STFT and iSTFT at each
    bucketed length of the pool, for each stack size in `stacks`."""
    from vocal_remover_tpu_torch.ops.stft import istft, stft

    i = int(np.argmin(lengths))
    first = songs[i][:, :bucket]
    if separate is None:
        sep.separate_wave(first, pcm16_io=True, bucket=bucket)
    else:
        separate(first)
    n_fft, hop = sep.model.n_fft, sep.model.hop_length
    with torch.inference_mode():
        for n in sorted({-(-n // bucket) * bucket for n in lengths}):
            for s in stacks:
                x = torch.zeros(s, 2, n, device=sep.device)
                re, im = stft(x, n_fft, hop)
                istft(re, im, n_fft, hop, n)
    if sep.device.type == "cuda":
        torch.cuda.synchronize(sep.device)


def record_work(r, finished: list[int], lengths: list[int]):
    """The window's work: song-seconds, songs, useful model operations."""
    cfg, tr = r.config, r.traffic
    per_patch = flops.forward_flops(cfg, 1, tr["cropsize"])["total"]
    r.attempted = len(finished)
    r.work = {
        "songs": len(finished),
        "song_seconds": sum(lengths[i] for i in finished) / cfg["sr"],
        "useful_flops": per_patch * sum(
            flops.useful_patches(lengths[i], cfg, tr["cropsize"])
            for i in finished),
        "peak_flops": flops.PEAKS[program.compute_precision(
            tr["precision"])],
    }


class LayerSpans:
    """The benchmark's spans around the separation layers: `separate`
    (the device pipeline of a song or a stack: upload, STFT, model,
    iSTFT), `model chunk` (one forward of the model, by hooks), `host
    between chunks` (after a chunk until the next one or the end of the
    pipeline); and the model forwards counted."""

    def __init__(self, sep, spans: trace.Spans):
        self.spans = spans
        self.chunks = 0
        self._local = threading.local()
        self._inner = sep._separate
        self._sep = sep
        self._hooks = [sep.model.register_forward_pre_hook(self._pre),
                       sep.model.register_forward_hook(self._post)]
        sep._separate = self._separate  # instance attribute: one wrapper

    def _open(self, name):
        self._close()
        self._local.cur = (name, time.time_ns())

    def _close(self):
        cur = getattr(self._local, "cur", None)
        if cur is not None:
            self.spans.add(cur[0], cur[1], time.time_ns())
            self._local.cur = None

    def _pre(self, module, args):
        self._open("model chunk")

    def _post(self, module, args, out):
        self.chunks += 1
        self._open("host between chunks or after the model")

    def _separate(self, *args, **kwargs):
        with self.spans.span("separate"):
            self._local.cur = None
            try:
                return self._inner(*args, **kwargs)
            finally:
                self._close()

    def remove(self):
        for h in self._hooks:
            h.remove()
        del self._sep._separate


def profile(r, sep, fn, audio_seconds: float):
    """Profile `fn()` (a steady slice of the cell) with the layer spans;
    sets `r.profile`, with the slice's chunks, audio and bounds."""
    cfg, tr = r.config, r.traffic
    spans = trace.Spans()
    layer = LayerSpans(sep, spans)
    try:
        prof = trace.profile_slice(lambda: fn(spans), spans,
                                   attribute=("aten::convolution",),
                                   kernel_groups={"recurrence":
                                                  "lstm_recurrence"})
    finally:
        layer.remove()
    n, crop = tr["batchsize"], tr["cropsize"]
    prec = program.compute_precision(tr["precision"])
    prof["audio_minutes"] = audio_seconds / 60.0
    prof["conv_bound_s"] = layer.chunks * flops.conv_bound_s(cfg, n, crop,
                                                             prec)
    prof["conv_device_s"] = prof["attributed_s"]["aten::convolution"]
    prof["recurrence_bound_s"] = layer.chunks * sum(
        flops.recurrence_bound_s(*launch)
        for launch in flops.recurrence_launches(cfg, n, crop))
    r.profile = prof


def free():
    """Return the memory of the program's state, which the caller has
    dropped, before the reference runs."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def check(r, sd, songs, lengths, kept: dict, count: int):
    """Judge the window's stems of `count` sampled songs against the
    reference; sets `r.checks`."""
    chosen = check_serve.sample(list(kept), lengths, r.seed, count)
    ref = check_serve.reference_stems(r.config, sd, r.traffic,
                                      {i: songs[i] for i in chosen}, r.device)
    r.checks = check_serve.numbers({i: kept[i] for i in chosen}, ref)
