"""Pipelined separation of many songs: directory-mode serving.

Counterpart of vocal_remover_tpu/separate/service.py `SeparatorService`.
Three stages overlap, each on its own thread:

    uploader:   host song -> pinned host buffer -> device, on a side
                stream; an event marks the end of the copy;
    dispatcher: the compute stream waits on that event and runs the
                separation, then copies the stems device -> pinned host;
                an event marks the end of that copy;
    caller:     waits on that event, then reads the stems (`map`).

Spans (utils/trace.py): `service.upload` on the uploader;
`service.wait_upload`, `service.dispatch` (with the Separator's
`separate` inside) and `service.wait_room` on the dispatcher;
`service.wait_song` and `service.residual` in the caller.

Pinned buffers come from PyTorch's caching host allocator, which is a
ring of pinned blocks: a block is handed out again only after the copy
recorded on it has finished. Songs are written into them once (no
pageable staging copy), and the stems are yielded as numpy views of
theirs. On the CPU the same stages run without streams or pinning.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from vocal_remover_tpu_torch.separate import pipeline
from vocal_remover_tpu_torch.separate.separator import host_wave
from vocal_remover_tpu_torch.utils import trace


def _to_host(t, pin: bool):
    """Copy device tensor `t` to a (pinned) host tensor without waiting:
    read it only after an event recorded behind the copy."""
    if not pin:
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


class SeparatorService:
    def __init__(self, separator, pcm16_io: bool = True, tta: bool = False,
                 depth: int = 3, vocals_residual: bool = False,
                 group: int = 1, max_pending: int | None = None):
        """separator: a `Separator`; its device, precision, crop and
        batch are the service's.

        depth: how many batches each stage may run ahead of the next.

        vocals_residual (with pcm16_io): download only the instruments
        and reconstruct the vocals on the host as clip(mixture -
        instruments) in int16 (exact at PCM16 resolution by the iSTFT's
        linearity, away from the song's first and last half-window); the
        vocals iSTFT is skipped.

        group: cross-song patch batching. Equal-length songs are stacked
        `group` at a time and run as one merged patch stream
        (`Separator.separate_waves`'s path). Songs are buffered per
        length, so interleaved lengths still form full groups; outputs
        are yielded in input order. Partial groups left at the end run
        per song, with no repeat-padding.

        max_pending: bound on the songs held for grouping (default
        max(8, 4 * group)); past it, the buffer holding the oldest song
        is flushed through the per-song path."""
        self.sep = separator
        self.pcm16_io = pcm16_io
        self.tta = tta
        self.depth = depth
        self.vocals_residual = vocals_residual
        self.group = max(1, group)
        self.max_pending = max_pending or max(8, 4 * self.group)

    def _batches(self, waves):
        """(input indices, songs) in dispatch order: a group as soon as
        `group` songs of one length are held; past `max_pending` held
        songs, the buffer of the oldest one, song by song; at the end the
        leftovers, song by song, oldest buffer first."""
        buffers: dict = {}  # length -> [(idx, song), ...]
        pending = 0
        for idx, w in enumerate(waves):
            buf = buffers.setdefault(w.shape[-1], [])
            buf.append((idx, w))
            pending += 1
            if len(buf) == self.group:
                del buffers[w.shape[-1]]
                pending -= self.group
                yield tuple(i for i, _ in buf), [s for _, s in buf]
            elif pending > self.max_pending:
                key = min(buffers, key=lambda k: buffers[k][0][0])
                for i, s in buffers.pop(key):
                    pending -= 1
                    yield (i,), [s]
        for buf in sorted(buffers.values(), key=lambda b: b[0][0]):
            for i, s in buf:
                yield (i,), [s]

    def map(self, waves):
        """Separate an iterable of (2, n) waves; yields (instruments,
        vocals) host arrays in input order, int16 with `pcm16_io`. An
        exception in any stage, the input iterator's included, is raised
        here."""
        sep, tta, pcm16 = self.sep, self.tta, self.pcm16_io
        resid = self.vocals_residual and pcm16
        dev = sep.device
        cuda = dev.type == "cuda"
        upload = torch.cuda.Stream(dev) if cuda else None
        compute = torch.cuda.Stream(dev) if cuda else None
        dtype = torch.int16 if pcm16 else torch.float32
        q_up: queue.Queue = queue.Queue(maxsize=self.depth)
        q_out: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()

        def uploader():
            try:
                for idxs, songs in self._batches(waves):
                    with trace.span("service.upload"):
                        songs = [host_wave(s, pcm16) for s in songs]
                        host = torch.empty((len(songs), *songs[0].shape),
                                           dtype=dtype, pin_memory=cuda)
                        stack = host.numpy()
                        for k, s in enumerate(songs):
                            stack[k] = s
                        ev = None
                        if cuda:
                            with torch.cuda.stream(upload):
                                x = host.to(dev, non_blocking=True)
                                ev = torch.cuda.Event()
                                ev.record(upload)
                        else:
                            x = host
                        if not pipeline.put(q_up, (x, ev, songs, idxs), stop):
                            return
            except BaseException as e:  # re-raised in the caller by `map`
                pipeline.put(q_up, e, stop)
                return
            pipeline.put(q_up, None, stop)

        def dispatcher():
            try:
                with pipeline.model_thread(sep.precision, compute):
                    while True:
                        with trace.span("service.wait_upload"):
                            item = pipeline.get(q_up, stop)
                        if item is None or isinstance(item, BaseException):
                            pipeline.put(q_out, item, stop)
                            return
                        x, ev, songs, idxs = item
                        with trace.span("service.dispatch"), \
                                trace.span("separate"):
                            if ev is not None:
                                compute.wait_event(ev)
                                # x was allocated on the upload stream:
                                # keep its memory from reuse until
                                # compute is done
                                x.record_stream(compute)
                            y, v = sep._separate(x, tta, pcm16, resid)
                            y = _to_host(y, cuda)
                            v = None if v is None else _to_host(v, cuda)
                            done = None
                            if cuda:
                                done = torch.cuda.Event()
                                done.record(compute)
                            del x
                        with trace.span("service.wait_room"):
                            if not pipeline.put(
                                    q_out, (done, y, v, songs, idxs), stop):
                                return
            except BaseException as e:  # re-raised in the caller by `map`
                pipeline.put(q_out, e, stop)

        threads = [threading.Thread(target=uploader, daemon=True),
                   threading.Thread(target=dispatcher, daemon=True)]
        for t in threads:
            t.start()
        done_songs: dict = {}  # input index -> (y, v)
        next_idx, finished = 0, False
        try:
            while True:
                while next_idx in done_songs:
                    yield done_songs.pop(next_idx)
                    next_idx += 1
                if finished:
                    return
                with trace.span("service.wait_song"):
                    item = q_out.get()
                    if isinstance(item, tuple) and item[0] is not None:
                        item[0].synchronize()  # the stems' copy is done
                if item is None:
                    finished = True
                    continue
                if isinstance(item, BaseException):
                    raise item
                _, y, v, songs, idxs = item
                with trace.span("service.residual"):
                    y = y.numpy()
                    v = None if v is None else v.numpy()
                    for k, idx in enumerate(idxs):
                        if resid:
                            vv = (songs[k].astype(np.int32)
                                  - y[k].astype(np.int32))
                            done_songs[idx] = (y[k], np.clip(
                                vv, -32768, 32767).astype(np.int16))
                        else:
                            done_songs[idx] = (y[k], v[k])
        finally:
            # the dispatcher restores the process-wide precision mode as it
            # exits: let it do so before the caller runs anything else
            stop.set()
            for t in threads:
                t.join()
