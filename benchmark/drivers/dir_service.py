"""Driver `dir_service`: directories of songs through the pipelined
directory service, `SeparatorService.map`, built as the separation CLI's
directory mode builds it (cli/inference.py `_run_batch`): one `map` call
a directory, int16 PCM in and out, `vocals_residual`, `group`
equal-length songs batched into one patch stream, songs zero-padded to
whole `bucket_s` buckets by the caller (here in set-up) and the stems
trimmed back. A directory is the next `directory_songs` songs of the
pool in the traffic's order; a catalogue service runs one after another.

The window closes at the end of the first directory that completes after
`--seconds`; a traced run then separates one more directory under the
profiler. The stems of `check_songs` songs (the longest among the songs
kept) are judged against the reference.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import serve_common, traffic, weights


def stacks(tr, lengths, bucket) -> tuple[int, ...]:
    """The stack sizes the service runs on this traffic: a directory's
    songs of one bucket go `group` at a time, the rest one by one."""
    order, n, group = tr["order"], tr["directory_songs"], tr["group"]
    sizes = {1}
    for k in range(0, len(order) * n, n):  # one period of directories
        names = [order[(k + j) % len(order)] for j in range(n)]
        buckets = [-(-lengths[i] // bucket) for i in names]
        if max(buckets.count(b) for b in buckets) >= group:
            sizes.add(group)
    return tuple(sorted(sizes))


def run(r):
    from vocal_remover_tpu_torch.separate.service import SeparatorService

    tr = r.traffic
    songs, lengths, sd, sep = serve_common.setup(r)
    bucket = serve_common.bucket_samples(r)
    padded = [np.pad(s, ((0, 0), (0, -(-s.shape[1] // bucket) * bucket
                                  - s.shape[1]))) for s in songs]
    svc = SeparatorService(sep, pcm16_io=True, tta=False,
                           vocals_residual=tr["vocals_residual"],
                           group=tr["group"])

    def separate(song):
        for _ in svc.map([song]):
            pass

    serve_common.warm(sep, padded, lengths, bucket,
                      stacks(tr, lengths, bucket), separate)
    # stems kept for the check: the pool's longest song and a few drawn
    # from the seed, each at its first completion, and the window's first
    # song, so that a window too short to reach any of them still has one
    # (copies: the service's buffers are reused)
    rng = np.random.default_rng(weights.sub_seed(r.seed, 0xD1C))
    candidates = {int(np.argmax(lengths))} | {
        int(i) for i in rng.choice(len(songs), tr["check_songs"] + 1,
                                   replace=False)}
    order = traffic.stream(tr["order"])
    finished, kept = [], {}

    def directory():
        return [next(order) for _ in range(tr["directory_songs"])]

    r.log("set up and warm")
    deadline = r.open_window()
    while True:
        names = directory()
        for i, (y, v) in zip(names, svc.map(padded[i] for i in names)):
            finished.append(i)
            if (i in candidates or not kept) and i not in kept:
                n = lengths[i]
                kept[i] = (y[:, :n].copy(), v[:, :n].copy())
        now = time.perf_counter()
        if now >= deadline:
            break
    r.close_window(now)
    serve_common.record_work(r, finished, lengths)
    r.log("window closed")

    if r.trace:
        names = directory()

        def one_directory(spans):
            songs_out = svc.map(padded[i] for i in names)
            while True:
                with spans.span("caller waits for a song"):
                    if next(songs_out, None) is None:
                        break

        serve_common.profile(r, sep, one_directory,
                             sum(lengths[i] for i in names) / r.config["sr"])
    del svc, sep
    serve_common.free()
    serve_common.check(r, sd, songs, lengths, kept, tr["check_songs"])
