"""Driver `single_song`: one client, closed loop. Songs one after another
through `Separator.separate_wave(wave, pcm16_io=True, bucket=...)`, as the
separation CLI's single-file path calls it (cli/inference.py
`_run_single`), with no file I/O: int16 PCM in, int16 stems out.

The window closes at the first song that completes after `--seconds`;
a traced run then separates one more song of the stream under the
profiler. The stems of `check_songs` songs that the window finished (the
longest among them) are judged against the reference.
"""

from __future__ import annotations

import time

from benchmark import serve_common, traffic


def run(r):
    songs, lengths, sd, sep = serve_common.setup(r)
    bucket = serve_common.bucket_samples(r)
    serve_common.warm(sep, songs, lengths, bucket)
    order = traffic.stream(r.traffic["order"])
    finished, kept = [], {}

    r.log("set up and warm")
    deadline = r.open_window()
    now, cpu, took, took_cpu = time.perf_counter(), time.process_time(), [], []
    while True:
        i = next(order)
        kept.setdefault(i, sep.separate_wave(songs[i], pcm16_io=True,
                                             bucket=bucket))
        finished.append(i)
        took.append(time.perf_counter() - now)
        took_cpu.append(time.process_time() - cpu)
        now, cpu = time.perf_counter(), time.process_time()
        if now >= deadline:
            break
    r.close_window(now)
    r.log(f"songs {finished}, seconds each {took}, CPU seconds each "
          f"{took_cpu}")
    serve_common.record_work(r, finished, lengths)

    if r.trace:
        i = next(order)

        def one_song(spans):
            with spans.span("song"):
                sep.separate_wave(songs[i], pcm16_io=True, bucket=bucket)

        serve_common.profile(r, sep, one_song, lengths[i] / r.config["sr"])
    r.log("window closed")
    del sep
    serve_common.free()
    serve_common.check(r, sd, songs, lengths, kept,
                       r.traffic["check_songs"])
