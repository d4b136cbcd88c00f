"""`xrt` (song-s/s): seconds of songs whose PCM16 stems are back on the
host, over the window's wall time (closed at the first song that
completes after --seconds). End to end, from the host clock."""


def read(run):
    if run.trace or "song_seconds" not in run.work:
        return None
    return run.work["song_seconds"] / run.window_s
