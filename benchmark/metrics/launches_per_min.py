"""`launches_per_min`: kernel launches in the profiled slice per minute
of audio it separated."""


def read(run):
    p = run.profile
    if p is None or "song_seconds" not in run.work \
            or not p.get("audio_minutes"):
        return None
    return p["launches"] / p["audio_minutes"]
