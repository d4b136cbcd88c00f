"""`launches_per_step`: kernel launches in the profiled slice per
training step."""


def read(run):
    p = run.profile
    if p is None or "samples" not in run.work or not p.get("steps"):
        return None
    return p["launches"] / p["steps"]
