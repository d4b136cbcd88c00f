"""`device_idle_pct`: share of the profiled slice in which no kernel,
copy or set ran on the card."""


def read(run):
    p = run.profile
    if p is None or p["slice_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["slice_s"])
