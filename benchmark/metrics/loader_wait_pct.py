"""`loader_wait_pct`: `Trainer.loader_wait_s` (host seconds the window's
steps waited for their batch) over the window's wall time."""


def read(run):
    if "loader_wait_s" not in run.counters:
        return None
    return 100.0 * run.counters["loader_wait_s"] / run.window_s
