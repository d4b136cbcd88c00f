"""`train_samples_per_s`: crops trained (forward, backward, Adam) over
the window's wall time, which closes when the window's epoch call
returns, synchronized. End to end, from the host clock."""


def read(run):
    if run.trace or "samples" not in run.work:
        return None
    return run.work["samples"] / run.window_s
