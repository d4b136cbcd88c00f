"""`mfu_pct`: the model's useful operations for the work the window
completed (benchmark/flops.py: convolutions, BiLSTM, dense heads, the
resizes as lerps; serving counts each song's own patches, no padding)
over the window's wall time and the precision's published peak."""


def read(run):
    w = run.work
    if "useful_flops" not in w:
        return None
    return 100.0 * w["useful_flops"] / run.window_s / w["peak_flops"]
