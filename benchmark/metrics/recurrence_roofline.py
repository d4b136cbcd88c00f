"""`recurrence_roofline` (%): the BiLSTM recurrence kernel's least time
(benchmark/flops.py `recurrence_bound_s`, the arithmetic of chip_smoke.py
`phase_recurrence`: bytes of xg, w_hh and the output, or the recurrent
products at the float32 peak) over the device time of the kernels named
`lstm_recurrence*` in the profiled slice."""


def read(run):
    p = run.profile
    if p is None or "song_seconds" not in run.work:
        return None
    t = p["groups_s"].get("recurrence", 0.0)
    return 100.0 * p["recurrence_bound_s"] / t if t > 0 else None
