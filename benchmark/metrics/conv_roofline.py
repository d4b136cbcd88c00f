"""`conv_roofline` (%): the convolutions' least time on the card
(benchmark/flops.py `conv_bound_s`: each conv's useful operations at the
precision's peak or its bytes at HBM bandwidth, whichever is slower; a
training step counts the forward and both gradient products) over the
device time of the kernels launched inside `aten::convolution` (and
`aten::convolution_backward`) in the profiled slice."""


def read(run):
    p = run.profile
    if p is None or p["conv_device_s"] <= 0:
        return None
    return 100.0 * p["conv_bound_s"] / p["conv_device_s"]
