"""`setup_s`: process start to the window's start (imports, CUDA, inputs
and weights made, the program built, every shape warmed; the first run
in a checkout also builds the port's kernels)."""


def read(run):
    return None if run.trace else run.setup_s
