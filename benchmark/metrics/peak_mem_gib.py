"""`peak_mem_gib`: torch.cuda.max_memory_allocated over the window, the
peak reset as it opens."""


def read(run):
    if not run.peak_bytes:
        return None
    return run.peak_bytes / 2**30
