"""``torch.cuda.max_memory_allocated()`` over set-up and window, GiB."""

UNIT, BETTER, SOURCE = "GiB", "lower", "host_clock"


def read(run):
    return run.peak_bytes / 2**30
