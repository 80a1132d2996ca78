"""From the process's start to the window's opening: imports, the kernel
build (on a checkout's first run), the weights made and packed on the
card, the engine, the warm-up of the cell's shapes and the loop's ramp."""

UNIT, BETTER, SOURCE = "s", "lower", "host_clock"


def read(run):
    return run.setup_s
