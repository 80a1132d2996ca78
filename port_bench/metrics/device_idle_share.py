"""1 - (union of the device's kernel, copy and set intervals) / the traced
sub-window, in %."""

LAYER = "device"
UNIT, BETTER, SOURCE, MOVES = "%", "lower", "device_trace", "output_tok_s"


def read(run):
    tr = run.trace
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
