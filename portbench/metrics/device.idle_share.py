"""The share of the traced solves' wall time in which no operation ran on
the device, in percent."""

UNIT = "%"


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
