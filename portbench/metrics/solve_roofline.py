"""The traced solves' share of the card's roofline, in percent: the least
time their work could take (``roofline.least_seconds`` of the family's
stage schedule at each solve's iteration count, on logical points) over
the summed device time of everything they launched.  Both sides take in
every stage of the solve, the ``csrc`` kernels and the plain-torch
operations alike, so this is the whole device's share, not one kernel's."""

from portbench import roofline

UNIT = "%"


def read(run):
    tr = run.trace
    if tr is None or not tr.solves or tr.busy_s <= 0:
        return None
    config, entry = run.cell["config"], run.cell["entry"]
    least = 0.0
    for iterations in tr.iterations:
        sched = run.family.schedule(config, entry, iterations)
        if sched is None:
            return None
        least += roofline.least_seconds(sched)
    return 100.0 * least / tr.busy_s
