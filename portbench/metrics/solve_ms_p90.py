"""The 90th percentile of the times of all solves in the window
(``statistics.quantiles``, inclusive method), each solve timed between
CUDA events recorded around it: the device's clock, since a solve of 10 ms
is too short for the host's."""

import statistics

UNIT = "ms"


def read(run):
    if len(run.durations_s) < 2:
        return None
    ms = [s * 1e3 for s in run.durations_s]
    return statistics.quantiles(ms, n=10, method="inclusive")[8]
