"""Kernel-wrapper launches per solve (the port's ``LAUNCHES`` counters,
their change over the window over the solves completed in it).  Under a
CUDA graph they would count the capture and not the replays."""

UNIT = "launches"


def read(run):
    if not run.durations_s:
        return None
    total = sum(run.launches.values())
    return total / len(run.durations_s) if total else None
