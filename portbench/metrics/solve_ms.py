"""Time to a solution: the measured window over the solves completed in
it, so every host and device moment of the window counts."""

UNIT = "ms"


def read(run):
    if not run.durations_s:
        return None
    return run.window_s / len(run.durations_s) * 1e3
