"""Outer iterations per solve (``SolveResult.iterations``), the mean over
the window's solves: a count of the outer loop's work."""

UNIT = "iterations"


def read(run):
    if not run.iterations:
        return None
    return sum(run.iterations) / len(run.iterations)
