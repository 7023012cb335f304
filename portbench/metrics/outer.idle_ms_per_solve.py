"""Idle device time per solve in the outer loop: every gap between device
events whose midpoint fell inside a root span (``mg.solve_refined``,
``mg.solve``) or one of the outer loop's float-float stages as the
innermost program span, outside the cycle (``portbench/spans.py``; the
program's spans from a profiled slice after the run)."""

from portbench import spans

UNIT = "ms"


def _outer(path):
    return spans.layer(path) == "outer"


def read(run):
    split = spans.of_run(run)
    if split is None:
        return None
    return split.idle_ms_per_solve(_outer)
