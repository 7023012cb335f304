"""Idle device time per solve: every gap between device events whose
midpoint fell inside a solve's root span (``mg.solve_refined``,
``mg.solve``) or any span beneath it, in the slice that
``portbench/kernel_split.py`` profiles after the run."""

from portbench import kernel_split, spans

UNIT = "ms"


def _in_a_solve(path):
    return path.split("/", 1)[0] in spans.ROOTS


def read(run):
    split = kernel_split.of_run(run)
    if split is None:
        return None
    return split.spans.idle_ms_per_solve(_in_a_solve)
