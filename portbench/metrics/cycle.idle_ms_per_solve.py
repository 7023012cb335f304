"""Idle device time per solve in the cycle: every gap between device events
whose midpoint fell inside ``mg.outer.cycle``, a level's stage
``mg.L<k>.<stage>`` or ``mg.bottom`` (or a span beneath them) as the
innermost program span (``portbench/spans.py``; the program's spans from
a profiled slice after the run)."""

from portbench import spans

UNIT = "ms"


def _cycle(path):
    return spans.layer(path) == "cycle"


def read(run):
    split = spans.of_run(run)
    if split is None:
        return None
    return split.idle_ms_per_solve(_cycle)
