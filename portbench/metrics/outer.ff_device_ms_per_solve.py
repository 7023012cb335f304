"""Device time per solve of the outer loop's float-float arithmetic: every
device event whose launch fell inside ``mg.outer.split``,
``mg.outer.ff_residual``, ``mg.fetch``, ``mg.outer.pair_update`` or
``mg.outer.combine`` as its innermost program span, outside the cycle
(``portbench/spans.py``; the program's spans from a profiled slice after
the run)."""

from portbench import spans

UNIT = "ms"


def _outer_stage(path):
    return (spans.layer(path) == "outer"
            and path.rsplit("/", 1)[-1] in spans.OUTER)


def read(run):
    split = spans.of_run(run)
    if split is None:
        return None
    return split.busy_ms_per_solve(_outer_stage)
