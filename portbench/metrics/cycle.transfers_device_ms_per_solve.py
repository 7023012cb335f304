"""Device time per solve of the cycle's grid transfers: every device event
whose launch fell inside ``mg.L<k>.restrict`` (the restriction and the zero
coarse correction; the fused down-leg where a solver takes it) or
``mg.L<k>.prolong_add`` as its innermost program span
(``portbench/spans.py``; the program's spans from a profiled slice after
the run)."""

from portbench import spans

UNIT = "ms"


def _transfer(path):
    return spans.TRANSFER.fullmatch(path.rsplit("/", 1)[-1]) is not None


def read(run):
    split = spans.of_run(run)
    if split is None:
        return None
    return split.busy_ms_per_solve(_transfer)
