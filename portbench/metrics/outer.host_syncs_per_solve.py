"""Host syncs per solve: the change of the program's
``COUNTERS["host_syncs"]`` (one per scalar the solver fetches to the host)
over a profiled slice after the run, per solve in it
(``portbench/spans.py``).  ``None`` where the program has no counter."""

from portbench import spans

UNIT = "syncs"


def read(run):
    split = spans.of_run(run)
    if split is None or split.host_syncs is None:
        return None
    return split.host_syncs / split.solves
