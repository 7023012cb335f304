"""Set-up seconds of the AMG hierarchy's strength and C/F splitting at
every level (``AMGSolver``'s phase ``coarsening``,
``portbench/setup_split.py``)."""

from portbench import setup_split

UNIT = "s"


def read(run):
    return setup_split.phase_s("coarsening")
