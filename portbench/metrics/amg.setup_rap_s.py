"""Set-up seconds of the AMG hierarchy's Galerkin products
(``AMGSolver``'s phase ``rap``, ``portbench/setup_split.py``)."""

from portbench import setup_split

UNIT = "s"


def read(run):
    return setup_split.phase_s("rap")
