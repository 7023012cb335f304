"""Set-up seconds of the AMG hierarchy's prolongations with every lmax
estimate, which smoothed interpolation and Chebyshev read
(``AMGSolver``'s phase ``interpolation``, ``portbench/setup_split.py``)."""

from portbench import setup_split

UNIT = "s"


def read(run):
    return setup_split.phase_s("interpolation")
