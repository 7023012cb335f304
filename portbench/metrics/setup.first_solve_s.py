"""Set-up seconds of the first warm-up solve: its root span's host time,
ended just after the solve's last fetch, less the set-up phases inside it
(the kernel library, AMG's bottom inverse and float-float operator), as
the program records it once per solver (``portbench/setup_split.py``)."""

from portbench import setup_split

UNIT = "s"


def read(run):
    return setup_split.first_solve_s()
