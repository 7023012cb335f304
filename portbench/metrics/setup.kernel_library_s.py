"""Set-up seconds of loading the port's kernel library, once a process:
the staleness check and, in a checkout's first run, nvcc; the ``dlopen``
and the argument types (the program's ``kernel_library`` record,
``portbench/setup_split.py``).  Inside the first solve, which launches the
first kernel; left out of ``setup.first_solve_s``."""

from portbench import setup_split

UNIT = "s"


def read(run):
    return setup_split.kernel_library_s()
