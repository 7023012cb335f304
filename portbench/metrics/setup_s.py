"""Set-up time: from the start of ``run.py`` (before torch is imported)
to the end of the warm-up solves, so the torch import, the CUDA context,
loading (or, in a checkout's first run, building) the port's kernels, the
right-hand side pool, the solver's hierarchy and the warm-up."""

UNIT = "s"


def read(run):
    return run.setup_s
