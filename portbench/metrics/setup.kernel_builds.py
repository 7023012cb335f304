"""Loads of the port's kernel library in the run that ran nvcc (the
program's ``COUNTERS["kernel_builds"]``): 1 in a checkout's first run or
after a source changed, else 0; ``None`` where the program has no such
counter."""

from portbench import setup_split

UNIT = "builds"


def read(run):
    return setup_split.kernel_builds()
