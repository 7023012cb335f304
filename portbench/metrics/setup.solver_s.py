"""Set-up seconds of building the cell's solver: every construction phase
of its records but the kernel library's, wherever it ran
(``portbench/setup_split.py``): the hierarchy with its routes and the
bottom inverse of ``GMGSolver``; the mesh, the P1 assembly and upload and
``AMGSolver``'s phases (with the float-float operator and the bottom
inverse built at the first solve)."""

from portbench import setup_split

UNIT = "s"


def read(run):
    return setup_split.solver_s()
