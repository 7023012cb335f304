"""Set-up seconds of the AMG cell's P1 system: the mesh, the P1 assembly
and the upload of its load and field operators (phases ``mesh``,
``p1_assembly``, ``p1_upload``, ``portbench/setup_split.py``)."""

from portbench import setup_split

UNIT = "s"


def read(run):
    return setup_split.phase_s("mesh", "p1_assembly", "p1_upload")
