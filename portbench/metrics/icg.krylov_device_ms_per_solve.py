"""Device time per solve of the Krylov loop's vector arithmetic: every
device event launched with ``mg.cg.dot``, ``mg.cg.update`` or
``mg.cg.mask`` as its innermost program span, or with the ``mg.fetch`` of
a CG stop test (the one directly inside ``mg.outer.cycle``), in the slice
that ``portbench/kernel_split.py`` profiles after the run.  Neither the
operator apply nor the preconditioner's cycle is counted.  ``None`` where
the program opens no ``mg.cg.*`` span."""

from portbench import kernel_split

UNIT = "ms"
VECTOR = ("mg.cg.dot", "mg.cg.update", "mg.cg.mask")
STOP_TEST = "mg.outer.cycle/mg.fetch"


def _vector_arithmetic(path):
    return path.rsplit("/", 1)[-1] in VECTOR or path.endswith(STOP_TEST)


def read(run):
    split = kernel_split.of_run(run)
    if split is None or not any("/mg.cg." in p for p in split.spans.busy):
        return None
    return split.spans.busy_ms_per_solve(_vector_arithmetic)
