"""The part of ``setup_s`` the program does not record: ``setup_s`` less
``setup.kernel_library_s``, ``setup.solver_s`` and
``setup.first_solve_s``, which it splits with no overlap.  The harness's
own part: the imports, the CUDA context, the right-hand side pool, the
warm-ups after the first, the allocator's pre-warm and the collection.
``None`` where the program recorded nothing."""

from portbench import setup_split

UNIT = "s"


def read(run):
    if not setup_split.first_records():
        return None
    parts = (setup_split.kernel_library_s(), setup_split.solver_s(),
             setup_split.first_solve_s())
    return run.setup_s - sum(p for p in parts if p is not None)
