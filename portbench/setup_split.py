"""The program's set-up records, split into the parts the ``setup.*`` and
``amg.setup_*`` metrics read.

The program keeps one record per object it sets up (the solver, the mesh
and the P1 system of the AMG cell, the kernel library), each phase's self
seconds by the host's clock, so no second counts twice, and the solver's
first solve (``multigrid_prj_tpu_torch/utils/metrics.py``: ``PhaseTimer``
with an owner, the first few of a process in ``SETUP_LOG``, in the order
they were made).  The harness builds the cell's solver first; a traced run
builds solvers again after its set-up (``spans.py``, ``kernel_split.py``),
so every part here reads each owner's first record.  A program that keeps
no such log, or recorded nothing, gives ``None``.
"""

from __future__ import annotations

import importlib

KERNEL_LIBRARY = "kernel_library"  # the kernel library's record


def _program():
    return importlib.import_module("multigrid_prj_tpu_torch.utils.metrics")


def first_records() -> dict:
    """``{owner: its first record}``, empty where nothing was recorded."""
    out = {}
    for record in getattr(_program(), "SETUP_LOG", ()):
        out.setdefault(record.owner, record)
    return out


def phase_s(*names: str) -> float | None:
    """The seconds of the phases ``names`` over the first records, or
    ``None`` where none of them was recorded."""
    found = [s for r in first_records().values()
             for name, s in r.phases.items() if name in names]
    return sum(found) if found else None


def kernel_library_s() -> float | None:
    """The kernel library's load: its build where nvcc ran, the load and
    the argument types."""
    record = first_records().get(KERNEL_LIBRARY)
    return None if record is None else sum(record.phases.values())


def solver_s() -> float | None:
    """Every construction phase of the cell's objects but the kernel
    library, wherever it ran (the AMG bottom inverse and float-float
    operator at the first solve too)."""
    found = [sum(r.phases.values()) for owner, r in first_records().items()
             if owner != KERNEL_LIBRARY]
    return sum(found) if found else None


def first_solve_s() -> float | None:
    """The first solve's self seconds (less the set-up phases inside it)."""
    found = [r.first_solve_s for r in first_records().values()
             if r.first_solve_s is not None]
    return sum(found) if found else None


def kernel_builds() -> int | None:
    """``COUNTERS["kernel_builds"]``: the loads that ran nvcc."""
    return getattr(_program(), "COUNTERS", {}).get("kernel_builds")
