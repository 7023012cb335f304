"""The least time of a solve whose corrections are V-cycle-preconditioned
conjugate gradients (``GMGSolver.solve_refined(b, inner_cg=k)``), on one
H100.

:func:`stage_cost` adds to ``roofline.stage_cost`` (unchanged, and used
for every stage it knows) the stages of the Krylov loop and of the fused
outer step, each reading its inputs once and writing its outputs once on
the logical points of the finest level, in float32:

* ``apply``: ``A p``, p read and ``A p`` written (``STENCIL_COST["apply"]``,
  8 B and 6 operations a point);
* ``dot``: a dot product, two vectors read (8 B, 2 operations);
* ``update``: ``y + a x``, two vectors read and one written (12 B, 2
  operations);
* ``ff_update_residual``: the outer pair update fused with the
  float-float residual after it: the u pair, e, the b / c pair and b read,
  the new u pair and r written, 36 B inside; at the boundary, where the
  residual is b - u, 28 B (``PERF.md`` row 3b); the update's 10 and the
  residual's 60 operations inside, the update's 10 at the boundary.

:func:`least_seconds` prices a schedule of ``(stage, shape, sweeps,
count)`` as ``roofline.least_seconds`` does, each stage a pass of its own
bound by bytes or by operations.
"""

from __future__ import annotations

import math

from portbench import roofline

APPLY_BYTES, APPLY_FLOPS = roofline.STENCIL_COST["apply"]
DOT_BYTES, DOT_FLOPS = 8, 2
UPDATE_BYTES, UPDATE_FLOPS = 12, 2
FF_UPDATE_RESIDUAL_BYTES = (36, 28)  # inside, at the boundary
PAIR_UPDATE_FLOPS = 10


def stage_cost(stage: str, shape, sweeps: int = 0):
    """``(bytes, flops)`` of one visit of ``stage`` on a level whose
    logical grid is ``shape``."""
    npts = math.prod(shape)
    if stage == "apply":
        return APPLY_BYTES * npts, APPLY_FLOPS * npts
    if stage == "dot":
        return DOT_BYTES * npts, DOT_FLOPS * npts
    if stage == "update":
        return UPDATE_BYTES * npts, UPDATE_FLOPS * npts
    if stage == "ff_update_residual":
        inside = math.prod(n - 2 for n in shape)
        _, residual_flops = roofline.stage_cost("ff_residual", shape)
        inner_b, edge_b = FF_UPDATE_RESIDUAL_BYTES
        return (inner_b * inside + edge_b * (npts - inside),
                PAIR_UPDATE_FLOPS * npts + residual_flops)
    return roofline.stage_cost(stage, shape, sweeps)


def least_seconds(schedule) -> float:
    """The least time of a schedule of ``(stage, shape, sweeps, count)``."""
    return sum(count * roofline.bound(*stage_cost(stage, shape, sweeps))[0]
               / 1e3 for stage, shape, sweeps, count in schedule)

