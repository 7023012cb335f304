"""The least time a solve's work could take on one H100.

``HBM_BYTES_PER_S``, ``F32_FLOPS_PER_S``, ``STENCIL_COST`` and
:func:`bound` are frozen copies of ``chip_smoke.py``'s (as of PR 14), so
that the yardstick does not move when the program does.  A solve is
counted as a schedule of algorithmic stages (the solver family's
``schedule``), each reading its inputs once and writing its outputs once
on the logical points of its level, whatever kernels carry it out;
:func:`stage_cost` gives a stage's bytes and float32 operations.
"""

from __future__ import annotations

import math

# published H100 SXM peaks (NVIDIA's H100 datasheet): HBM bytes/s and f32
# flop/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# (bytes, flops) per point of each stencil kernel's timed call, f32: every
# input read once and every output written once (the transfers per fine
# point); the timed calls are 2 sweeps of the smoothers (Jacobi and 3D
# Jacobi with omega 0.8), the down-leg with 2 sweeps, 8 chained applies
STENCIL_COST = {
    "rbgs_fused": (12, 12), "rbgs_color": (12, 12), "residual": (12, 7),
    "ff_residual": (24, 60),
    "apply": (8, 6), "jacobi": (12, 18), "jacobi_sweep": (12, 18),
    "restrict_fw": (5, 5), "prolong_add": (9, 3),
    "prolong_add_point": (9, 3), "rbgs_resfilter": (13, 24),
    "apply_chain": (8, 48), "apply_chain_tile48": (8, 48),
    "rbgs_color_sweep": (12, 3),
    "apply3d": (8, 8), "apply3d_point": (8, 8), "residual3d": (12, 9),
    "residual3d_point": (12, 9),
    "rbgs3d_fused": (12, 18),
    "rbgs3d_color": (12, 18),
    "jacobi3d": (12, 24), "jacobi3d_sweep": (12, 24),
    "rbgs_fused_ext": (12, 24)}


def bound(nbytes, flops):
    """The least time (ms) the card could take for work that moves
    ``nbytes`` and does ``flops`` f32 operations, and which of the two
    bounds it (published H100 SXM peaks)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# float32 operations per interior point of the float-float residual: 60 in
# 2D (STENCIL_COST); in 3D the 6 u start as the pair sum 4 u + 2 u (4
# products and an 11-operation pair add), then six neighbour pair adds,
# the pair subtraction from b / c and the two products and sum
_FF_RESIDUAL_3D_FLOPS = 4 + 11 + 6 * 11 + 11 + 3


def stage_cost(stage: str, shape, sweeps: int = 0):
    """``(bytes, flops)`` of one visit of ``stage`` on a level whose
    logical grid is ``shape``.  Grid transfers are counted per point of
    the fine level they run between."""
    d = len(shape)
    npts = math.prod(shape)
    inside = math.prod(n - 2 for n in shape)
    coarse_per_fine = 3 ** d / 2 ** d  # coarse values a fine point mixes
    if stage == "smoother":  # u and b read, u written, per call
        per_sweep = (STENCIL_COST["rbgs_fused"][1] if d == 2
                     else STENCIL_COST["rbgs3d_fused"][1]) / 2
        return 12 * npts, per_sweep * sweeps * npts
    if stage == "residual":
        per = STENCIL_COST["residual" if d == 2 else "residual3d"]
        return per[0] * npts, per[1] * npts
    if stage == "restriction":  # fine read, coarse written
        if d == 2:
            per = STENCIL_COST["restrict_fw"]
            return per[0] * npts, per[1] * npts
        return (4 + 4 / 2 ** d) * npts, (2 * 3 ** d - 1) / 2 ** d * npts
    if stage == "prolong_add":  # u and coarse e read, u written
        if d == 2:
            per = STENCIL_COST["prolong_add"]
            return per[0] * npts, per[1] * npts
        return (8 + 4 / 2 ** d) * npts, (coarse_per_fine + 1) * npts
    if stage == "ff_residual":  # u pair, b / c pair, b read; r written
        flops = (STENCIL_COST["ff_residual"][1] if d == 2
                 else _FF_RESIDUAL_3D_FLOPS)
        return 24 * inside + 16 * (npts - inside), flops * inside
    if stage == "pair_update":  # u pair and e read, u pair written
        return 20 * npts, 10 * npts
    if stage == "norm":
        return 4 * npts, 2 * npts
    if stage == "split":  # b read, the b / c pair written
        return 12 * npts, 4 * npts
    if stage == "combine":  # the u pair read, u written
        return 12 * npts, npts
    if stage == "dense_inverse":  # the inverse and b read, x written
        return 4 * npts * npts + 8 * npts, 2 * npts * npts
    raise ValueError(f"no cost for stage {stage!r}")


def least_seconds(schedule) -> float:
    """The least time of a schedule of ``(stage, shape, sweeps, count)``:
    each stage is a pass of its own, bound by bytes or by operations."""
    return sum(count * bound(*stage_cost(stage, shape, sweeps))[0] / 1e3
               for stage, shape, sweeps, count in schedule)
