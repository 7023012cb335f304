"""The roofline's yardstick: stage bytes and operations against hand
counts, the schedule against the program's hierarchy and launches."""

from __future__ import annotations

import math

import pytest

from portbench import registry, roofline
from portbench.tests._small import SMALL  # noqa: F401  (sets threads)

GMG = registry.load_module("solvers", "gmg")


def test_frozen_peaks_and_bound():
    assert roofline.bound(3.35e12, 0) == (1000.0, "bytes")
    assert roofline.bound(0, 67e12) == (1000.0, "operations")
    assert roofline.STENCIL_COST["ff_residual"] == (24, 60)


# (stage, sweeps) -> (bytes, flops) counted by hand
HAND_65 = {  # 65^2 = 4225 points, 63^2 = 3969 inside, 256 on the boundary
    ("smoother", 2): (12 * 4225, 12 * 4225),
    ("residual", 0): (12 * 4225, 7 * 4225),
    # the frozen 2D count: the fine read and the coarse write (4 B per
    # 33^2 coarse value) rounded up to 5 B a fine point
    ("restriction", 0): (5 * 4225, 5 * 4225),
    ("prolong_add", 0): (9 * 4225, 3 * 4225),
    ("ff_residual", 0): (24 * 3969 + 16 * 256, 60 * 3969),
    ("pair_update", 0): (20 * 4225, 10 * 4225),
    ("norm", 0): (4 * 4225, 2 * 4225),
}
HAND_17 = {  # 17^3 = 4913 points, 15^3 = 3375 inside, 1538 on the boundary
    ("smoother", 2): (12 * 4913, 18 * 4913),
    ("smoother", 100): (12 * 4913, 900 * 4913),
    ("residual", 0): (12 * 4913, 9 * 4913),
    ("restriction", 0): (4 * 4913 + 4 * 4913 / 8, 53 * 4913 / 8),
    ("prolong_add", 0): (4 * 4913 + 4 * 4913 / 8 + 4 * 4913,
                         (27 / 8 + 1) * 4913),
    ("ff_residual", 0): (24 * 3375 + 16 * 1538, 95 * 3375),
    ("pair_update", 0): (20 * 4913, 10 * 4913),
}


@pytest.mark.parametrize("shape,hand", [((65, 65), HAND_65),
                                        ((17, 17, 17), HAND_17)])
def test_stage_costs_match_hand_counts(shape, hand):
    for (stage, sweeps), (nbytes, flops) in hand.items():
        got = roofline.stage_cost(stage, shape, sweeps)
        assert got == pytest.approx((nbytes, flops), rel=1e-12), stage
    n = 9 * 9
    assert roofline.stage_cost("dense_inverse", (9, 9)) == (
        4 * n * n + 8 * n, 2 * n * n)


def test_least_seconds_of_a_hand_schedule():
    sched = [("smoother", (65, 65), 2, 3), ("norm", (65, 65), 0, 1)]
    assert roofline.least_seconds(sched) == pytest.approx(
        (3 * 12 * 4225 + 4 * 4225) / 3.35e12)


@pytest.mark.parametrize("cell", ["p2d-1025-ff32", "p3d-257-ff32"])
def test_schedule_levels_are_the_programs(cell):
    from multigrid_prj_tpu_torch.grids import build_hierarchy

    config = registry.cell(cell)["config"]
    kw = config["solver"]
    levels = build_hierarchy(kw["shape"], kw["length"], kw["num_levels"],
                             pad_align=kw.get("pad_align"))
    assert GMG.level_shapes(config) == [lev.shape for lev in levels]


@pytest.mark.parametrize("cell", ["p2d-1025-ff32", "p3d-257-ff32"])
def test_bottom_stage_is_the_programs(cell):
    config = registry.cell(cell)["config"]
    solver = GMG.build(config, "cpu")
    dense = config["bottom"]["stage"] == "dense_inverse"
    assert (solver._coarse_inv is not None) == dense
    if not dense:
        assert config["bottom"]["sweeps"] == 100  # v_cycle's coarse_sweeps


# the port's wrappers today: a smoother call launches one kernel per group
# of <= 4 sweeps, or one for every sweep on the 3D resident route (arrays
# of <= 16384 points); the 2D grid transfers and float-float residual have
# kernels, the 3D ones are plain torch
_MAX_FUSED_SWEEPS = 4
_RESIDENT_MAX_POINTS = 16384


def launches_of(sched, config: dict) -> dict:
    """The wrapper launches the port makes today for ``sched``."""
    two_d = len(config["solver"]["shape"]) == 2
    out = {}

    def add(name, n):
        out[name] = out.get(name, 0) + n

    for stage, shape, sweeps, count in sched:
        if stage == "smoother":
            resident = not two_d and math.prod(shape) <= _RESIDENT_MAX_POINTS
            per = 1 if resident else -(-sweeps // _MAX_FUSED_SWEEPS)
            add("rbgs_fused" if two_d else "rbgs3d_fused", per * count)
        elif stage == "residual":
            add("residual" if two_d else "residual3d", count)
        elif two_d and stage in ("restriction", "prolong_add",
                                 "ff_residual"):
            add({"restriction": "restrict_fw"}.get(stage, stage), count)
    return out


# launches of chip_smoke's solves (PR 14 on the H100): 1025^2 at 9
# iterations 90 rbgs_fused, 45 residual / restrict_fw / prolong_add, 10
# ff_residual; config 4 at 11 iterations 99 rbgs3d_fused, 44 residual3d
@pytest.mark.parametrize("cell,k,expected", [
    ("p2d-1025-ff32", 9, {"rbgs_fused": 90, "residual": 45,
                          "restrict_fw": 45, "prolong_add": 45,
                          "ff_residual": 10}),
    ("p3d-257-ff32", 11, {"rbgs3d_fused": 99, "residual3d": 44})])
def test_schedule_launches_match_the_recorded_counts(cell, k, expected):
    c = registry.cell(cell)
    sched = GMG.schedule(c["config"], c["entry"], k)
    assert launches_of(sched, c["config"]) == expected


def test_schedule_is_none_where_it_does_not_describe_the_entry():
    config = registry.cell("p2d-1025-ff32")["config"]
    assert GMG.schedule(config, "solve", 9) is None


@pytest.mark.parametrize("cell,lo,hi", [("p2d-1025-ff32", 0.3e-3, 0.5e-3),
                                        ("p3d-257-ff32", 5e-3, 8e-3)])
def test_least_time_of_the_cells(cell, lo, hi):
    c = registry.cell(cell)
    k = 9 if "2d" in cell else 11
    assert lo < roofline.least_seconds(
        GMG.schedule(c["config"], c["entry"], k)) < hi
