"""The ``p2d-8193-icg4`` cell's comparison, family and cost model, on the
CPU.

* the port's float32 ``solve_refined(b, inner_cg=4)`` at 129^2 and 257^2,
  on the plain route and on the kernel route's CPU twins, meets the cell's
  ``u_rel_err`` limit and ``tol`` against its plain reference
  (``poisson_mg``, whose float64 solution of the system is the one any
  algorithm reaches); the reference's float32 defect correction does not,
  nor does an answer altered by 1e-6;
* the family's schedule at 8193^2 and ``krylov_cost``'s price of it, and
  ``icg.apply_roofline``'s price of an apply launch, against numbers
  worked by hand.
"""

from __future__ import annotations

import copy
import math
import types

import pytest
import torch

from portbench import control, harness, krylov_cost, registry, traffic
from portbench.tests._small import small_cell

CELL = "p2d-8193-icg4"
mg = registry.load_module("reference", "poisson_mg")
family = registry.load_module("solvers", "gmg_pcg")


def _cell_at(n, levels, route):
    cell = copy.deepcopy(registry.cell(CELL))
    cell["config"]["solver"].update(shape=[n, n], num_levels=levels,
                                    pad_align=128,
                                    use_pallas=route == "kernel")
    return cell


def _checks(cell, seed, answer, count=2):
    """``harness.compare`` of ``answer(b)`` (``(u, residual, converged)``)
    for the first ``count`` right-hand sides of the cell's pool."""
    kw = cell["config"]["solver"]
    problem = registry.load_module("problems", cell["config"]["problem"])
    pool = traffic.make_pool(problem, kw["shape"], kw["length"],
                             cell["traffic"], seed, "cpu")[:count]
    answers, residuals, failed = [], [], 0
    for j, b in enumerate(pool):
        u, residual, converged = answer(b)
        answers.append((j, u))
        residuals.append(residual)
        failed += not converged
    return dict((name, (value, limit)) for name, value, limit
                in harness.compare(cell, pool, answers, residuals, failed))


@pytest.mark.parametrize("route", ["plain", "kernel"])
@pytest.mark.parametrize("n,levels", [(129, 4), (257, 5)])
def test_port_meets_the_limit_against_the_reference(n, levels, route):
    torch.set_num_threads(2)
    cell = _cell_at(n, levels, route)
    solver = family.build(cell["config"], "cpu")
    assert solver.inner_cg == 4
    on_kernels = solver.solver._f32_route is not solver.solver._plain_route
    assert on_kernels is (route == "kernel")

    def port(b, scale=1.0):
        ans = family.solve(solver, cell["entry"], b)
        return ans.u * scale, ans.residual, ans.converged

    checks = _checks(cell, 2 ** 31 + n, port)
    assert all(value <= limit for value, limit in checks.values()), checks
    assert checks["u_rel_err"][0] < checks["u_rel_err"][1] / 3
    altered = _checks(cell, 2 ** 31 + n, lambda b: port(b, 1 + 1e-6))
    assert altered["u_rel_err"][0] > altered["u_rel_err"][1]


@pytest.mark.parametrize("n,levels", [(129, 4), (257, 5)])
def test_float32_defect_correction_fails_the_limit(n, levels):
    torch.set_num_threads(2)
    cell = _cell_at(n, levels, "plain")
    kw = cell["config"]["solver"]

    def lower(b):
        u, _, rel = mg.defect_correction(b, kw["alpha"], kw["length"],
                                          torch.float32, kw["tol"], 50)
        return u, rel, rel <= kw["tol"]

    checks = _checks(cell, 2 ** 31 + n, lower)
    value, limit = checks["u_rel_err"]
    assert value > limit, checks


def test_small_cell_is_correct_and_its_controls_are_not():
    cell = small_cell(CELL)
    assert cell["config"]["inner_cg"] == 4
    out = control.readings(cell, 13, "cpu", controls=True)
    sound = out["program"]["u_rel_err"]
    assert sound < cell["limits"]["u_rel_err"]
    assert out["program"]["residual"] <= cell["config"]["solver"]["tol"]
    for entry in control.CONTROLS:
        r = out[entry]
        assert r["residual"] > cell["config"]["solver"]["tol"], entry
        assert not r["u_rel_err"] < 3 * sound, (entry, r, sound)


# 8193^2 by hand: N points of each level above the 65^2 bottom, the L0
# interior, and a 4-iteration solve of 4 CG steps a correction, each step
# one apply and one cycle, 8 dots and 10 updates a correction
LEVELS = [8193, 4097, 2049, 1025, 513, 257, 129]
N0, INSIDE0 = 8193 ** 2, 8191 ** 2
STEPS = CYCLES = 16
DOTS, UPDATES = 32, 40


def test_schedule_counts_at_8193():
    config = registry.cell(CELL)["config"]
    sched = family.schedule(config, "solve_refined", 4)
    counts = {}
    for stage, shape, sweeps, count in sched:
        key = (stage, shape[0], sweeps)
        counts[key] = counts.get(key, 0) + count
    want = {("split", 8193, 0): 1, ("norm", 8193, 0): 6,
            ("ff_residual", 8193, 0): 1, ("ff_update_residual", 8193, 0): 4,
            ("combine", 8193, 0): 1, ("apply", 8193, 0): STEPS,
            ("dot", 8193, 0): DOTS, ("update", 8193, 0): UPDATES,
            ("dense_inverse", 65, 0): CYCLES}
    for n in LEVELS:
        want.update({("smoother", n, 2): 2 * CYCLES,
                     ("residual", n, 0): CYCLES,
                     ("restriction", n, 0): CYCLES,
                     ("prolong_add", n, 0): CYCLES})
    assert counts == want
    assert family.schedule(config, "solve", 4) is None


def test_krylov_cost_totals_at_8193():
    config = registry.cell(CELL)["config"]
    sched = family.schedule(config, "solve_refined", 4)
    nbytes = sum(count * krylov_cost.stage_cost(stage, shape, sweeps)[0]
                 for stage, shape, sweeps, count in sched)
    krylov = (STEPS * 8 + DOTS * 8 + UPDATES * 12) * N0  # 57,996,215,136
    fused = 4 * (36 * INSIDE0 + 28 * (N0 - INSIDE0))  # 9,664,987,280
    # a 2D V-cycle level: 2 smoothers of 12 B, residual 12, restriction 5,
    # prolong-add 9 B a point; the bottom reads its 4225^2 inverse
    cycles = CYCLES * (50 * sum(n * n for n in LEVELS)
                       + 4 * 4225 ** 2 + 8 * 4225)  # 72,747,415,200
    outer = (24 * INSIDE0 + 16 * (N0 - INSIDE0)  # the first ff residual
             + 12 * N0 + 6 * 4 * N0 + 12 * N0)  # split, 6 norms, combine
    assert (krylov, fused, cycles) == (57_996_215_136, 9_664_987_280,
                                       72_747_415_200)
    assert nbytes == krylov + fused + cycles + outer == 145_241_373_400
    # every stage is bound by its bytes
    assert krylov_cost.least_seconds(sched) == pytest.approx(
        145_241_373_400 / 3.35e12, rel=1e-12)
    assert krylov_cost.least_seconds(sched) * 1e3 == pytest.approx(43.356,
                                                                   abs=1e-3)


def test_apply_launches_are_priced_at_8_bytes_a_point(monkeypatch):
    from portbench import kernel_split

    reader = registry.load_module("metrics", "icg.apply_roofline")
    cg = "mg.solve_refined/mg.outer.cycle"
    kernels = {
        (f"{cg}/mg.cg.apply", "apply_kernel"): [20 * 200e-6, 20],
        (f"{cg}/mg.cg.precond/mg.L0.residual", "residual_kernel"): [1.0, 5],
        (f"{cg}/mg.cg.precond/mg.L0.residual", "apply_kernel"): [1.0, 5]}
    split = types.SimpleNamespace(kernels=kernels)
    monkeypatch.setattr(kernel_split, "of_run", lambda run: split)
    run = types.SimpleNamespace(family=family, cell=registry.cell(CELL))
    share = reader.read(run)
    assert share == pytest.approx(100 * 8 * N0 / 3.35e12 / 200e-6)
    assert math.isclose(share, 80.14955, rel_tol=1e-6)
    del kernels[(f"{cg}/mg.cg.apply", "apply_kernel")]
    assert reader.read(run) is None
