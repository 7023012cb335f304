"""The plain reference and the comparison that decides ``correct``: the
reference states the program's system, accepts the port's answers and
rejects perturbed and lower-precision ones, and the controls come out not
correct."""

from __future__ import annotations

import pytest
import torch

from portbench import control, harness, registry, traffic
from portbench.reference import poisson_mg as ref
from portbench.tests._small import CELLS, small_cell


@pytest.mark.parametrize("shape,alpha,length", [((9, 9), 10.0, 10.0),
                                                ((5, 6, 7), 1.0, 1.0)])
def test_reference_operator_is_the_programs(shape, alpha, length):
    from multigrid_prj_tpu_torch.ops.stencil import poisson_apply

    u = torch.randn(shape, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(3))
    h = length / (shape[0] - 1)
    assert torch.allclose(ref.apply(u, alpha / h ** 2),
                          poisson_apply(u, alpha, h), rtol=1e-14, atol=1e-9)


@pytest.mark.parametrize("shape,alpha,length", [((33, 33), 10.0, 10.0),
                                                ((17, 17, 17), 1.0, 1.0)])
def test_reference_solves_the_programs_system(shape, alpha, length):
    from multigrid_prj_tpu_torch.ops.stencil import poisson_residual

    b = torch.randn(shape, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(4))
    u = ref.solve(b, alpha, length)
    r = poisson_residual(u, b, alpha, length / (shape[0] - 1))
    assert float(r.norm() / b.norm()) < 1e-12


def test_reference_refuses_grids_it_cannot_coarsen():
    with pytest.raises(ValueError):
        ref.Hierarchy((64, 64), 1.0, 1.0, "cpu")


def _answers(cell, seed, solve):
    config = cell["config"]
    kw = config["solver"]
    prob = registry.load_module("problems", config["problem"])
    pool = traffic.make_pool(prob, kw["shape"], kw["length"], cell["traffic"],
                             seed, "cpu")[:3]
    answers, residuals, failed = [], [], 0
    for j, b in enumerate(pool):
        u, residual, converged = solve(b)
        answers.append((j, u))
        residuals.append(residual)
        failed += not converged
    return harness.compare(cell, pool, answers, residuals, failed)


@pytest.mark.parametrize("name", CELLS)
def test_port_answers_are_correct_and_altered_ones_are_not(name):
    cell = small_cell(name)
    family = registry.load_module("solvers", "gmg")
    solver = family.build(cell["config"], "cpu")

    def port(b, scale=1.0):
        ans = family.solve(solver, cell["entry"], b)
        return ans.u * scale, ans.residual, ans.converged

    checks = _answers(cell, 11, port)
    assert harness.passed(checks), checks
    err = dict((n, v) for n, v, _ in checks)["u_rel_err"]
    assert 1e-8 < err < 4e-8  # the float32 rounding of u*
    altered = _answers(cell, 11, lambda b: port(b, 1 + 1e-6))
    assert not harness.passed(altered)
    assert dict((n, v) for n, v, _ in altered)["u_rel_err"] > 5e-7


@pytest.mark.parametrize("name", CELLS)
def test_lower_precision_controls_are_not_correct(name):
    cell = small_cell(name)
    kw = cell["config"]["solver"]
    for dtype in (torch.float32, torch.bfloat16):
        def lower(b):
            u, _, rel = ref.defect_correction(b, kw["alpha"], kw["length"],
                                              dtype, kw["tol"], kw["maxit"])
            return u, rel, rel <= kw["tol"]

        checks = _answers(cell, 12, lower)
        assert not harness.passed(checks), (dtype, checks)


@pytest.mark.parametrize("name", CELLS)
def test_control_readings_separate_from_the_programs(name):
    cell = small_cell(name)
    out = control.readings(cell, 13, "cpu", controls=True)
    sound = out["program"]["u_rel_err"]
    assert sound < cell["limits"]["u_rel_err"]
    assert out["program"]["residual"] <= cell["config"]["solver"]["tol"]
    for entry in control.CONTROLS:
        r = out[entry]
        # each control fails the residual and reads an error at least three
        # times the program's (bfloat16 may overflow: no number, failed too)
        assert r["residual"] > cell["config"]["solver"]["tol"], entry
        assert not r["u_rel_err"] < 3 * sound, (entry, r, sound)
