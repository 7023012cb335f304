"""The inner conjugate gradients' profiler spans and host-sync count
(``multigrid_prj_tpu_torch.ops.krylov.cg_arrays`` through
``utils/metrics.span``, ``fetch`` and ``COUNTERS``) on the CPU, under
``torch.profiler`` with CPU activity: ``GMGSolver.solve_refined(b,
inner_cg=4)`` at 65^2 and 129^2 (V(2,2), padded to 128, test 1's forcing,
float32 on the plain route and on the kernel route's CPU twins), and
``AMGSolver.solve_pcg`` on a P1 system.

* each correction, inside ``mg.outer.cycle``, opens ``mg.cg.mask`` twice
  (the restriction to the zero-boundary subspace and back), ``mg.cg.apply``
  and ``mg.cg.precond`` 5 times (``x0``'s apply and the first cycle, then
  one of each a step), ``mg.cg.update`` 9 and ``mg.cg.dot`` 11 times, and
  4 stop tests in ``mg.fetch``; each preconditioner call holds one V-cycle's
  ``mg.L<k>.*`` spans and ``mg.bottom``;
* ``COUNTERS["host_syncs"]`` advances by ``5 k + 1`` for ``k`` outer
  iterations (per correction 4 stop tests and one history fetch, and the
  first fetch), one for each ``mg.fetch`` span;
* the answer, the history and the iterations are the same with and
  without a profiler, and the same as the CG loop gives as it was before
  it had spans and counters (:func:`_cg_arrays_before`, kept here as the
  reference), for the GMG solves and for ``solve_pcg`` alike.
"""

import functools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from multigrid_prj_tpu_torch import amg as amg_module
from multigrid_prj_tpu_torch import gmg as gmg_module
from multigrid_prj_tpu_torch.amg import AMGSolver
from multigrid_prj_tpu_torch.gmg import GMGSolver
from multigrid_prj_tpu_torch.models import fem
from multigrid_prj_tpu_torch.models.poisson import assemble_rhs
from multigrid_prj_tpu_torch.ops.krylov import _dot, _hist0
from multigrid_prj_tpu_torch.utils import metrics

torch.set_num_threads(1)

INNER_CG = 4
CASES = {"65": dict(shape=(65, 65), num_levels=3),
         "129": dict(shape=(129, 129), num_levels=4)}
ROUTES = ("plain", "kernel")
params = pytest.mark.parametrize("case,route", [(c, r) for c in CASES
                                                for r in ROUTES])
CG_SPANS = (metrics.SPAN_CG_APPLY, metrics.SPAN_CG_DOT,
            metrics.SPAN_CG_UPDATE, metrics.SPAN_CG_PRECOND)
# spans a correction opens (4 CG steps that all run: tol = 0): the dots are
# ||b||, ||r0|| with r0 . z0, p . A p and r . z a step, and the last ||r||
PER_CORRECTION = {metrics.SPAN_CG_MASK: 2,
                  metrics.SPAN_CG_APPLY: INNER_CG + 1,
                  metrics.SPAN_CG_PRECOND: INNER_CG + 1,
                  metrics.SPAN_CG_UPDATE: 1 + 2 * INNER_CG,
                  metrics.SPAN_CG_DOT: 3 + 2 * INNER_CG,
                  metrics.SPAN_FETCH: INNER_CG}


def _cg_arrays_before(A, b, x0=None, tol=1e-11, maxit=100, M=None,
                      history=False, hist_cap=None):
    """``ops/krylov.cg_arrays`` as it was before it had spans and counters:
    the same operations in the same order, with a bare stop test."""
    if x0 is None:
        x0 = torch.zeros_like(b)
    if M is None:
        M = lambda r: r
    bnorm = torch.sqrt(_dot(b, b).real)
    bnorm = torch.where(bnorm > 0, bnorm, torch.ones_like(bnorm))
    r = b - A(x0)
    z = M(r)
    hist = _hist0(b, r, bnorm, history,
                  (hist_cap if hist_cap is not None else maxit) + 1)
    x, p, rz, k = x0, z, _dot(r, z), 0
    while k < maxit and bool(torch.sqrt(_dot(r, r).real) > tol * bnorm):
        Ap = A(p)
        alpha = rz / _dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz1 = _dot(r, z)
        p = z + (rz1 / rz) * p
        if history:
            idx = k + 1 if hist_cap is None else min(k + 1, hist_cap)
            hist[idx] = torch.sqrt(_dot(r, r).real) / bnorm
        rz = rz1
        k += 1
    rel = torch.sqrt(_dot(r, r).real) / bnorm
    return x, k, rel, hist


def _solver(case, route):
    return GMGSolver(device="cpu", tol=1e-7, maxit=40, cycle="v",
                     pad_align=128, use_pallas=route == "kernel",
                     **CASES[case])


def _rhs(solver):
    return assemble_rhs(solver.levels[0], solver.length, test=1,
                        dtype=torch.float32, device="cpu")


def _mg_path(e):
    """The ``mg.*`` names from the outermost span down to ``e``."""
    path = []
    while e is not None:
        if e.name.startswith("mg."):
            path.append(e.name)
        e = e.cpu_parent
    return tuple(reversed(path))


def _traced(call):
    """``call()`` under a recording profiler: its result, the ``mg.*``
    spans' paths, and the change of each program counter."""
    before = dict(metrics.COUNTERS)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = call()
    counted = {k: metrics.COUNTERS[k] - before[k] for k in before}
    paths = [_mg_path(e) for e in prof.events() if e.name.startswith("mg.")]
    return got, paths, counted


@functools.cache
def _runs(case, route):
    """The solve without and with a profiler recording, and through the CG
    loop as it was before."""
    solver = _solver(case, route)
    b = _rhs(solver)
    plain = solver.solve_refined(b, inner_cg=INNER_CG)
    traced, paths, counted = _traced(
        lambda: solver.solve_refined(b, inner_cg=INNER_CG))
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(gmg_module, "cg_arrays", _cg_arrays_before)
        before = solver.solve_refined(b, inner_cg=INNER_CG)
    finally:
        mp.undo()
    return plain, traced, before, paths, counted


@params
def test_cg_spans_open_under_the_cycle(case, route):
    _, traced, _, paths, _ = _runs(case, route)
    root = metrics.SPAN_SOLVE_REFINED
    assert [p for p in paths if len(p) == 1] == [(root,)]
    cycle = (root, metrics.SPAN_CYCLE)
    inner = {p[2:] for p in paths if p[:2] == cycle and len(p) > 2}
    assert {p[0] for p in inner} == set(CG_SPANS) | {metrics.SPAN_CG_MASK,
                                                     metrics.SPAN_FETCH}
    # the preconditioner's cycle: each level's stages and the bottom
    levels = CASES[case]["num_levels"]
    want = {(metrics.SPAN_CG_PRECOND, f"mg.L{k}.{s}")
            for k in range(levels - 1) for s in metrics.STAGES}
    want.add((metrics.SPAN_CG_PRECOND, metrics.SPAN_BOTTOM))
    assert {p for p in inner if len(p) > 1} == want
    assert not any(n.startswith("mg.cg.") for p in paths
                   if p[:2] != cycle for n in p)
    assert traced.iterations >= 2


@params
def test_each_correction_opens_its_spans_so_often(case, route):
    _, traced, _, paths, _ = _runs(case, route)
    k = traced.iterations
    in_cycle = [p[2] for p in paths if len(p) == 3
                and p[1] == metrics.SPAN_CYCLE]
    for name, per in PER_CORRECTION.items():
        assert in_cycle.count(name) == per * k, name
    ends = [p[-1] for p in paths]
    assert ends.count(metrics.SPAN_BOTTOM) == (INNER_CG + 1) * k
    assert ends.count(metrics.level_spans(0).pre_smooth) \
        == (INNER_CG + 1) * k


@params
def test_host_syncs_count_the_stop_tests(case, route):
    _, traced, _, paths, counted = _runs(case, route)
    k = traced.iterations
    fetches = [p for p in paths if p[-1] == metrics.SPAN_FETCH]
    assert counted["host_syncs"] == len(fetches) == (INNER_CG + 1) * k + 1


@params
def test_results_equal_without_a_profiler_and_before_the_spans(case, route):
    plain, traced, before, _, _ = _runs(case, route)
    assert plain.converged
    for other in (traced, before):
        assert torch.equal(plain.u, other.u)
        assert plain.iterations == other.iterations
        assert plain.history.dtype == other.history.dtype
        assert np.array_equal(plain.history, other.history)


@functools.cache
def _pcg_runs():
    system = fem.P1System(fem.structured_unit_square_mesh(33))
    solver = AMGSolver(system.A, num_levels=3, device="cpu",
                       dtype=torch.float32)
    b = torch.randn(system.A.shape[0], dtype=torch.float32,
                    generator=torch.Generator().manual_seed(3))
    plain = solver.solve_pcg(b, tol=1e-6, maxit=50)
    traced, paths, counted = _traced(
        lambda: solver.solve_pcg(b, tol=1e-6, maxit=50))
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(amg_module, "cg_arrays", _cg_arrays_before)
        before = solver.solve_pcg(b, tol=1e-6, maxit=50)
    finally:
        mp.undo()
    return plain, traced, before, paths, counted


def test_solve_pcg_results_are_unchanged():
    plain, traced, before, _, _ = _pcg_runs()
    x, iterations, rel = plain
    assert iterations > 2 and rel <= 1e-6
    for other in (traced, before):
        assert torch.equal(x, other[0])
        assert (iterations, rel) == tuple(other[1:])
        assert np.array_equal(plain.history, other.history)


def test_solve_pcg_opens_the_cg_spans_and_counts_its_stop_tests():
    _, traced, _, paths, counted = _pcg_runs()
    k = traced[1]
    tops = [p[0] for p in paths if len(p) == 1]
    for name in CG_SPANS:
        assert name in tops, name
    # a converged loop tests k + 1 times, the last one false
    fetches = [p for p in paths if p[-1] == metrics.SPAN_FETCH]
    assert counted["host_syncs"] == len(fetches) == k + 1
    assert tops.count(metrics.SPAN_CG_APPLY) == k + 1
    assert tops.count(metrics.SPAN_CG_PRECOND) == k + 1
    assert any(len(p) > 1 and p[0] == metrics.SPAN_CG_PRECOND
               and p[1].startswith("mg.L0.") for p in paths)
