"""``AMGSolver``'s profiler spans, host-sync counter and set-up timers
(``multigrid_prj_tpu_torch.amg`` through ``utils/metrics``) on the CPU,
under ``torch.profiler`` with CPU activity, on a 33^2 P1 system with 3
levels: ``solve_refined``, ``solve`` and ``solve_p1``, on the plain route
(f64) and the kernel route's twins (f32).

* one root span per solve, and beneath it the names and nesting that
  ``portbench/spans.py`` reads: the outer loop's stages, and inside each
  ``mg.outer.cycle`` every level's five stages and ``mg.bottom``;
* ``COUNTERS["host_syncs"]`` counts ``iterations + 1`` stop tests;
* the answer and the history are the same with and without a profiler;
* ``setup_times`` holds each set-up phase, in seconds.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from multigrid_prj_tpu_torch.amg import AMGSolver
from multigrid_prj_tpu_torch.models import fem
from multigrid_prj_tpu_torch.utils import metrics
from portbench import spans

torch.set_num_threads(1)

ROUTES = {"plain": (False, torch.float64), "kernel": (True, torch.float32)}
ENTRIES = ("solve_refined", "solve", "solve_p1")
params = pytest.mark.parametrize("entry,route", [
    (e, r) for e in ENTRIES for r in ROUTES])
LEVELS = 3


@functools.cache
def _setup(route):
    use_pallas, dtype = ROUTES[route]
    system = fem.P1System(fem.structured_unit_square_mesh(33))
    solver = AMGSolver(system.A, num_levels=LEVELS, smoother="chebyshev",
                       dtype=dtype, use_pallas=use_pallas, device="cpu")
    gen = torch.Generator().manual_seed(7)
    nodal = torch.randn(system.n_nodes, generator=gen, dtype=torch.float64)
    return system, solver, nodal


def _call(entry, route):
    system, solver, nodal = _setup(route)
    if entry == "solve_p1":
        return solver.solve_p1(system, nodal, nodal, tol=1e-9, maxit=60)
    b = system.load(nodal, nodal)
    if entry == "solve":
        return solver.solve(b, tol=1e-9 if route == "plain" else 1e-5,
                            maxit=60)
    return solver.solve_refined(b, tol=1e-9, maxit=60)


def _mg_path(e):
    path = []
    while e is not None:
        if e.name.startswith("mg."):
            path.append(e.name)
        e = e.cpu_parent
    return tuple(reversed(path))


@functools.cache
def _runs(entry, route):
    plain = _call(entry, route)
    before = metrics.COUNTERS["host_syncs"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = _call(entry, route)
    syncs = metrics.COUNTERS["host_syncs"] - before
    paths = [_mg_path(e) for e in prof.events() if e.name.startswith("mg.")]
    return plain, traced, paths, syncs


@params
def test_span_names_and_nesting(entry, route):
    _, traced, paths, _ = _runs(entry, route)
    root = metrics.SPAN_SOLVE if entry == "solve" else \
        metrics.SPAN_SOLVE_REFINED
    assert [p for p in paths if len(p) == 1] == [(root,)]
    outer = {metrics.SPAN_SPLIT, metrics.SPAN_FETCH, metrics.SPAN_CYCLE,
             metrics.SPAN_COMBINE}
    if entry != "solve":
        outer.add(metrics.SPAN_FF_RESIDUAL)
    cycle = {getattr(metrics.level_spans(k), s)
             for k in range(LEVELS - 1) for s in metrics.STAGES}
    cycle.add(metrics.SPAN_BOTTOM)
    got = {p[1:] for p in paths if len(p) > 1}
    assert got == {(name,) for name in outer} | {
        (metrics.SPAN_CYCLE, name) for name in cycle}
    assert all(p[0] == root for p in paths)
    # every path is one that portbench/spans.py puts in a layer
    layers = {"/".join(p): spans.layer("/".join(p)) for p in paths}
    assert None not in layers.values()
    assert {k for k, v in layers.items() if v == "cycle"} == {
        f"{root}/{metrics.SPAN_CYCLE}"} | {
        f"{root}/{metrics.SPAN_CYCLE}/{name}" for name in cycle}
    assert traced.iterations > 2


@params
def test_one_cycle_and_each_stage_once_per_iteration(entry, route):
    _, traced, paths, _ = _runs(entry, route)
    k = traced.iterations
    ends = [p[-1] for p in paths]
    assert ends.count(metrics.SPAN_CYCLE) == k
    assert ends.count(metrics.SPAN_BOTTOM) == k
    for level in range(LEVELS - 1):
        for name in metrics.level_spans(level):
            assert ends.count(name) == k, name
    if entry != "solve":
        assert ends.count(metrics.SPAN_FF_RESIDUAL) == k + 1
    # the P1 load and nodal field run outside the root span
    assert ends.count(metrics.SPAN_SPLIT) == 1
    assert ends.count(metrics.SPAN_COMBINE) == 1


@params
def test_host_syncs_count_the_stop_tests(entry, route):
    _, traced, paths, syncs = _runs(entry, route)
    assert syncs == traced.iterations + 1
    assert traced.iterations < 60
    assert sum(p[-1] == metrics.SPAN_FETCH for p in paths) == syncs


@params
def test_a_recording_profiler_changes_no_result(entry, route):
    plain, traced, _, _ = _runs(entry, route)
    x, y = plain.x, traced.x
    if isinstance(x, torch.Tensor):
        assert torch.equal(x, y)
    else:
        assert np.array_equal(x, y)
    assert plain.iterations == traced.iterations
    assert np.array_equal(plain.history, traced.history)
    assert plain.rel_residual == traced.rel_residual


@pytest.mark.parametrize("route", list(ROUTES))
def test_setup_times_name_every_phase(route):
    system, solver, nodal = _setup(route)
    _call("solve_refined", route)  # builds the pair operator and inverse
    times = solver.setup_times
    want = {"coarsening", "interpolation", "rap", "upload", "bottom_inverse"}
    if route == "kernel":
        want.add("rcm")  # reorder="auto" orders the kernel path by RCM
    assert set(times) == want
    assert all(isinstance(s, float) and s >= 0 for s in times.values())
    times["rap"] = -1.0  # a copy: the solver's own timers stay
    assert solver.setup_times["rap"] >= 0
