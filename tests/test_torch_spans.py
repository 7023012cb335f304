"""The solver's profiler spans and host-sync counter
(``multigrid_prj_tpu_torch.gmg`` through ``utils/metrics.span`` and
``fetch``) on the CPU, under ``torch.profiler`` with CPU activity:
``solve_refined`` and ``solve`` at 65^2 (3 levels; V-cycle on a padded
layout, sawtooth) and 17^3 (3 levels, V-cycle), on the plain route (f64)
and, for the refined solve's spans, on the kernel route too (the twins, in
f32).

* the span names and their nesting beneath one root span per solve;
* per iteration one ``mg.outer.cycle``, and one of each of the cycle's
  ``mg.L<k>.<stage>`` spans at every level above the bottom; a refined
  solve's ``mg.outer.ff_residual`` once before the loop and once per
  iteration, with the pair update inside it, on either route;
* ``COUNTERS["host_syncs"]`` counts the fetches: ``iterations + 1`` in the
  outer loop (plus the sawtooth's bottom checks);
* the answer and the history are the same with and without a profiler;
* with no profiler recording, ``span`` hands out one shared no-op context
  and no range is made.
"""

import functools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from multigrid_prj_tpu_torch.gmg import GMGSolver
from multigrid_prj_tpu_torch.models.poisson import assemble_rhs
from multigrid_prj_tpu_torch.utils import metrics

torch.set_num_threads(1)

CASES = {
    "2d-v": dict(shape=(65, 65), num_levels=3, cycle="v", pad_align=128),
    "2d-sawtooth": dict(shape=(65, 65), num_levels=3, cycle="sawtooth"),
    "3d-v": dict(shape=(17, 17, 17), num_levels=3, cycle="v", length=1.0,
                 alpha=1.0),
}
ENTRIES = ("solve_refined", "solve")
ROOT = {"solve_refined": metrics.SPAN_SOLVE_REFINED,
        "solve": metrics.SPAN_SOLVE}
params = pytest.mark.parametrize("entry,case", [(e, c) for c in CASES
                                                for e in ENTRIES])
# the plain route in f64; the kernel route (its CPU twins) in f32
ROUTES = {"plain": (False, torch.float64), "kernel": (True, torch.float32)}
route_params = pytest.mark.parametrize(
    "entry,case,route",
    [pytest.param(e, c, "plain", id=f"{e}-{c}") for c in CASES
     for e in ENTRIES]
    + [pytest.param("solve_refined", c, "kernel",
                    id=f"solve_refined-{c}-kernel") for c in CASES])


def _solver(case, route="plain"):
    return GMGSolver(device="cpu", tol=1e-6, maxit=60,
                     use_pallas=ROUTES[route][0], **CASES[case])


def _rhs(solver, route="plain"):
    dtype = ROUTES[route][1]
    if len(solver.levels[0].shape) == 2:
        return assemble_rhs(solver.levels[0], solver.length, dtype=dtype,
                            device="cpu")
    return assemble_rhs(  # BASELINE config 4's smooth 3D pair
        solver.levels[0], solver.length, dtype=dtype, device="cpu",
        f=lambda x, y, z: torch.sin(3.0 * x) * torch.cos(2.0 * y) + z,
        g=lambda x, y, z: torch.exp(x) * torch.exp(-2.0 * y) * z)


def _mg_path(e):
    """The ``mg.*`` names from the root down to ``e``."""
    path = []
    while e is not None:
        if e.name.startswith("mg."):
            path.append(e.name)
        e = e.cpu_parent
    return tuple(reversed(path))


@functools.cache
def _runs(entry, case, route="plain"):
    """The solve without and with a profiler recording: both results, the
    ``mg.*`` spans' paths of the traced one, and its host-sync count."""
    solver = _solver(case, route)
    b = _rhs(solver, route)
    plain = getattr(solver, entry)(b)
    before = metrics.COUNTERS["host_syncs"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = getattr(solver, entry)(b)
    syncs = metrics.COUNTERS["host_syncs"] - before
    paths = [_mg_path(e) for e in prof.events() if e.name.startswith("mg.")]
    return plain, traced, paths, syncs


def _combines(entry, case):
    """Whether the solve ends in ``mg.outer.combine``: ``solve_refined``
    adds its pair there, ``solve`` only crops a padded layout."""
    return entry == "solve_refined" or "pad_align" in CASES[case]


def _stages(case):
    """The stages each level above the bottom runs once per cycle."""
    if CASES[case]["cycle"] == "v":
        return {k: set(metrics.STAGES) for k in range(2)}
    return {0: set(metrics.STAGES), 1: {"restrict", "prolong_add",
                                    "post_smooth"}}


@route_params
def test_span_names_and_nesting(entry, case, route):
    _, traced, paths, _ = _runs(entry, case, route)
    root = ROOT[entry]
    assert [p for p in paths if len(p) == 1] == [(root,)]
    outer = {metrics.SPAN_SPLIT, metrics.SPAN_FETCH, metrics.SPAN_CYCLE}
    if _combines(entry, case):
        outer.add(metrics.SPAN_COMBINE)
    if entry == "solve_refined":
        outer.add(metrics.SPAN_FF_RESIDUAL)
    levels = {f"mg.L{k}.{s}" for k, stages in _stages(case).items()
              for s in stages} | {metrics.SPAN_BOTTOM}
    got = {p[1:] for p in paths if len(p) > 1}
    want = {(name,) for name in outer}
    want |= {(metrics.SPAN_CYCLE, name) for name in levels}
    if CASES[case]["cycle"] == "sawtooth":  # the bottom's own checks
        want.add((metrics.SPAN_CYCLE, metrics.SPAN_BOTTOM, metrics.SPAN_FETCH))
    assert got == want
    assert all(p[0] == root for p in paths)
    assert traced.iterations > 2


@route_params
def test_one_cycle_and_each_stage_once_per_iteration(entry, case, route):
    _, traced, paths, _ = _runs(entry, case, route)
    k = traced.iterations
    ends = [p[-1] for p in paths]
    assert ends.count(metrics.SPAN_CYCLE) == k
    assert ends.count(metrics.SPAN_BOTTOM) == k
    for level, stages in _stages(case).items():
        for stage in metrics.STAGES:
            name = getattr(metrics.level_spans(level), stage)
            assert ends.count(name) == (k if stage in stages else 0), name
    assert not any(e.startswith("mg.L2.") for e in ends)
    if entry == "solve_refined":
        assert ends.count(metrics.SPAN_FF_RESIDUAL) == k + 1
    assert "mg.outer.pair_update" not in ends
    assert ends.count(metrics.SPAN_SPLIT) == 1
    assert ends.count(metrics.SPAN_COMBINE) == _combines(entry, case)


@params
def test_host_syncs_count_the_fetches(entry, case):
    plain, traced, paths, syncs = _runs(entry, case)
    fetches = [p for p in paths if p[-1] == metrics.SPAN_FETCH]
    outer = [p for p in fetches if metrics.SPAN_CYCLE not in p]
    assert len(outer) == traced.iterations + 1
    assert syncs == len(fetches)
    if CASES[case]["cycle"] == "v":
        assert syncs == traced.iterations + 1
    else:
        assert syncs > traced.iterations + 1


@params
def test_a_recording_profiler_changes_no_result(entry, case):
    plain, traced, _, _ = _runs(entry, case)
    assert torch.equal(plain.u, traced.u)
    assert plain.iterations == traced.iterations
    assert plain.history.dtype == traced.history.dtype
    assert np.array_equal(plain.history, traced.history)


@params
def test_without_a_profiler_no_range_is_made(entry, case, monkeypatch):
    assert not torch.autograd.profiler._is_profiler_enabled
    assert metrics.span("mg.a") is metrics.span("mg.b") is metrics._NO_SPAN
    assert metrics.level_spans(3) is metrics.level_spans(3)

    def refuse(name, *args, **kwargs):
        raise AssertionError(f"a range {name!r} was made")

    solver = _solver(case)
    b = _rhs(solver)
    plain = getattr(solver, entry)(b)
    monkeypatch.setattr(metrics, "_range", refuse)
    got = getattr(solver, entry)(b)
    assert torch.equal(got.u, plain.u)
    assert np.array_equal(got.history, plain.history)


@pytest.mark.parametrize("x,bare", [
    (torch.tensor(0.1, dtype=torch.float32), float),
    (torch.tensor(1e-300, dtype=torch.float64), float),
    (torch.tensor(2.0) > torch.tensor(1.0), bool)])
def test_fetch_returns_what_the_bare_fetch_returns(x, bare):
    before = metrics.COUNTERS["host_syncs"]
    got = metrics.fetch(x)
    assert metrics.COUNTERS["host_syncs"] == before + 1
    assert type(got) is bare and got == bare(x)
