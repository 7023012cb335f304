"""The port's set-up records (``utils/metrics.PhaseTimer`` with an owner)
on the CPU: tiny 2D and 3D ``GMGSolver``s and a 33^2 P1 ``AMGSolver``, on
the plain route (f64) and the kernel route's twins (f32).

* each named phase of each object is recorded, in seconds >= 0, and the
  objects' records join the process's log in build order;
* the first solve is recorded once per solver, and a second solver gets
  its own record;
* under ``torch.profiler`` the ``mg.setup.<phase>`` ranges open where the
  work is, nested as the calls are, and none opens inside a warm solve;
* the answer and the history of a recorded first solve equal a later
  solve's;
* ``AMGSolver.setup_times`` keeps its keys;
* nested phases count as self time, once;
* ``COUNTERS["kernel_builds"]`` counts the library loads that compiled
  (``build`` and ``ctypes.CDLL`` replaced: no nvcc runs);
* the log keeps the first ``SETUP_LOG_CAP`` records.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from multigrid_prj_tpu_torch.amg import AMGSolver
from multigrid_prj_tpu_torch.gmg import GMGSolver
from multigrid_prj_tpu_torch.kernels import _build
from multigrid_prj_tpu_torch.models import fem
from multigrid_prj_tpu_torch.utils import metrics

torch.set_num_threads(1)

ROUTES = {"plain": (False, torch.float64), "kernel": (True, torch.float32)}
GMG = {"2d": dict(shape=(33, 33), num_levels=3, cycle="v"),
       "3d": dict(shape=(9, 9, 9), num_levels=2, cycle="v", length=1.0,
                  alpha=1.0)}
CASES = [(kind, route) for kind in ("2d", "3d", "amg") for route in ROUTES]
params = pytest.mark.parametrize("kind,route", CASES)
AMG_PHASES = {"coarsening", "interpolation", "rap", "upload",
              "bottom_inverse"}


@pytest.fixture(autouse=True)
def log(monkeypatch):
    """An empty set-up log for the test (the process's own stays)."""
    fresh = []
    monkeypatch.setattr(metrics, "SETUP_LOG", fresh)
    return fresh


class Built:
    """A solver of ``kind`` on ``route``, built now, and its right-hand
    side; :meth:`solve` is the entry the benchmark's family calls."""

    def __init__(self, kind, route):
        use_pallas, dtype = ROUTES[route]
        gen = torch.Generator().manual_seed(11)
        self.kind = kind
        if kind == "amg":
            self.system = fem.P1System(fem.structured_unit_square_mesh(33))
            self.solver = AMGSolver(self.system.A, num_levels=3,
                                    smoother="chebyshev", dtype=dtype,
                                    use_pallas=use_pallas, device="cpu")
            self.system.to("cpu")
            self.b = torch.randn(self.system.n_nodes, generator=gen,
                                 dtype=torch.float64)
        else:
            self.solver = GMGSolver(device="cpu", tol=1e-6, maxit=30,
                                    use_pallas=use_pallas, **GMG[kind])
            self.b = torch.randn(GMG[kind]["shape"], generator=gen,
                                 dtype=dtype)

    def solve(self):
        if self.kind == "amg":
            res = self.solver.solve_p1(self.system, self.b, self.b,
                                       tol=1e-9, maxit=40)
            return res.x, res.history
        res = self.solver.solve_refined(self.b)
        return res.u, res.history


def _phases(kind, route):
    """``{owner: phase names}`` a build and first solve record."""
    if kind != "amg":
        return {"GMGSolver": {"hierarchy", "bottom_inverse"}}
    rcm = {"rcm"} if route == "kernel" else set()
    return {"TriangularMesh": {"mesh"},
            "P1System": {"p1_assembly", "p1_upload"},
            "AMGSolver": AMG_PHASES | rcm}


def _mg_path(e):
    path = []
    while e is not None:
        if e.name.startswith("mg."):
            path.append(e.name)
        e = e.cpu_parent
    return tuple(reversed(path))


@params
def test_each_named_phase_is_recorded_in_build_order(kind, route, log):
    built = Built(kind, route)
    built.solve()
    want = _phases(kind, route)
    assert [r.owner for r in log] == list(want)
    for record in log:
        assert set(record.phases) == want[record.owner]
        assert all(isinstance(s, float) and s >= 0
                   for s in record.phases.values())
    assert log[-1] is built.solver._timer
    if kind == "amg":
        assert built.solver.setup_times == log[-1].phases
        assert log[1] is built.system._timer


@params
def test_the_first_solve_is_recorded_once_per_solver(kind, route, log):
    first = Built(kind, route)
    assert first.solver._timer.first_solve_s is None
    first.solve()
    seconds = first.solver._timer.first_solve_s
    assert isinstance(seconds, float) and seconds >= 0
    first.solve()
    assert first.solver._timer.first_solve_s == seconds
    second = Built(kind, route)
    assert second.solver._timer is not first.solver._timer
    assert second.solver._timer.first_solve_s is None
    second.solve()
    assert second.solver._timer.first_solve_s >= 0
    assert first.solver._timer.first_solve_s == seconds
    solvers = [r for r in log if r.owner.endswith("Solver")]
    assert solvers == [first.solver._timer, second.solver._timer]


@params
def test_setup_ranges_open_where_the_work_is(kind, route, log):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        built = Built(kind, route)
        built.solve()
    paths = [_mg_path(e) for e in prof.events()
             if e.name.startswith(metrics.SETUP_SPAN)]
    names = sorted(p[-1] for p in paths)
    want = sorted(metrics.SETUP_SPAN + name
                  for phases in _phases(kind, route).values()
                  for name in phases)
    if kind == "amg":
        # coarsening, interpolation and rap open at each of the 2 coarser
        # levels, interpolation once more for the lmax estimates; upload
        # at the build and at the first solve
        want += [metrics.SETUP_SPAN + name for name in (
            "coarsening", "interpolation", "interpolation", "rap",
            "upload")]
    assert names == sorted(want)
    root = metrics.SPAN_SOLVE_REFINED
    nested = {p for p in paths if len(p) > 1}
    if kind == "amg":
        # the float-float operator's upload in the first solve's split, the
        # bottom inverse at its first cycle's bottom
        assert nested == {
            (root, metrics.SPAN_SPLIT, metrics.SETUP_SPAN + "upload"),
            (root, metrics.SPAN_CYCLE, metrics.SPAN_BOTTOM,
             metrics.SETUP_SPAN + "bottom_inverse")}
    else:
        assert nested == set()


@params
def test_no_setup_range_opens_in_a_warm_solve(kind, route):
    built = Built(kind, route)
    built.solve()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        built.solve()
    names = [e.name for e in prof.events() if e.name.startswith("mg.")]
    assert metrics.SPAN_SOLVE_REFINED in names
    assert not [n for n in names if n.startswith(metrics.SETUP_SPAN)]


@params
def test_a_recorded_solve_answers_as_a_later_one(kind, route):
    built = Built(kind, route)
    x1, h1 = built.solve()
    assert built.solver._timer.first_solve_s is not None
    x2, h2 = built.solve()
    assert torch.equal(x1, x2)
    assert np.array_equal(h1, h2)
    assert len(h1) > 2


def test_setup_times_keep_their_keys():
    built = Built("amg", "plain")
    before = built.solver.setup_times
    assert set(before) == {"coarsening", "interpolation", "rap", "upload"}
    built.solve()
    assert set(built.solver.setup_times) == AMG_PHASES
    assert built.solver._timer.first_solve_s is not None


def test_nested_phases_count_as_self_time(log):
    outer = metrics.PhaseTimer(owner="outer")
    inner = metrics.PhaseTimer(owner="inner")
    t0 = time.perf_counter()
    with outer.solve_span("mg.solve"):
        with outer.phase("a"):
            time.sleep(0.02)
            with inner.phase("b"):
                time.sleep(0.1)
        time.sleep(0.01)
    wall = time.perf_counter() - t0
    a, b, solve = (outer.phases["a"], inner.phases["b"],
                   outer.first_solve_s)
    assert 0.02 <= a < 0.1 <= b and 0.01 <= solve < 0.1
    assert wall - 0.02 < a + b + solve <= wall
    assert log == [outer, inner]


def test_a_failed_phase_records_nothing_and_unwinds():
    record = metrics.PhaseTimer(owner="x")
    with pytest.raises(ValueError):
        with record.phase("bad"):
            raise ValueError("refused")
    with pytest.raises(ValueError):
        with record.solve_span("mg.solve"):
            raise ValueError("refused")
    assert record.phases == {} and record.first_solve_s is None
    with record.phase("good"):
        time.sleep(0.01)
    assert record.phases["good"] >= 0.01
    with record.solve_span("mg.solve"):
        pass
    assert 0 <= record.first_solve_s < record.phases["good"]


def test_a_plain_timer_is_no_setup_record(log):
    timer = metrics.PhaseTimer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.phase("init"):
            pass
    assert log == [] and set(timer.phases) == {"init"}
    assert not [e for e in prof.events() if e.name.startswith("mg.")]


def test_the_log_stays_bounded(log):
    records = [metrics.PhaseTimer(owner=f"o{i}")
               for i in range(metrics.SETUP_LOG_CAP + 5)]
    assert len(log) == metrics.SETUP_LOG_CAP
    assert all(a is b for a, b in zip(log, records))
    with records[-1].phase("late"):
        pass
    assert records[-1].phases["late"] >= 0  # kept, though not in the log


class _Fn:
    """A stand-in for a function of the loaded library."""


@pytest.mark.parametrize("compiled", [True, False])
def test_kernel_builds_count_only_loads_that_compiled(compiled, log,
                                                      monkeypatch):
    def fake_build(force=False):
        return {"path": str(_build.LIBRARY), "seconds": 0.0,
                "built": compiled, "log": ""}

    def fake_cdll(path):
        lib = type("Lib", (), {})()
        for name in _build._SIGNATURES:
            setattr(lib, name, _Fn())
        return lib

    monkeypatch.setattr(_build, "build", fake_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", fake_cdll)
    _build.library.cache_clear()
    try:
        before = metrics.COUNTERS["kernel_builds"]
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            lib = _build.library()
        assert _build.library() is lib  # loaded once
        assert metrics.COUNTERS["kernel_builds"] - before == int(compiled)
    finally:
        _build.library.cache_clear()
    assert [r.owner for r in log] == ["kernel_library"]
    assert set(log[0].phases) == {"kernel_library", "kernel_build"}
    assert lib.mg_residual.restype is _build.ctypes.c_int
    paths = {_mg_path(e) for e in prof.events()
             if e.name.startswith(metrics.SETUP_SPAN)}
    assert paths == {(metrics.SETUP_SPAN + "kernel_library",),
                     (metrics.SETUP_SPAN + "kernel_library",
                      metrics.SETUP_SPAN + "kernel_build")}
