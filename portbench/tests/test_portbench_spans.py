"""The reduction of a profiled slice by the program's ``mg.*`` spans
(``portbench/spans.py``) and the five readers built on it, on synthetic
events and on a small CPU slice."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from portbench import harness, registry, spans
from portbench.tests._small import small_cell

NEW = ("outer.ff_device_ms_per_solve", "cycle.transfers_device_ms_per_solve",
       "outer.idle_ms_per_solve", "cycle.idle_ms_per_solve",
       "outer.host_syncs_per_solve")
ROOT = "mg.solve_refined"


@dataclasses.dataclass
class _Ev:
    name: str
    device_type: object
    start: float
    end: float
    id: int = 0
    thread: int = 1
    is_user_annotation: bool = False

    @property
    def time_range(self):
        return self

    def elapsed_us(self):
        return self.end - self.start


def _events():
    """One solve on thread 1 (times in us), its launches by correlation id:
    1 in the ff residual (the kernel runs after the span has closed), 2 in
    an aten op inside ``mg.L0.restrict`` (an aten op with the same id as a
    decoy), 3 in the bottom, 4 a copy in the fetch; 9 runs with no launch
    found, 5 is launched on another thread."""
    from torch.autograd import DeviceType

    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    return [
        _Ev(ROOT, cpu, 0, 90, is_user_annotation=True),
        _Ev("mg.outer.ff_residual", cpu, 5, 20),
        _Ev("cudaLaunchKernel", cpu, 6, 8, id=1),
        _Ev("mg.outer.cycle", cpu, 25, 60),
        _Ev("mg.L0.restrict", cpu, 30, 40),
        _Ev("aten::cat", cpu, 31, 39, id=2),
        _Ev("cudaLaunchKernel", cpu, 32, 33, id=2),
        _Ev("mg.bottom", cpu, 45, 55),
        _Ev("cudaLaunchKernel", cpu, 46, 47, id=3),
        _Ev("mg.fetch", cpu, 65, 85),
        _Ev("cudaMemcpyAsync", cpu, 66, 67, id=4),
        _Ev("cudaStreamSynchronize", cpu, 67, 72, id=6),
        _Ev("mg.outer.cycle", cpu, 0, 95, thread=2),
        _Ev("cudaLaunchKernel", cpu, 91, 92, id=5, thread=2),
        # the device: spans drawn on its timeline are no work
        _Ev("mg.outer.cycle", gpu, 22, 60, id=7, is_user_annotation=True),
        _Ev("ker_a", gpu, 22, 30, id=1), _Ev("ker_b", gpu, 35, 44, id=2),
        _Ev("ker_c", gpu, 48, 52, id=3),
        _Ev("Memcpy DtoH (Device -> Pinned)", gpu, 70, 71, id=4),
        _Ev("ker_d", gpu, 90, 92, id=9), _Ev("ker_e", gpu, 93, 95, id=5)]


def _path(*names):
    return "/".join((ROOT,) + names)


def test_device_time_goes_to_the_innermost_span_of_its_launch():
    split = spans.reduce(_events(), host_syncs=1)
    assert split.solves == 1 and split.host_syncs == 1
    assert split.busy == pytest.approx({
        _path("mg.outer.ff_residual"): 8e-6,
        _path("mg.outer.cycle", "mg.L0.restrict"): 9e-6,
        _path("mg.outer.cycle", "mg.bottom"): 4e-6,
        _path("mg.fetch"): 1e-6})
    assert split.unlaunched_s == pytest.approx(2e-6)


def test_idle_gaps_go_to_the_innermost_span_at_their_midpoint():
    # gaps 30-35, 44-48, 52-70, 71-90 and 92-93 (outside the root)
    split = spans.reduce(_events())
    assert split.idle == pytest.approx({
        _path("mg.outer.cycle", "mg.L0.restrict"): 5e-6,
        _path("mg.outer.cycle", "mg.bottom"): 4e-6,
        _path(): 18e-6, _path("mg.fetch"): 19e-6})
    assert split.idle_ms_per_solve(
        lambda p: spans.layer(p) == "cycle") == pytest.approx(9e-3)


def test_a_trace_without_root_spans_has_no_solves():
    events = [e for e in _events() if e.name != ROOT]
    split = spans.reduce(events)
    assert split.solves == 0 and split.busy == {} and split.idle == {}


@pytest.mark.parametrize("path,layer", [
    (_path(), "outer"), (_path("mg.outer.split"), "outer"),
    (_path("mg.fetch"), "outer"), (_path("mg.outer.cycle"), "cycle"),
    (_path("mg.outer.cycle", "mg.L3.post_smooth"), "cycle"),
    (_path("mg.outer.cycle", "mg.bottom", "mg.fetch"), "cycle"),
    ("mg.solve/mg.L0.pre_smooth", "cycle"), ("mg.outer.cycle", None),
    (_path("mg.other"), None)])
def test_layer_of_a_path(path, layer):
    assert spans.layer(path) == layer


def _traced_run(busy_s=1.0):
    cell = registry.cell("p3d-257-ff32")
    trace = dataclasses.replace(_trace_of_nothing(), busy_s=busy_s)
    return harness.Run(cell=cell, family=None, setup_s=1.0, window_s=1.0,
                       durations_s=[0.1], attempted=1, failed=0,
                       iterations=[11], launches={},
                       memory_peak_bytes=0, trace=trace)


def _trace_of_nothing():
    from portbench import trace as tracing

    return tracing.Trace(window_s=1.0, busy_s=0.0, port_s=0.0, plain_s=0.0,
                         by_name={}, gaps={}, solves=3, iterations=[11] * 3)


def _read(run, names=NEW):
    return {name: registry.load_module("metrics", name).read(run)
            for name in names}


def test_metrics_of_names_the_new_metrics_in_traced_runs_only():
    bench = registry.benchmark()
    traced = registry.metrics_of(bench, "p3d-257-ff32", True)
    assert "solve_roofline" in traced
    assert traced[-5:] == list(NEW)
    assert not set(NEW) & set(registry.metrics_of(bench, "p3d-257-ff32",
                                                  False))
    for name in NEW:
        assert registry.load_module("metrics", name).UNIT


def test_each_new_reader_returns_none_without_a_trace():
    run = dataclasses.replace(_traced_run(), trace=None)
    assert _read(run) == dict.fromkeys(NEW)
    # a trace with no device events (a run on the CPU)
    assert _read(_traced_run(busy_s=0.0)) == dict.fromkeys(NEW)


def test_new_readers_read_one_measured_split(monkeypatch):
    calls = []

    def measure(cell, device, count):
        calls.append((cell["name"], count))
        return spans.reduce(_events(), host_syncs=12)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(spans, "measure", measure)
    got = _read(_traced_run())
    assert calls == [("p3d-257-ff32", 3)]
    assert got == pytest.approx({
        "outer.ff_device_ms_per_solve": 9e-3,
        "cycle.transfers_device_ms_per_solve": 9e-3,
        "outer.idle_ms_per_solve": 37e-3, "cycle.idle_ms_per_solve": 9e-3,
        "outer.host_syncs_per_solve": 12.0})
    # a program without the spans (the parent of this benchmark's metrics)
    monkeypatch.setattr(spans, "measure", lambda *a, **k: spans.reduce(
        [e for e in _events() if not e.name.startswith("mg.")]))
    assert _read(_traced_run()) == dict.fromkeys(NEW)


def test_a_cpu_slice_counts_its_solves_and_host_syncs():
    from portbench import traffic

    cell = small_cell("p3d-257-ff32")
    split = spans.measure(cell, "cpu", 2)
    assert split.solves == 2 and split.busy == {} and split.unlaunched_s == 0
    # the slice solves pool entries 1 and 2; the outer loop fetches once
    # per iteration and once more
    kw = cell["config"]["solver"]
    family = registry.load_module("solvers", "gmg")
    problem = registry.load_module("problems", cell["config"]["problem"])
    pool = traffic.make_pool(problem, kw["shape"], kw["length"],
                             cell["traffic"], spans.SEED, "cpu")
    solver = family.build(cell["config"], "cpu")
    iterations = [family.solve(solver, "solve_refined", b).iterations
                  for b in pool[1:3]]
    assert split.host_syncs == sum(iterations) + 2
