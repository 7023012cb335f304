"""The benchmark's split of a profiled slice by (innermost ``mg.*`` span,
kernel) (``portbench/kernel_split.py``) and the ``p2d-8193-ff32`` cell's
readers built on it, on synthetic profiler-like events:

* a kernel launched under ``mg.L<k>.<stage>`` is priced at level k's
  logical grid, one under ``mg.outer.ff_residual`` at the finest;
* a launch that no span encloses is not counted;
* a kernel that runs exactly in its least time reads 100 %.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch
from torch.autograd import DeviceType

from portbench import harness, kernel_split, registry, roofline
from portbench import trace as tracing

torch.set_num_threads(1)

CELL = "p2d-8193-ff32"
ROOT = "mg.solve_refined"
SHARES = ("k2d.rbgs_fused_roofline", "k2d.residual_roofline",
          "k2d.transfers_roofline", "k2d.ff_residual_roofline")
READERS = SHARES + ("p2d.outer.ff_device_ms_per_solve",
                    "p2d.idle_ms_per_solve", "p2d.solve_roofline")


@dataclasses.dataclass
class _Ev:
    name: str
    device_type: object
    start: float  # microseconds, as the profiler's time ranges
    end: float
    id: int = 0
    thread: int = 1
    is_user_annotation: bool = False

    @property
    def time_range(self):
        return self

    def elapsed_us(self):
        return self.end - self.start


def _kernel(name):
    """A device event's name as the profiler gives a ``csrc`` kernel's."""
    return f"void (anonymous namespace)::{name}(float const*, float*, int)"


def _shapes():
    cell = registry.cell(CELL)
    return registry.load_module("solvers", "gmg").level_shapes(cell["config"])


def _least_us(stage, level):
    nbytes, _ = roofline.stage_cost(stage, _shapes()[level])
    return nbytes / roofline.HBM_BYTES_PER_S * 1e6


def _solve(launches, outside=()):
    """One solve on thread 1: ``launches`` are ``(span, kernel, device
    microseconds)``, each span holding one launch, the spans one after
    another inside the root (a level's stages inside ``mg.outer.cycle``);
    ``outside`` are ``(kernel, device microseconds)`` launched after the
    root has closed."""
    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    host, device = [], []
    t = 10.0
    for i, (span, kernel, us) in enumerate(launches, start=1):
        if span.startswith("mg.L"):
            host.append(_Ev("mg.outer.cycle", cpu, t, t + 5))
        host += [_Ev(span, cpu, t + 1, t + 4),
                 _Ev("cudaLaunchKernel", cpu, t + 2, t + 3, id=i)]
        device.append(_Ev(_kernel(kernel), gpu, 1000.0 * i,
                          1000.0 * i + us, id=i))
        t += 10
    end = 1000.0 * (len(launches) + 1)  # the root spans every launch's run
    host.insert(0, _Ev(ROOT, cpu, 0, end))
    for j, (kernel, us) in enumerate(outside, start=len(launches) + 1):
        host.append(_Ev("cudaLaunchKernel", cpu, end + j, end + j + 0.5,
                        id=j))
        device.append(_Ev(_kernel(kernel), gpu, 1000.0 * j,
                          1000.0 * j + us, id=j))
    return host + device


def _share(name, events):
    picks = registry.load_module("metrics", name).PICKS
    return kernel_split.share(kernel_split.reduce(events), picks, _shapes())


def test_kernel_name_drops_namespaces_templates_and_arguments():
    assert kernel_split.kernel_name(
        "void (anonymous namespace)::rbgs_fused_kernel<2>(float const*, "
        "float const*, float*, int, int, int, int, float, int4)") \
        == "rbgs_fused_kernel"
    assert kernel_split.kernel_name("void at::native::vectorized_elementwise"
                                    "_kernel<4, at::native::CUDAFunctor_add"
                                    "<float> >(int, float*)") \
        == "vectorized_elementwise_kernel"


def test_a_launch_is_keyed_by_its_innermost_span_path_and_kernel():
    split = kernel_split.reduce(_solve(
        [("mg.L3.residual", "residual_kernel", 4.0),
         ("mg.outer.ff_residual", "ff_residual_kernel", 6.0)]))
    assert split.kernels == pytest.approx({
        (f"{ROOT}/mg.outer.cycle/mg.L3.residual", "residual_kernel"):
            [4e-6, 1],
        (f"{ROOT}/mg.outer.ff_residual", "ff_residual_kernel"): [6e-6, 1]})
    assert split.spans.solves == 1
    assert split.device_s == pytest.approx(10e-6)
    assert split.covered_s() == pytest.approx(10e-6)


def test_a_kernel_under_a_level_span_is_priced_at_that_level():
    least = _least_us("residual", 3)
    # level 3 of 8193^2 is 1025^2 logical points: 12 bytes a point
    assert least == pytest.approx(12 * 1025 ** 2 / 3.35e12 * 1e6)
    at_least = _solve([("mg.L3.residual", "residual_kernel", least)])
    assert _share("k2d.residual_roofline", at_least) == pytest.approx(100.0)
    twice = _solve([("mg.L3.residual", "residual_kernel", least),
                    ("mg.L3.residual", "residual_kernel", 3 * least)])
    assert _share("k2d.residual_roofline", twice) == pytest.approx(50.0)


def test_a_launch_that_no_span_encloses_is_not_counted():
    least = _least_us("residual", 1)
    events = _solve([("mg.L1.residual", "residual_kernel", least)],
                    outside=[("residual_kernel", 7 * least)])
    split = kernel_split.reduce(events)
    assert sum(n for _, n in split.kernels.values()) == 1
    assert split.device_s == pytest.approx(8 * least / 1e6)
    assert split.covered_s() == pytest.approx(least / 1e6)
    assert _share("k2d.residual_roofline", events) == pytest.approx(100.0)


@pytest.mark.parametrize("name,launches", [
    ("k2d.rbgs_fused_roofline",
     [("mg.L0.pre_smooth", "rbgs_fused_kernel", "smoother", 0),
      ("mg.L5.post_smooth", "rbgs_fused_kernel", "smoother", 5)]),
    ("k2d.residual_roofline",
     [("mg.L6.residual", "residual_kernel", "residual", 6)]),
    ("k2d.transfers_roofline",
     [("mg.L2.restrict", "restrict_fw_kernel", "restriction", 2),
      ("mg.L2.prolong_add", "prolong_add_stream_kernel", "prolong_add", 2)]),
    ("k2d.ff_residual_roofline",
     [("mg.outer.ff_residual", "ff_residual_kernel", "ff_residual", 0)])])
def test_each_share_reads_100_at_its_least_time(name, launches):
    events = _solve([(span, kernel, _least_us(stage, level))
                     for span, kernel, stage, level in launches])
    assert _share(name, events) == pytest.approx(100.0)


@pytest.mark.parametrize("name", SHARES)
def test_a_share_leaves_out_other_kernels_and_spans(name):
    # the smoother's kernel under a residual span, the plain ops, and the
    # 3D march under a smoothing span are no 2D kernel's work
    events = _solve([("mg.L1.residual", "rbgs_fused_kernel", 5.0),
                     ("mg.L1.pre_smooth", "vectorized_elementwise_kernel",
                      5.0),
                     ("mg.L0.pre_smooth", "rbgs3d_zmarch_kernel", 5.0)])
    assert _share(name, events) is None


def _run(trace=True):
    cell = registry.cell(CELL)
    traced = tracing.Trace(window_s=1.0, busy_s=0.5, port_s=0.4,
                           plain_s=0.1, by_name={}, gaps={}, solves=3,
                           iterations=[9] * 3) if trace else None
    return harness.Run(cell=cell, family=registry.load_module("solvers",
                                                               "gmg"),
                       setup_s=1.0, window_s=1.0, durations_s=[0.1],
                       attempted=1, failed=0, iterations=[9], launches={},
                       memory_peak_bytes=0, trace=traced)


def _read(run):
    return {name: registry.load_module("metrics", name).read(run)
            for name in READERS}


def test_the_readers_read_one_measured_split(monkeypatch):
    least = {stage: _least_us(stage, level) for stage, level in (
        ("smoother", 0), ("residual", 0), ("restriction", 0),
        ("prolong_add", 0), ("ff_residual", 0))}
    events = _solve([
        ("mg.L0.pre_smooth", "rbgs_fused_kernel", 2 * least["smoother"]),
        ("mg.L0.residual", "residual_kernel", 4 * least["residual"]),
        ("mg.L0.restrict", "restrict_fw_kernel", least["restriction"]),
        ("mg.L0.prolong_add", "prolong_add_stream_kernel",
         least["prolong_add"]),
        ("mg.outer.ff_residual", "ff_residual_kernel",
         1.25 * least["ff_residual"]),
        ("mg.outer.pair_update", "vectorized_elementwise_kernel", 500.0)])
    calls = []

    def measure(cell, device, count):
        calls.append((cell["name"], count))
        return kernel_split.reduce(events, [9] * count)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(kernel_split, "measure", measure)
    run = _run()
    got = _read(run)
    assert calls == [(CELL, 3)]
    # the device events start 1000 us apart, inside the root: the idle is
    # what the first five leave of the 5000 us before the sixth
    busy = 1.25 * least["ff_residual"] + 500.0
    idle = 5000.0 - sum(e.elapsed_us() for e in events
                        if e.device_type == DeviceType.CUDA
                        and e.start < 6000.0)
    least_solve = roofline.least_seconds(run.family.schedule(
        run.cell["config"], run.cell["entry"], 9))
    device_us = sum(e.elapsed_us() for e in events
                    if e.device_type == DeviceType.CUDA)
    expect = {"k2d.rbgs_fused_roofline": 50.0,
              "k2d.residual_roofline": 25.0,
              "k2d.transfers_roofline": 100.0,
              "k2d.ff_residual_roofline": 80.0,
              "p2d.outer.ff_device_ms_per_solve": busy / 1e3,
              "p2d.idle_ms_per_solve": idle / 1e3,
              "p2d.solve_roofline": 100 * 3 * least_solve / device_us * 1e6}
    assert got == pytest.approx(expect)


def test_the_readers_return_none_without_a_trace_or_spans(monkeypatch):
    assert _read(_run(trace=False)) == dict.fromkeys(READERS)
    # a traced run with no card: no slice is measured
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert _read(_run()) == dict.fromkeys(READERS)
    # a program without the spans
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(kernel_split, "measure", lambda *a, **k:
                        kernel_split.reduce([e for e in _solve(
                            [("mg.L0.residual", "residual_kernel", 5.0)])
                            if not e.name.startswith("mg.")], [9]))
    assert _read(_run()) == dict.fromkeys(READERS)
    # a slice that never agreed with the CUDA events around it
    monkeypatch.setattr(kernel_split, "measure", lambda *a, **k: None)
    assert _read(_run()) == dict.fromkeys(READERS)


@pytest.mark.parametrize("elapsed_us,agrees", [
    (1005.0, True), (1020.0, True), (990.0, True),
    (1030.0, False), (980.0, False), (2115.0, False)])
def test_a_slice_agrees_with_cuda_events_within_the_tolerance(elapsed_us,
                                                             agrees):
    # two launches: the device events span 1000 us to 2000 + 5 us; the
    # last case is the slice that read its kernels 2.1 times too fast
    split = kernel_split.reduce(_solve(
        [("mg.L0.residual", "residual_kernel", 5.0),
         ("mg.L1.residual", "residual_kernel", 5.0)]))
    assert split.span_s == pytest.approx(1005e-6)
    assert split.agrees(elapsed_us / 1e6) is agrees
