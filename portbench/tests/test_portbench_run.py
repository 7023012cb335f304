"""Whole runs: refused without a card or without the program, no JAX
module loaded, and ``correct`` false with the timed path broken."""

from __future__ import annotations

import dataclasses
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness, registry
from portbench import trace as tracing
from portbench.tests._small import small_cell

REPO = registry.HERE.parent
ARGS = ["--workload", "p3d-257-ff32", "--seed", "3", "--seconds", "1",
        "--trace", "0"]


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "portbench/run.py", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_a_run_without_a_card_prints_no_result():
    out = _run(REPO, dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_a_run_without_the_program_fails(tmp_path):
    shutil.copytree(registry.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(registry.BENCHMARK, tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _run(tmp_path, env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


IMPORT_ALL = """
import importlib, json, sys
sys.path.insert(0, sys.argv[1])
from portbench import registry
for mod in ("control", "harness", "registry", "roofline", "trace", "traffic",
            "run", "tests._small"):
    importlib.import_module("portbench." + mod)
for kind in ("solvers", "problems", "reference", "metrics"):
    for path in (registry.HERE / kind).glob("*.py"):
        if path.name != "__init__.py":
            registry.load_module(kind, path.name[:-3])
registry.load_module("solvers", "gmg").build(
    registry.load_json("configs", "poisson2d-gmg"), "cpu")
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_no_module_of_jax_or_the_jax_package_is_loaded():
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL, str(REPO)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "multigrid_prj_tpu_torch" in tops and "portbench" in tops
    assert not tops & set(harness.FORBIDDEN)


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    for name in ("multigrid_prj_tpu_torch.gmg", "jaxtyping", "flaxen",
                 "multigrid_prj_tpu.ops", "jax.numpy"):
        monkeypatch.setitem(sys.modules, name, sys)
    found = harness.forbidden_modules()
    assert "multigrid_prj_tpu.ops" in found and "jax.numpy" in found
    assert not {"multigrid_prj_tpu_torch.gmg", "jaxtyping",
                "flaxen"} & set(found)


def test_reservoir_is_drawn_from_the_seed():
    def draw(seed, n=1000):
        r = harness.Reservoir(8, seed)
        for i in range(n):
            r.offer(i)
        return r.items

    assert draw(5) == draw(5) and draw(5) != draw(6)
    assert len(set(draw(5))) == 8 and max(draw(5)) > 100
    assert draw(5, n=3) == [0, 1, 2]


def _break_unchanged(monkeypatch):
    from multigrid_prj_tpu_torch.gmg import GMGSolver

    monkeypatch.setattr(GMGSolver, "_error_cycle",
                        lambda self, r, cinv=None: torch.zeros_like(r))


def _break_half_grid(monkeypatch):
    from multigrid_prj_tpu_torch.gmg import GMGSolver

    cycle = GMGSolver._error_cycle

    def half(self, r, cinv=None):
        e = cycle(self, r, cinv)
        e[: e.shape[0] // 2] = 0.0
        return e

    monkeypatch.setattr(GMGSolver, "_error_cycle", half)


def _break_answer(monkeypatch):
    from multigrid_prj_tpu_torch.gmg import GMGSolver

    solve = GMGSolver.solve_refined

    def altered(self, b, inner_cg=0):
        res = solve(self, b, inner_cg)
        return dataclasses.replace(res, u=res.u * (1 + 1e-6))

    monkeypatch.setattr(GMGSolver, "solve_refined", altered)


# the faults a solve can have: a step that leaves the state unchanged, the
# correction left out on half the grid (the batch a solve has), and the
# answer altered where it is produced; one card, so no exchange to drop
FAULTS = {"unchanged": _break_unchanged, "half_grid": _break_half_grid,
          "answer": _break_answer}


@pytest.mark.parametrize("cell_name", ["p2d-1025-ff32", "p3d-257-ff32"])
@pytest.mark.parametrize("fault", [None, *FAULTS])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell_name, fault):
    cell = small_cell(cell_name)
    if fault is not None:
        FAULTS[fault](monkeypatch)
    run, checks = harness.run_cell(cell, 2 ** 31 + 9, 0.3, False, "cpu",
                                   time.perf_counter())
    assert run.attempted >= 1 and run.durations_s
    assert harness.passed(checks) is (fault is None), checks
    names = registry.metrics_of(registry.benchmark(), cell_name, False)
    got = set(harness.read_metrics(run, names))
    # a broken solve may be the window's only one: no percentile then
    assert got == set(names) if fault is None else {"setup_s", "solve_ms"} <= got


def test_traced_run_reads_its_host_metrics():
    cell = small_cell("p3d-257-ff32")
    cell["trace_solves"] = 2
    run, checks = harness.run_cell(cell, 17, 0.2, True, "cpu",
                                   time.perf_counter())
    assert harness.passed(checks)
    assert run.trace.solves == 2 and len(run.trace.iterations) == 2
    names = registry.metrics_of(registry.benchmark(), cell["name"], True)
    got = harness.read_metrics(run, names)
    # the CPU trace has no device events: only the counters read
    assert set(got) == {"solver.iterations"}
    assert tracing.breakdown(run.trace) == {"device_ops": [], "idle_gaps": []}


@dataclasses.dataclass
class _Ev:
    name: str
    device_type: object
    start: float
    end: float
    thread: int = 1

    @property
    def time_range(self):
        return self

    def elapsed_us(self):
        return self.end - self.start


def test_trace_reduction_on_a_synthetic_trace():
    from torch.autograd import DeviceType

    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    port = "void (anonymous namespace)::rbgs_fused_kernel<2>(float const*)"
    events = [_Ev(tracing.SPAN, cpu, 0, 100), _Ev(tracing.SPAN, gpu, 0, 100),
              _Ev("aten::add", cpu, 10, 30), _Ev("cudaLaunchKernel", cpu, 25, 28),
              _Ev(port, gpu, 5, 20),
              _Ev("void at::native::(anonymous namespace)::reduce<4>(int)",
                  gpu, 30, 40),
              _Ev(port, gpu, 60, 70),
              _Ev("aten::mul", cpu, 45, 55, thread=2)]
    tr = tracing.summarize(events, 100e-6, frozenset({"rbgs_fused_kernel"}),
                           1, [9])
    assert tr.busy_s == pytest.approx(35e-6)
    assert tr.port_s == pytest.approx(25e-6)
    assert tr.plain_s == pytest.approx(10e-6)
    # gaps: 20-30 (midpoint 25, inside aten::add and its launch: the
    # innermost), 40-60 (midpoint 50, only the span on the solve thread)
    assert tr.gaps == pytest.approx({"cudaLaunchKernel": 10e-6,
                                     "python between torch ops": 20e-6})
    bd = tracing.breakdown(tr)
    assert bd["device_ops"] == [["rbgs_fused_kernel<2>", pytest.approx(25e-6)],
                                ["at::native::reduce<4>", pytest.approx(10e-6)]]


def test_short_names_of_recorded_kernels():
    name = ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<"
            "float, at::native::func_wrapper_t<float, at::native::sum_functor"
            "<float, float, float>::operator()(at::TensorIterator&)::{lambda"
            "(float, float)#1}> > >(at::native::ReduceOp<float> )")
    assert tracing.short_name(name).startswith("at::native::reduce_kernel<512")
    assert tracing.short_name(name[:190] + "(int)") == name[5:190]
    assert not tracing.is_port_kernel(name, tracing.port_kernel_names())
    assert tracing.is_port_kernel(
        "void (anonymous namespace)::stencil3d_march_kernel<true>(float "
        "const*, int)", tracing.port_kernel_names())
