"""The benchmark's set-up metrics (``portbench/metrics/setup.*``,
``amg.setup_*``, through ``portbench/setup_split.py``) on a fake run and a
filled set-up log, and on small CPU runs of the harness:

* ``setup.kernel_library_s``, ``setup.solver_s``, ``setup.first_solve_s``
  and ``setup.outside_program_s`` partition ``setup_s``;
* the readers take each owner's first record when later builds exist;
* each reader returns ``None`` on an empty log (``setup.kernel_builds``
  where the program has no such counter);
* ``BENCHMARK.json`` names the nine metrics with their layer, source,
  end-to-end metric and cells.
"""

from __future__ import annotations

import copy
import time
import types

import pytest
import torch

from multigrid_prj_tpu_torch.utils import metrics
from portbench import harness, registry

torch.set_num_threads(1)

SETUP = ("setup.kernel_library_s", "setup.solver_s", "setup.first_solve_s",
         "setup.outside_program_s")
BUILDS = "setup.kernel_builds"
AMG = ("amg.setup_p1_s", "amg.setup_coarsening_s",
       "amg.setup_interpolation_s", "amg.setup_rap_s")
CELLS = ["p3d-257-ff32", "p2d-8193-ff32", "amg-p1-2049-ff32",
         "p2d-8193-icg4"]
RUN = types.SimpleNamespace(setup_s=20.0)


@pytest.fixture(autouse=True)
def log(monkeypatch):
    fresh = []
    monkeypatch.setattr(metrics, "SETUP_LOG", fresh)
    return fresh


def _record(owner, first_solve_s=None, **phases):
    return metrics.PhaseTimer(phases=dict(phases), owner=owner,
                              first_solve_s=first_solve_s)


def _fill(kind):
    """A cell's records in the order the harness makes them, with their
    parts: ``{metric: value}``."""
    if kind == "gmg":
        _record("GMGSolver", 2.5, hierarchy=0.25, bottom_inverse=1.5)
        _record("kernel_library", kernel_library=0.125, kernel_build=4.0)
        return {"setup.kernel_library_s": 4.125, "setup.solver_s": 1.75,
                "setup.first_solve_s": 2.5,
                "setup.outside_program_s": 20.0 - 8.375}
    _record("TriangularMesh", mesh=1.0)
    _record("P1System", p1_assembly=2.0, p1_upload=0.5)
    _record("AMGSolver", 0.75, rcm=0.5, coarsening=3.0, interpolation=4.0,
            rap=5.0, upload=1.0, bottom_inverse=0.25)
    _record("kernel_library", kernel_library=0.125, kernel_build=0.0)
    return {"setup.kernel_library_s": 0.125, "setup.solver_s": 17.25,
            "setup.first_solve_s": 0.75,
            "setup.outside_program_s": 20.0 - 18.125,
            "amg.setup_p1_s": 3.5, "amg.setup_coarsening_s": 3.0,
            "amg.setup_interpolation_s": 4.0, "amg.setup_rap_s": 5.0}


def _read(name, run=RUN):
    return registry.load_module("metrics", name).read(run)


@pytest.mark.parametrize("kind", ["gmg", "amg"])
def test_the_four_parts_partition_setup_s(kind):
    want = _fill(kind)
    got = {name: _read(name) for name in want}
    assert got == want
    assert sum(got[name] for name in SETUP) == RUN.setup_s
    if kind == "gmg":
        assert all(_read(name) is None for name in AMG)


@pytest.mark.parametrize("kind", ["gmg", "amg"])
def test_the_readers_take_each_owners_first_record(kind, log):
    want = _fill(kind)
    first = list(log)
    _fill(kind)  # a traced run's later builds of the cell's solver
    log[-1].phases["kernel_build"] = 9.0
    assert log[:len(first)] == first and len(log) > len(first)
    assert {name: _read(name) for name in want} == want


@pytest.mark.parametrize("name", SETUP + AMG)
def test_each_reader_returns_none_on_an_empty_log(name):
    assert _read(name) is None


def test_kernel_builds_reads_the_counter(monkeypatch):
    monkeypatch.setitem(metrics.COUNTERS, "kernel_builds", 1)
    assert _read(BUILDS) == 1
    monkeypatch.setitem(metrics.COUNTERS, "kernel_builds", 0)
    assert _read(BUILDS) == 0
    monkeypatch.delitem(metrics.COUNTERS, "kernel_builds")
    assert _read(BUILDS) is None


@pytest.mark.parametrize("name", SETUP + (BUILDS,) + AMG)
def test_benchmark_json_names_each_setup_metric(name):
    bench = registry.benchmark()
    entry = {m["name"]: m for m in bench["per_layer"]}[name]
    assert set(entry) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    assert entry["moves"] == "setup_s" and entry["better"] == "lower"
    assert entry["unit"] == registry.load_module("metrics", name).UNIT
    assert entry["source"] == ("program_counter" if name == BUILDS
                               else "host_clock")
    if name in AMG:
        assert entry["layer"] == "AMG set-up"
        assert entry["workloads"] == ["amg-p1-2049-ff32"]
    else:
        assert entry["layer"] == "set-up"
        assert entry["workloads"] == CELLS
    # appended after every accepted entry
    names = [m["name"] for m in bench["per_layer"]]
    assert names[-9:] == [*SETUP, BUILDS, *AMG]


@pytest.mark.parametrize("name,small", [
    ("p3d-257-ff32", dict(shape=[17, 17, 17], num_levels=3)),
    ("p2d-8193-ff32", dict(shape=[65, 65], num_levels=4, pad_align=128)),
    ("amg-p1-2049-ff32", dict(shape=[65, 65], num_levels=3))])
def test_a_cpu_run_splits_its_setup_s(name, small, monkeypatch):
    cell = copy.deepcopy(registry.cell(name))
    cell["config"]["solver"].update(small)
    family = registry.load_module("solvers", cell["config"]["family"])
    if hasattr(family, "_BUILT"):  # the amg family keeps what it built
        monkeypatch.setattr(family, "_BUILT", {})
    t0 = time.perf_counter()
    run, checks = harness.run_cell(cell, 2 ** 31 + 7, 0.2, False, "cpu", t0)
    assert harness.passed(checks), checks
    got = harness.read_metrics(run, [*SETUP, *AMG])
    # the CPU loads no kernel library
    assert set(got) == set(SETUP[1:]) | (set(AMG) if "amg" in name
                                         else set())
    parts = [got[n]["value"] for n in SETUP[1:]]
    assert all(p >= 0 for p in parts)
    assert sum(parts) == pytest.approx(run.setup_s, abs=1e-9)
    if "amg" in name:
        hierarchy = _read("amg.setup_hierarchy_s", run)
        assert sum(got[n]["value"] for n in AMG[1:]) <= hierarchy \
            <= got["setup.solver_s"]["value"]
