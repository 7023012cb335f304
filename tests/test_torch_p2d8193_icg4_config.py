"""The benchmark's ``p2d-8193-icg4`` cell (``portbench/``): the reference
CLI's test 1 at 8193^2, solved by the port's
``GMGSolver.solve_refined(b, inner_cg=4)`` (V-cycle-preconditioned CG in
each float-float correction).

* the cell and its configuration load: the solver keyword arguments of
  ``p2d-8193-ff32``'s configuration, ``inner_cg`` 4 beside them, the
  sibling's reference ``poisson_mg``; ``BENCHMARK.json`` names them, the
  cell's three new per-layer metrics, each read in this cell alone, and
  the accepted metrics of the outer loop, the 2D kernels and the device
  that read this cell too;
* the family ``gmg_pcg`` calls the solver's own entry with the
  configuration's ``inner_cg``; cut to 65^2, its answers to the cell's
  seeded right-hand sides lie within the cell's ``u_rel_err`` of the plain
  reference;
* a run on the CPU reads the iterations and no device metric.
"""

from __future__ import annotations

import copy
import time

import pytest
import torch

from portbench import harness, registry, traffic

torch.set_num_threads(1)

CELL = "p2d-8193-icg4"
CONFIG = "poisson2d-8193-mgpcg"
SIBLING = "poisson2d-8193-gmg"
SMALL = dict(shape=[65, 65], num_levels=4, pad_align=128)
NEW = ("icg.apply_roofline", "icg.krylov_device_ms_per_solve",
       "icg.solve_roofline")
# read after them: the set-up split of every cell
SETUP = ("setup.kernel_library_s", "setup.solver_s", "setup.first_solve_s",
         "setup.outside_program_s", "setup.kernel_builds")
# accepted metrics whose readers find this cell's spans and counters: the
# cells that listed them before, then this one
SHARED = {name: "p3d-257-ff32" for name in (
    "solver.iterations", "wrappers.launches_per_solve",
    "plain_ops.device_ms_per_solve", "device.idle_share",
    "outer.host_syncs_per_solve")}
SHARED.update({name: "p2d-8193-ff32" for name in (
    "k2d.rbgs_fused_roofline", "k2d.residual_roofline",
    "k2d.transfers_roofline", "k2d.ff_residual_roofline",
    "p2d.outer.ff_device_ms_per_solve", "p2d.idle_ms_per_solve")})


def _small_cell():
    cell = copy.deepcopy(registry.cell(CELL))
    cell["config"]["solver"].update(SMALL)
    return cell


def _pool(cell, seed):
    config = cell["config"]
    kw = config["solver"]
    problem = registry.load_module("problems", config["problem"])
    return traffic.make_pool(problem, kw["shape"], kw["length"],
                             cell["traffic"], seed, "cpu")


def test_the_cell_and_its_configuration_load():
    cell = registry.cell(CELL)
    sibling = registry.load_json("configs", SIBLING)
    assert (cell["config_name"], cell["traffic_name"]) == (CONFIG,
                                                           "closed-pool16")
    assert cell["entry"] == "solve_refined"
    assert (cell["warmup_solves"], cell["sample"], cell["trace_solves"]) \
        == (2, 8, 3)
    assert cell["limits"] == registry.cell("p2d-8193-ff32")["limits"]
    config = cell["config"]
    assert (config["family"], config["problem"], config["reference"]) == (
        "gmg_pcg", "poisson2d_test1", "poisson_mg")
    assert config["solver"] == sibling["solver"]
    assert config["bottom"] == sibling["bottom"]
    assert config["inner_cg"] == 4
    assert config["reduced"] == [] and config["guarantees"] == \
        sibling["guarantees"]
    assert set(sibling["assumed"]) | {"inner_cg"} == set(config["assumed"])


def test_benchmark_json_names_the_cell_and_its_metrics():
    bench = registry.benchmark()
    configs = {c["name"]: c for c in bench["configs"]}
    assert configs[CONFIG]["reduced"] == []
    assert configs[CONFIG]["file"] == f"portbench/configs/{CONFIG}.json"
    assert len(configs[CONFIG]["source"]) <= 200
    cells = {w["name"]: w for w in bench["workloads"]}
    assert (cells[CELL]["config"], cells[CELL]["traffic"],
            cells[CELL]["chips"]) == (CONFIG, "closed-pool16", 1)
    assert cells[CELL]["why"] == registry.cell(CELL)["why"]
    assert len(cells[CELL]["why"]) <= 200
    assert registry.metrics_of(bench, CELL, False) == [
        "solve_ms", "solve_ms_p90", "setup_s"]
    assert registry.metrics_of(bench, CELL, True) == [*SHARED, *NEW,
                                                      *SETUP]


@pytest.mark.parametrize("name", NEW)
def test_each_new_metric_is_read_in_the_cell_alone(name):
    entry = {m["name"]: m for m in registry.benchmark()["per_layer"]}[name]
    assert entry["workloads"] == [CELL]
    assert entry["moves"] == "solve_ms"
    assert entry["source"] == "device_trace"
    reader = registry.load_module("metrics", name)
    assert reader.UNIT == entry["unit"]
    assert entry["better"] == ("higher" if reader.UNIT == "%" else "lower")


@pytest.mark.parametrize("name", SHARED)
def test_accepted_metrics_read_in_the_cell_after_their_own(name):
    entry = {m["name"]: m for m in registry.benchmark()["per_layer"]}[name]
    assert entry["workloads"] == [SHARED[name], CELL]
    assert entry["moves"] == "solve_ms"


def test_the_family_calls_the_solvers_entry_with_inner_cg():
    cell = _small_cell()
    family = registry.load_module("solvers", "gmg_pcg")
    pcg = family.build(cell["config"], "cpu")
    assert pcg.inner_cg == 4
    b = _pool(cell, 23)[0]
    ans = family.solve(pcg, cell["entry"], b)
    want = pcg.solver.solve_refined(b, inner_cg=4)
    assert torch.equal(ans.u, want.u) and ans.iterations == want.iterations
    assert ans.residual == float(want.history[-1]) and ans.converged
    # a control's entry is the solver's own, without inner_cg
    plain = family.solve(pcg, "solve", b)
    assert torch.equal(plain.u, pcg.solver.solve(b).u)


@pytest.mark.parametrize("seed", [29, 2 ** 31 + 29])
def test_cut_cell_answers_lie_within_the_limit(seed):
    cell = _small_cell()
    family = registry.load_module("solvers", "gmg_pcg")
    solver = family.build(cell["config"], "cpu")
    pool = _pool(cell, seed)[:3]
    answers, residuals, failed = [], [], 0
    for j, b in enumerate(pool):
        ans = family.solve(solver, cell["entry"], b)
        answers.append((j, ans.u))
        residuals.append(ans.residual)
        failed += not ans.converged
    checks = harness.compare(cell, pool, answers, residuals, failed)
    assert harness.passed(checks), checks


def test_a_cpu_run_reads_the_iterations_and_no_device_metric():
    cell = _small_cell()
    cell["trace_solves"] = 1
    run, checks = harness.run_cell(cell, 2 ** 31 + 31, 0.2, True, "cpu",
                                   time.perf_counter())
    assert harness.passed(checks), checks
    got = harness.read_metrics(run, [*SHARED, *NEW])
    assert set(got) == {"solver.iterations"}
    iterations = set(run.iterations) | set(run.trace.iterations)
    assert len(iterations) == 1
    assert got["solver.iterations"]["value"] == iterations.pop()
