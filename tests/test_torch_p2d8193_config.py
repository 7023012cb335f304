"""The benchmark's ``p2d-8193-ff32`` cell (``portbench/``): the reference
CLI's test 1 at 8193^2, solved by ``GMGSolver.solve_refined`` of the port.

* the cell and its configuration load, with the settings they state, and
  ``BENCHMARK.json`` names them and the cell's seven per-layer metrics;
* cut to 65^2 (padded to 128, 4 levels, dense bottom: as
  ``portbench/tests/_small.SMALL[2]``), the port's answers to the cell's
  seeded right-hand sides lie within the cell's ``u_rel_err`` of the plain
  reference's float64 solution, and the program's plain-f32 ``solve``
  does not;
* uncut, the hierarchy has 8 levels down to 65^2, every one padded, so
  the 2D kernels run at each, and its 66^2 physical bottom is small
  enough for the dense inverse.
"""

from __future__ import annotations

import copy
import math

import pytest
import torch

from multigrid_prj_tpu_torch.grids import build_hierarchy
from portbench import harness, registry, traffic

torch.set_num_threads(1)

CELL = "p2d-8193-ff32"
CONFIG = "poisson2d-8193-gmg"
SMALL = dict(shape=[65, 65], num_levels=4, pad_align=128)
PER_LAYER = ("k2d.rbgs_fused_roofline", "k2d.residual_roofline",
             "k2d.transfers_roofline", "k2d.ff_residual_roofline",
             "p2d.outer.ff_device_ms_per_solve", "p2d.idle_ms_per_solve",
             "p2d.solve_roofline")
# read after them: the set-up split of every cell
SETUP = ("setup.kernel_library_s", "setup.solver_s", "setup.first_solve_s",
         "setup.outside_program_s", "setup.kernel_builds")
# GMGSolver._build_coarse_inverse's max_nodes: above it the bottom smooths
DENSE_INVERSE_MAX_NODES = 4608


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
    assert (cell["config_name"], cell["traffic_name"]) == (CONFIG,
                                                           "closed-pool16")
    assert cell["entry"] == "solve_refined"
    assert (cell["warmup_solves"], cell["sample"], cell["trace_solves"]) \
        == (2, 8, 3)
    config = cell["config"]
    assert (config["family"], config["problem"], config["reference"]) == (
        "gmg", "poisson2d_test1", "poisson_mg")
    assert config["solver"] == {
        "shape": [8193, 8193], "length": 10.0, "alpha": 10.0,
        "num_levels": 8, "cycle": "v", "nu": 2, "pre_sweeps": 2,
        "tol": 1e-07, "maxit": 200, "pad_align": 256}
    assert config["bottom"] == {"stage": "dense_inverse"}
    assert config["reduced"] == []
    assert 0 < cell["limits"]["u_rel_err"] < 1e-6


def test_benchmark_json_names_the_cell_and_its_metrics():
    bench = registry.benchmark()
    configs = {c["name"]: c for c in bench["configs"]}
    assert configs[CONFIG]["reduced"] == []
    assert configs[CONFIG]["file"] == f"portbench/configs/{CONFIG}.json"
    cells = {w["name"]: w for w in bench["workloads"]}
    assert (cells[CELL]["config"], cells[CELL]["traffic"],
            cells[CELL]["chips"]) == (CONFIG, "closed-pool16", 1)
    assert cells[CELL]["why"] == registry.cell(CELL)["why"]
    assert registry.metrics_of(bench, CELL, False) == [
        "solve_ms", "solve_ms_p90", "setup_s"]
    assert registry.metrics_of(bench, CELL, True) == [*PER_LAYER, *SETUP]


@pytest.mark.parametrize("name", PER_LAYER)
def test_each_new_metric_reads_the_device_trace_of_the_cell(name):
    entry = {m["name"]: m for m in registry.benchmark()["per_layer"]}[name]
    # the 2D kernels' and the outer loop's readers also read the cell whose
    # corrections are V-cycle-preconditioned CG on the same kernels
    also = [] if name == "p2d.solve_roofline" else ["p2d-8193-icg4"]
    assert entry["workloads"] == [CELL, *also]
    assert entry["source"] == "device_trace"
    assert entry["moves"] == "solve_ms"
    reader = registry.load_module("metrics", name)
    assert reader.UNIT == entry["unit"]
    assert entry["better"] == ("higher" if reader.UNIT == "%" else "lower")


@pytest.mark.parametrize("seed", [19, 2 ** 31 + 19])
def test_cut_cell_answers_lie_within_the_limit(seed):
    cell = _small_cell()
    family = registry.load_module("solvers", "gmg")
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


def test_the_plain_f32_solve_fails_the_limit():
    cell = _small_cell()
    kw = cell["config"]["solver"]
    family = registry.load_module("solvers", "gmg")
    reference = registry.load_module("reference", "poisson_mg")
    solver = family.build(cell["config"], "cpu")
    b = _pool(cell, 19)[0]
    exact = reference.solve(b, kw["alpha"], kw["length"])
    for entry, within in (("solve_refined", True), ("solve", False)):
        u = family.solve(solver, entry, b).u
        err = float(torch.linalg.vector_norm(u.to(exact.dtype) - exact)
                    / torch.linalg.vector_norm(exact))
        assert (err <= cell["limits"]["u_rel_err"]) == within, (entry, err)


def test_the_uncut_hierarchy_ends_on_the_dense_inverse():
    config = registry.cell(CELL)["config"]
    kw = config["solver"]
    shapes = registry.load_module("solvers", "gmg").level_shapes(config)
    assert shapes == [(n, n) for n in (8193, 4097, 2049, 1025, 513, 257,
                                       129, 65)]
    levels = build_hierarchy(kw["shape"], kw["length"], kw["num_levels"],
                             pad_align=kw["pad_align"])
    assert [lev.shape for lev in levels] == shapes
    assert all(lev.padded_shape is not None for lev in levels)
    assert levels[0].physical == (8448, 8448)
    assert levels[-1].physical == (66, 66)
    assert math.prod(levels[-1].physical) <= DENSE_INVERSE_MAX_NODES
