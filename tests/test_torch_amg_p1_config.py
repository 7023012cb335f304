"""The benchmark's ``amg-p1-2049-ff32`` cell (``portbench/``): the
reference's AMG problem, P1 on a 2049^2 triangulation of the unit square,
solved by ``AMGSolver.solve_p1`` (``solve_refined``) of the port.

* the cell and its configuration load, with the settings they state, and
  ``BENCHMARK.json`` names them and the cell's six per-layer metrics;
* cut to 65^2 nodes and 3 levels, the port's answers to the cell's seeded
  right-hand sides lie within the cell's ``u_rel_err`` of the plain
  reference's float64 solution, the program's plain-f32 ``solve`` does
  not, and the plain reference agrees with the 5-point reference
  ``poisson_mg`` on the same data;
* the readers' byte counts (``portbench/ell_bytes.py``) are the hand
  counts of a small hierarchy, a launch in its least time reads 100 %, and
  a launch under no cycle stage is not counted.
"""

from __future__ import annotations

import copy
import types

import pytest
import torch

from portbench import ell_bytes, harness, registry, roofline, traffic

torch.set_num_threads(1)

CELL = "amg-p1-2049-ff32"
CONFIG = "fem-p1-2049-amg"
SMALL = dict(shape=[65, 65], num_levels=3)
PER_LAYER = ("amg.spmv_roofline", "amg.ff_residual_roofline",
             "amg.plain_device_ms_per_solve", "amg.idle_ms_per_solve",
             "amg.host_syncs_per_solve", "amg.setup_hierarchy_s")
# read after them: the set-up split of every cell, then the AMG phases
SETUP = ("setup.kernel_library_s", "setup.solver_s", "setup.first_solve_s",
         "setup.outside_program_s", "setup.kernel_builds",
         "amg.setup_p1_s", "amg.setup_coarsening_s",
         "amg.setup_interpolation_s", "amg.setup_rap_s")


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
        "amg", "sin5r", "p1_square")
    assert config["solver"] == {
        "shape": [2049, 2049], "length": 1.0, "alpha": 1.0,
        "num_levels": 5, "theta": 0.2, "coarsening": "pmis",
        "interp": "smoothed", "smoother": "chebyshev", "cheb_degree": 3,
        "tol": 1e-10, "maxit": 100}
    assert config["reduced"] == []
    assert 0 < cell["limits"]["u_rel_err"] < 1e-5


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
def test_each_new_metric_reads_the_cell_alone(name):
    entry = {m["name"]: m for m in registry.benchmark()["per_layer"]}[name]
    assert entry["workloads"] == [CELL]
    reader = registry.load_module("metrics", name)
    assert reader.UNIT == entry["unit"]
    assert entry["moves"] == ("setup_s" if name == "amg.setup_hierarchy_s"
                              else "solve_ms")
    assert entry["better"] == ("higher" if reader.UNIT == "%" else "lower")


@pytest.mark.parametrize("seed", [23, 2 ** 31 + 23])
def test_cut_cell_answers_lie_within_the_limit(seed):
    cell = _small_cell()
    family = registry.load_module("solvers", "amg")
    solver = family.build(cell["config"], "cpu")
    pool = _pool(cell, seed)[:3]
    answers, residuals, failed = [], [], 0
    for j, b in enumerate(pool):
        ans = family.solve(solver, cell["entry"], b)
        assert ans.u.shape == b.shape and ans.u.dtype == torch.float64
        answers.append((j, ans.u))
        residuals.append(ans.residual)
        failed += not ans.converged
    checks = harness.compare(cell, pool, answers, residuals, failed)
    assert harness.passed(checks), checks


def test_the_plain_f32_solve_fails_the_limit():
    cell = _small_cell()
    kw = cell["config"]["solver"]
    family = registry.load_module("solvers", "amg")
    reference = registry.load_module("reference", "p1_square")
    solver = family.build(cell["config"], "cpu")
    b = _pool(cell, 23)[0]
    exact = reference.solve(b, kw["alpha"], kw["length"])
    nodal = b.flip(0).reshape(-1)
    plain = solver.solver.solve(solver.system.load(nodal, nodal),
                                tol=kw["tol"], maxit=kw["maxit"])
    f32 = solver.system.field(plain.x, nodal).view(b.shape).flip(0)
    for name, u, within in (
            ("solve_refined", family.solve(solver, "solve_refined", b).u,
             True),
            ("solve", f32, False)):
        err = float(torch.linalg.vector_norm(u - exact)
                    / torch.linalg.vector_norm(exact))
        assert (err <= cell["limits"]["u_rel_err"]) == within, (name, err)


def test_the_p1_reference_is_the_5_point_reference_on_this_mesh():
    cell = _small_cell()
    b = _pool(cell, 29)[0]
    p1 = registry.load_module("reference", "p1_square").solve(b, 1.0, 1.0)
    fd = registry.load_module("reference", "poisson_mg").solve(b, 1.0, 1.0)
    assert torch.equal(p1[0], b[0].double())
    # both float64 to a residual / change below 1e-13
    assert float(torch.linalg.vector_norm(p1 - fd)
                 / torch.linalg.vector_norm(fd)) < 1e-12


def test_the_level_records_of_a_built_cell():
    cell = _small_cell()
    family = registry.load_module("solvers", "amg")
    built = family.build(cell["config"], "cpu")
    assert family.build(cell["config"], "cpu") is built  # kept
    levels = family.level_shapes(cell["config"])
    solver = built.solver
    assert len(levels) == len(solver.host_matrices) == 3
    for k, ops in enumerate(levels):
        A = solver.host_matrices[k]
        assert ops["A"] == (A.shape[0], A.shape[1], A.nnz)
        if k < 2:
            P = solver.host_P[k]
            assert ops["P"] == (P.shape[0], P.shape[1], P.nnz)
            assert ops["Pt"] == (P.shape[1], P.shape[0], P.nnz)
        else:
            assert set(ops) == {"A"}
    assert levels[0]["A"][0] == 63 * 63
    assert family.setup_times(cell["config"]) == solver.setup_times
    assert family.schedule(cell["config"], "solve_refined", 8) is None


LEVELS = [{"A": (100, 100, 460), "P": (100, 40, 150), "Pt": (40, 100, 150)},
          {"A": (40, 40, 300)}]


def test_byte_counts_are_the_hand_counts():
    cost = ell_bytes.cycle_kernel_bytes
    # 460 entries: 460 f32 values + 460 int32 ids; x 100 f32; y 100 f32
    assert ell_bytes.spmv_bytes(100, 100, 460) == 460 * 8 + 400 + 400
    assert cost("ell_spmv_kernel", 100, 100, 460) == 460 * 8 + 400 + 400
    # restriction P^T: 150 entries, x of 100 fine values, y of 40 coarse
    assert cost("ell_spmv_kernel", 40, 100, 150) == 150 * 8 + 400 + 160
    # z - A x: the SpMV's matrix and x, z read and y written
    assert cost("ell_spmv_axpy_kernel", 100, 40, 150) == \
        150 * 8 + 160 + 400 + 400
    # Chebyshev: b, d read, p, x_out written (+ p read after the first
    # step); from x = 0 neither the matrix nor x
    assert cost("ell_cheb_first_kernel", 100, 100, 460) == \
        460 * 8 + 400 + 4 * 400
    assert cost("ell_cheb_step_kernel", 100, 100, 460) == \
        460 * 8 + 400 + 5 * 400
    assert cost("ell_cheb_zero_kernel", 100, 100, 460) == 4 * 400
    assert cost("vectorized_elementwise_kernel", 100, 100, 460) is None
    # float-float residual: ids, hi and lo values; x pair, b pair, r
    assert ell_bytes.ff_residual_bytes(100, 460) == \
        460 * 12 + 100 * 8 + 100 * 8 + 100 * 4


def _split(kernels):
    return types.SimpleNamespace(kernels=kernels)


def _s(nbytes):
    return nbytes / roofline.HBM_BYTES_PER_S


def test_each_launch_is_priced_on_the_operator_of_its_stage():
    root, cycle = "mg.solve_refined", "mg.solve_refined/mg.outer.cycle"
    cost = ell_bytes.cycle_kernel_bytes
    A, P, Pt = LEVELS[0]["A"], LEVELS[0]["P"], LEVELS[0]["Pt"]
    least = {"zero": _s(cost("ell_cheb_zero_kernel", *A)),
             "step": _s(cost("ell_cheb_step_kernel", *A)),
             "res": _s(cost("ell_spmv_axpy_kernel", *A)),
             "restrict": _s(cost("ell_spmv_kernel", *Pt)),
             "prolong": _s(cost("ell_spmv_axpy_kernel", *P))}
    kernels = {
        (f"{cycle}/mg.L0.pre_smooth", "ell_cheb_zero_kernel"):
            [least["zero"], 1],
        (f"{cycle}/mg.L0.pre_smooth", "ell_cheb_step_kernel"):
            [2 * least["step"], 2],
        (f"{cycle}/mg.L0.residual", "ell_spmv_axpy_kernel"):
            [least["res"], 1],
        (f"{cycle}/mg.L0.restrict", "ell_spmv_kernel"):
            [least["restrict"], 1],
        (f"{cycle}/mg.L0.prolong_add", "ell_spmv_axpy_kernel"):
            [least["prolong"], 1],
        # not a cycle kernel, or not under a stage: left out
        (f"{cycle}/mg.L0.residual", "vectorized_elementwise_kernel"):
            [1.0, 1],
        (f"{root}/mg.outer.split", "ell_spmv_kernel"): [1.0, 1],
        (f"{root}/mg.outer.ff_residual", "ell_ff_residual_kernel"):
            [2 * _s(ell_bytes.ff_residual_bytes(100, 460)), 2]}
    assert ell_bytes.spmv_share(_split(kernels), LEVELS) == \
        pytest.approx(100.0)
    assert ell_bytes.ff_residual_share(_split(kernels), LEVELS) == \
        pytest.approx(100.0)
    # a coarse launch at a third of its bound's speed
    coarse = _s(cost("ell_cheb_step_kernel", *LEVELS[1]["A"]))
    kernels[(f"{cycle}/mg.L1.post_smooth", "ell_cheb_step_kernel")] = [
        3 * coarse, 1]
    fine = sum(least.values()) + least["step"]
    assert ell_bytes.spmv_share(_split(kernels), LEVELS) == pytest.approx(
        100.0 * (fine + coarse) / (fine + 3 * coarse))
    assert ell_bytes.spmv_share(_split({}), LEVELS) is None
