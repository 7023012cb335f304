"""The ``amg-p1-2049-ff32`` cell cut to 65^2 nodes and 3 levels, run
whole on the CPU: ``correct`` true, and its plain reference
(``reference/p1_square.py``) equal to the 5-point reference
(``reference/poisson_mg.py``, alpha 1, length 1) on the cell's data."""

from __future__ import annotations

import copy
import time

import torch

from portbench import harness, registry, traffic

torch.set_num_threads(2)

CELL = "amg-p1-2049-ff32"


def _small():
    cell = copy.deepcopy(registry.cell(CELL))
    cell["config"]["solver"].update(shape=[65, 65], num_levels=3)
    return cell


def test_the_cut_cell_runs_correct_on_the_cpu():
    cell = _small()
    run, checks = harness.run_cell(cell, 2 ** 31 + 101, 0.5, False, "cpu",
                                   time.perf_counter())
    assert harness.passed(checks), checks
    assert run.failed == 0 and run.attempted >= 2
    assert all(k < 20 for k in run.iterations)


def test_the_reference_is_the_5_point_reference():
    cell = _small()
    kw = cell["config"]["solver"]
    problem = registry.load_module("problems", "sin5r")
    b = traffic.make_pool(problem, kw["shape"], kw["length"],
                          cell["traffic"], 5, "cpu")[0]
    p1 = registry.load_module("reference", "p1_square").solve(b, 1.0, 1.0)
    fd = registry.load_module("reference", "poisson_mg").solve(b, 1.0, 1.0)
    err = torch.linalg.vector_norm(p1 - fd) / torch.linalg.vector_norm(fd)
    assert float(err) < 1e-12
