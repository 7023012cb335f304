"""Solver family ``gmg_pcg``: ``GMGSolver.solve_refined(b, inner_cg=k)``,
float-float refinement whose every correction is ``k`` steps of conjugate
gradients preconditioned by one V-cycle (``ops/krylov.cg_arrays``).

A configuration of this family is one of the ``gmg`` family with the
number of CG steps a correction under ``"inner_cg"``.  The solver, its
levels and its launch counters are the ``gmg`` family's; besides them
this file holds the schedule of algorithmic stages that
``portbench/krylov_cost.py`` prices.
"""

from __future__ import annotations

import dataclasses

from portbench import registry

_gmg = registry.load_module("solvers", "gmg")
Answer = _gmg.Answer
level_shapes = _gmg.level_shapes
launch_counts = _gmg.launch_counts


@dataclasses.dataclass
class PCGSolver:
    solver: object  # the GMGSolver
    inner_cg: int  # CG steps a correction


def build(config: dict, device) -> PCGSolver:
    return PCGSolver(_gmg.build(config, device), int(config["inner_cg"]))


def solve(pcg: PCGSolver, entry: str, b) -> Answer:
    """``solve_refined`` with the configuration's ``inner_cg``; any other
    entry (a control's ``solve``) as the ``gmg`` family calls it."""
    if entry != "solve_refined":
        return _gmg.solve(pcg.solver, entry, b)
    res = pcg.solver.solve_refined(b, inner_cg=pcg.inner_cg)
    return Answer(u=res.u, iterations=int(res.iterations),
                  residual=float(res.history[-1]),
                  converged=bool(res.converged))


def schedule(config: dict, entry: str, iterations: int):
    """The stages of one ``solve_refined`` that took ``iterations`` outer
    iterations, as ``(stage, logical shape, sweeps, count)``; ``None`` for
    entries and cycles it does not describe.

    The outer loop as the program runs it: the b / c pair and ||b||, one
    float-float residual, then per iteration the pair update fused with the
    next residual, and a norm for each history entry.  Each correction of
    ``m`` CG steps from ``x0 = 0``, counting only the passes whose results
    the correction uses: ``m`` V-cycles (the first, then one in each step
    but the last), ``m`` applies (``A p``), ``2 m`` dots (``r0 . z0``, then
    ``p . A p`` in each step and ``r . z`` in each but the last), and
    ``3 m - 2`` updates (x in each step, r and p in each but the last).
    Left out, since the correction does not use them: the apply of
    ``x0 = 0`` and ``r0 = b - 0``, the last step's cycle, ``r . z``, r and
    p, CG's norms (of its right-hand side, of its first and last residual,
    and those of its ``tol = 0`` stop tests), and the correction's two
    masking passes."""
    kw = config["solver"]
    if entry != "solve_refined" or kw.get("cycle") != "v":
        return None
    shapes = level_shapes(config)
    fine, k, m = shapes[0], int(iterations), int(config["inner_cg"])
    cycles = k * m
    out = [("split", fine, 0, 1), ("norm", fine, 0, 1),
           ("ff_residual", fine, 0, 1), ("ff_update_residual", fine, 0, k),
           ("norm", fine, 0, k + 1), ("combine", fine, 0, 1),
           ("apply", fine, 0, k * m), ("dot", fine, 0, k * 2 * m),
           ("update", fine, 0, k * (3 * m - 2))]
    for shape in shapes[:-1]:
        out += [("smoother", shape, int(kw["pre_sweeps"]), cycles),
                ("residual", shape, 0, cycles),
                ("restriction", shape, 0, cycles),
                ("prolong_add", shape, 0, cycles),
                ("smoother", shape, int(kw["nu"]), cycles)]
    bottom = config["bottom"]
    out.append((bottom["stage"], shapes[-1], int(bottom.get("sweeps", 0)),
                cycles))
    return out
