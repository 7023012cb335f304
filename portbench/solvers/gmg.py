"""Solver family ``gmg``: ``multigrid_prj_tpu_torch.gmg.GMGSolver``.

A configuration of this family gives the solver's keyword arguments under
``"solver"`` and its bottom solve under ``"bottom"`` (``{"stage":
"dense_inverse"}`` or ``{"stage": "smoother", "sweeps": n}``); a cell names
the entry (``"solve_refined"``).  Besides building and calling the solver,
this file holds the family's schedule of algorithmic stages, which the
roofline counts.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Answer:
    u: object  # the solution on the logical grid
    iterations: int
    residual: float  # the last history entry
    converged: bool


def build(config: dict, device):
    from multigrid_prj_tpu_torch.gmg import GMGSolver

    kw = dict(config["solver"])
    kw["shape"] = tuple(kw["shape"])
    if isinstance(kw.get("pad_align"), list):
        kw["pad_align"] = tuple(kw["pad_align"])
    return GMGSolver(**kw, device=device)


def solve(solver, entry: str, b) -> Answer:
    res = getattr(solver, entry)(b)
    return Answer(u=res.u, iterations=int(res.iterations),
                  residual=float(res.history[-1]),
                  converged=bool(res.converged))


def launch_counts() -> dict:
    """The port's kernel-wrapper launch counters (``LAUNCHES``)."""
    from multigrid_prj_tpu_torch.ops.cuda_stencil import LAUNCHES

    return dict(LAUNCHES)


def level_shapes(config: dict) -> list[tuple]:
    """Logical grid of each level: ``(n + 1) // 2`` per axis per level."""
    shapes = [tuple(int(n) for n in config["solver"]["shape"])]
    for _ in range(1, int(config["solver"]["num_levels"])):
        shapes.append(tuple((n + 1) // 2 for n in shapes[-1]))
    return shapes


def schedule(config: dict, entry: str, iterations: int):
    """The stages of one ``solve_refined`` with a V-cycle that took
    ``iterations`` outer iterations, as ``(stage, logical shape, sweeps,
    count)``; ``None`` for entries and cycles it does not describe."""
    kw = config["solver"]
    if entry != "solve_refined" or kw.get("cycle") != "v":
        return None
    shapes = level_shapes(config)
    fine, k = shapes[0], int(iterations)
    out = [("split", fine, 0, 1), ("norm", fine, 0, 1),  # b / c pair, ||b||
           ("ff_residual", fine, 0, k + 1), ("norm", fine, 0, k + 1),
           ("pair_update", fine, 0, k), ("combine", fine, 0, 1)]
    for shape in shapes[:-1]:
        out += [("smoother", shape, int(kw["pre_sweeps"]), k),
                ("residual", shape, 0, k), ("restriction", shape, 0, k),
                ("prolong_add", shape, 0, k),
                ("smoother", shape, int(kw["nu"]), k)]
    bottom = config["bottom"]
    out.append((bottom["stage"], shapes[-1], int(bottom.get("sweeps", 0)), k))
    return out

