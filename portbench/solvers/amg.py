"""Solver family ``amg``: ``multigrid_prj_tpu_torch.amg.AMGSolver`` on the
P1 system of ``models/fem``.

A configuration of this family gives under ``"solver"`` the node grid
``shape`` ``[n, n]`` of the structured triangulation of the unit square
(``fem.structured_unit_square_mesh``; ``length`` 1, ``alpha`` 1), the
solver's keyword arguments (``num_levels``, ``theta``, ``coarsening``,
``interp``, ``smoother``, ``cheb_degree``) and the solve's ``tol`` and
``maxit``; a cell names the entry ``solve_refined`` (float-float outer
residuals, the one entry of the family).  A right-hand side is the
harness's nodal grid, ``f`` at interior nodes and ``g`` at boundary nodes,
node (i, j) at ``x = j h``, ``y = L - i h``: mesh node ``(n - 1 - i) n +
j``.  ``AMGSolver.solve_p1`` turns it into the load, solves, and puts the
nodal field together, all on the device.

:func:`build` keeps what it built for a configuration and device for the
life of the process: the traced slices of ``spans.py`` and
``kernel_split.py`` build the cell's solver again, and the host set-up of
a hierarchy at 2049^2 takes minutes.  Each build's phases (mesh, P1
assembly, the solver's ``setup_times``) are printed on standard error.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

_BUILT: dict = {}  # (configuration, device) -> Built


@dataclasses.dataclass
class Answer:
    u: object  # the nodal solution on the harness's grid, float64
    iterations: int
    residual: float  # the last history entry
    converged: bool


@dataclasses.dataclass
class Built:
    system: object  # fem.P1System
    solver: object  # amg.AMGSolver
    n: int
    tol: float
    maxit: int
    levels: list  # per level {"A" | "P" | "Pt": (rows, cols, nnz)}


def _key(config: dict) -> str:
    return json.dumps(config, sort_keys=True)


def build(config: dict, device) -> Built:
    import torch

    from multigrid_prj_tpu_torch.amg import AMGSolver
    from multigrid_prj_tpu_torch.models.fem import (
        P1System,
        structured_unit_square_mesh,
    )

    device = torch.device(device)
    key = (_key(config), str(device))
    if key in _BUILT:
        return _BUILT[key]
    kw = dict(config["solver"])
    n = int(kw["shape"][0])
    if list(kw["shape"]) != [n, n] or kw["length"] != 1.0 or \
            kw["alpha"] != 1.0:
        raise ValueError(f"the family takes the unit square at alpha 1 on "
                         f"n x n nodes, not {kw}")
    t0 = time.perf_counter()
    mesh = structured_unit_square_mesh(n)
    t1 = time.perf_counter()
    system = P1System(mesh)
    t2 = time.perf_counter()
    solver = AMGSolver(
        system.A, num_levels=int(kw["num_levels"]), theta=float(kw["theta"]),
        coarsening=kw["coarsening"], interp=kw["interp"],
        smoother=kw["smoother"], cheb_degree=int(kw["cheb_degree"]),
        dtype=torch.float32, device=device)
    system.to(device)
    levels = []
    for i, A in enumerate(solver.host_matrices):
        ops = {"A": A.shape + (A.nnz,)}
        if i < len(solver.host_P):
            P = solver.host_P[i]
            ops["P"] = P.shape + (P.nnz,)
            ops["Pt"] = (P.shape[1], P.shape[0], P.nnz)
        levels.append(ops)
    built = _BUILT[key] = Built(system=system, solver=solver, n=n,
                                tol=float(kw["tol"]), maxit=int(kw["maxit"]),
                                levels=levels)
    print("amg set-up, s: " + json.dumps(
        {"mesh": t1 - t0, "p1_system": t2 - t1, **solver.setup_times,
         "levels": solver.level_sizes}), file=sys.stderr, flush=True)
    return built


def solve(built: Built, entry: str, b) -> Answer:
    if entry != "solve_refined":
        raise ValueError(f"no entry {entry!r} in the amg family")
    n = built.n
    nodal = b.flip(0).reshape(-1)  # f inside, g on the boundary
    res = built.solver.solve_p1(built.system, nodal, nodal, tol=built.tol,
                                maxit=built.maxit)
    residual = float(res.history[-1])
    return Answer(u=res.x.view(n, n).flip(0), iterations=int(res.iterations),
                  residual=residual, converged=residual <= built.tol)


def launch_counts() -> dict:
    """The port's kernel-wrapper launch counters (``LAUNCHES``)."""
    from multigrid_prj_tpu_torch.ops.cuda_stencil import LAUNCHES

    return dict(LAUNCHES)


def _built_for(config: dict) -> Built | None:
    for (key, _), built in _BUILT.items():
        if key == _key(config):
            return built
    return None


def level_shapes(config: dict) -> list | None:
    """Each level's ``{"A": (rows, cols, nnz), "P": ..., "Pt": ...}`` (no
    ``P``, ``Pt`` at the bottom) of the solver built for ``config``;
    ``None`` where none is built."""
    built = _built_for(config)
    return None if built is None else built.levels


def setup_times(config: dict) -> dict | None:
    """The ``setup_times`` of the solver built for ``config``, or ``None``."""
    built = _built_for(config)
    return None if built is None else built.solver.setup_times


def schedule(config: dict, entry: str, iterations: int):
    """No stage schedule: the roofline model of ``roofline.py`` is of
    structured grids."""
    return None
