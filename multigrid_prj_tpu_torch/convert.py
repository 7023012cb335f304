"""Build port solvers from a JAX solver's state given as numpy data.

The JAX package is never imported here: the caller hands over plain values,
e.g. for a JAX ``GMGSolver`` ``js``::

    state = dict(levels=[dataclasses.astuple(l) for l in js.levels],
                 coarse_inv=None if js._coarse_inv is None
                 else np.asarray(js._coarse_inv),
                 length=js.length, alpha=js.alpha, tol=js.tol,
                 maxit=js.maxit, nu=js.nu, pre_sweeps=js.pre_sweeps,
                 cycle=js.cycle, coarse_tol=js.coarse_tol,
                 coarse_maxit=js.coarse_maxit)

so that both sides run with the identical hierarchy and coarse inverse;
and for a JAX ``AMGSolver`` ``ja``::

    csr = lambda M: (M.indptr, M.indices, M.data, M.shape)
    state = dict(host_matrices=[csr(M) for M in ja.host_matrices],
                 host_P=[csr(P) for P in ja.host_P], perm=ja._perm,
                 lmax=[lvl.lmax for lvl in ja.levels],
                 bottom_inv=np.asarray(ja._coarse_dense))

so that both solvers compute from the same hierarchy without re-running
the setup; and for a JAX ``ShardedGMGSolver`` ``jsh``::

    state = dict(levels=[dataclasses.astuple(l) for l in jsh.levels],
                 alpha=jsh.alpha, nu1=jsh.nu1, nu2=jsh.nu2,
                 coarse_sweeps=jsh.coarse_sweeps, tol=jsh.tol,
                 maxit=jsh.maxit, use_pallas=jsh.use_pallas,
                 use_grouped=jsh.use_grouped)

so that both sides run the same hierarchy and sweep schedule; and for a JAX
``ShardedAMGSolver`` ``jam``::

    csr = lambda M: (M.indptr, M.indices, M.data, M.shape)
    state = dict(host_matrices=[csr(M) for M in jam.host_matrices],
                 host_P=[csr(P) for P in jam.host_P], perm=jam._perm,
                 lmax=[lv.lmax for lv in jam.sharded_levels]
                 + [t[2] for t in jam._tail],
                 smoother=jam.smoother_name, cheb_degree=jam.cheb_degree,
                 nu1=jam.nu1, nu2=jam.nu2, tol=jam.tol, maxit=jam.maxit,
                 num_sharded=jam.num_sharded)

so that both sides shard the same hierarchy (the port's own solvers give
the same keys from their attributes).
"""

from __future__ import annotations

import numpy as np
import torch

from multigrid_prj_tpu_torch.amg import AMGSolver
from multigrid_prj_tpu_torch.gmg import GMGSolver
from multigrid_prj_tpu_torch.grids import GridLevel
from multigrid_prj_tpu_torch.ops.sparse import HostCSR
from multigrid_prj_tpu_torch.parallel.sharded_amg import ShardedAMGSolver
from multigrid_prj_tpu_torch.parallel.sharded_gmg import ShardedGMGSolver

_CONFIG_KEYS = ("length", "alpha", "tol", "maxit", "nu", "pre_sweeps",
                "cycle", "coarse_tol", "coarse_maxit")


def solver_state_from_numpy(state: dict, device="cuda", smoother: str = "gs",
                            use_pallas: bool | None = None,
                            omega: float = 1.0,
                            smoother_dtype: torch.dtype | None = None,
                            fuse_downleg: bool = False) -> GMGSolver:
    """A port ``GMGSolver`` (on ``device``, the card unless the caller names
    another) whose levels, coarse inverse and scalar config are those in
    ``state`` (keys: ``levels`` as ``(shape, h, level, padded_shape)``
    tuples, 2D or 3D, ``coarse_inv`` as a numpy array or None -- None when
    the coarsest level is above the dense inverse's cap -- and the scalar
    config keys of the JAX solver).  ``smoother``, ``omega`` and
    ``fuse_downleg`` are given separately, since the JAX solver keeps them
    only inside its smoother and its down-leg hook, and so is
    ``smoother_dtype``, a torch dtype where the JAX solver holds a jax one.
    Raises ``ValueError`` if the levels are not the hierarchy the port
    builds for the same shape."""
    levels = [GridLevel(tuple(int(s) for s in shape), float(h), int(level),
                        None if padded is None else tuple(int(p) for p in padded))
              for shape, h, level, padded in state["levels"]]
    lev0 = levels[0]
    solver = GMGSolver(shape=lev0.shape, num_levels=len(levels),
                       smoother=smoother, omega=omega,
                       smoother_dtype=smoother_dtype,
                       pad_align=lev0.padded_shape,
                       use_pallas=use_pallas, coarse="none",
                       fuse_downleg=fuse_downleg, device=device,
                       **{k: state[k] for k in _CONFIG_KEYS})
    if solver.levels != levels:
        raise ValueError(f"levels {levels} differ from the port's hierarchy "
                         f"{solver.levels}")
    inv = state.get("coarse_inv")
    if inv is not None:
        solver._coarse_inv = torch.from_numpy(
            np.array(inv, dtype=np.float64)).to(solver.device)
    return solver


def _csr(t) -> HostCSR:
    indptr, indices, data, shape = t
    return HostCSR(indptr=np.asarray(indptr, np.int64),
                   indices=np.asarray(indices, np.int64),
                   data=np.asarray(data, np.float64),
                   shape=(int(shape[0]), int(shape[1])))


def amg_solver_from_numpy(state: dict, device="cuda",
                          **solver_kw) -> AMGSolver:
    """A port ``AMGSolver`` on ``device`` (the card unless the caller names
    another) on the hierarchy in ``state`` (keys:
    ``host_matrices`` and ``host_P`` as ``(indptr, indices, data, shape)``
    tuples in the solver's internal frame, ``perm`` (the RCM permutation or
    None), ``lmax`` (per level, 0 where not estimated) and ``bottom_inv``,
    the bottom level's inverse).  ``solver_kw`` are the solve options of
    ``AMGSolver.from_hierarchy`` (``smoother``, ``dtype``, ``use_pallas``,
    ``rhs``, ...), which the JAX solver does not keep in plain form."""
    inv = state.get("bottom_inv")
    return AMGSolver.from_hierarchy(
        [_csr(t) for t in state["host_matrices"]],
        [_csr(t) for t in state["host_P"]],
        perm=state.get("perm"), lmax=state.get("lmax"),
        bottom_inv=None if inv is None else np.asarray(inv, np.float64),
        device=device, **solver_kw)


def sharded_solver_from_numpy(state: dict, mesh,
                              device="cuda") -> ShardedGMGSolver:
    """A port ``ShardedGMGSolver`` on ``mesh`` (``device``: the card unless
    the caller names another) with the levels, sweep counts, tolerances and
    schedule flags in ``state`` (keys: ``levels`` as ``(shape, h, level,
    padded_shape)`` tuples; ``alpha``, ``nu1``, ``nu2``, ``coarse_sweeps``,
    ``tol``, ``maxit``, ``use_pallas``, ``use_grouped`` as the JAX solver
    resolved them; optionally ``num_sharded``, which is checked).  The
    levels are taken as given, so both sides use the same spacings.
    Raises ``ValueError`` if their shapes are not the port's hierarchy for
    the same grid, or if the number of sharded levels differs."""
    levels = [GridLevel(tuple(int(s) for s in shape), float(h), int(level),
                        None if padded is None
                        else tuple(int(p) for p in padded))
              for shape, h, level, padded in state["levels"]]
    lev0 = levels[0]
    solver = ShardedGMGSolver(
        shape=lev0.shape, mesh=mesh, length=lev0.h * (lev0.shape[0] - 1),
        alpha=state["alpha"], num_levels=len(levels), nu1=int(state["nu1"]),
        nu2=int(state["nu2"]), coarse_sweeps=int(state["coarse_sweeps"]),
        tol=state["tol"], maxit=state["maxit"],
        use_pallas=bool(state["use_pallas"]),
        use_grouped=bool(state["use_grouped"]), device=device)
    if [lev.shape for lev in solver.levels] != [lev.shape for lev in levels]:
        raise ValueError(f"levels {levels} differ from the port's hierarchy "
                         f"{solver.levels}")
    if state.get("num_sharded", solver.num_sharded) != solver.num_sharded:
        raise ValueError(f"{state['num_sharded']} sharded levels in the "
                         f"state, {solver.num_sharded} here")
    solver.levels = levels
    return solver


_SHARDED_AMG_KEYS = ("smoother", "cheb_degree", "nu1", "nu2", "tol", "maxit")


def sharded_amg_solver_from_numpy(state: dict, mesh, device="cuda",
                                  **solver_kw) -> ShardedAMGSolver:
    """A port ``ShardedAMGSolver`` on ``mesh`` (``device``: the card unless
    the caller names another) on the host hierarchy in ``state`` (keys:
    ``host_matrices`` and ``host_P`` as ``(indptr, indices, data, shape)``
    tuples in the internal (RCM) frame, ``perm``, ``lmax`` per level (0
    where not estimated); optionally the solver's ``smoother``,
    ``cheb_degree``, ``nu1``, ``nu2``, ``tol`` and ``maxit``, and
    ``num_sharded``, which is checked).  ``solver_kw`` are the options the
    JAX solver does not keep in plain form (``dtype``, ``use_pallas``,
    ``min_rows_per_shard``).  Raises ``ValueError`` if the port shards
    another number of levels."""
    opts = {k: state[k] for k in _SHARDED_AMG_KEYS if k in state}
    solver = ShardedAMGSolver.from_hierarchy(
        [_csr(t) for t in state["host_matrices"]],
        [_csr(t) for t in state["host_P"]], mesh, perm=state.get("perm"),
        lmax=state.get("lmax"), device=device, **opts, **solver_kw)
    if state.get("num_sharded", solver.num_sharded) != solver.num_sharded:
        raise ValueError(f"{state['num_sharded']} sharded levels in the "
                         f"state, {solver.num_sharded} here")
    return solver
