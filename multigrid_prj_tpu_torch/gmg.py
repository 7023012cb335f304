"""Geometric multigrid cycles and the outer solver driver (PyTorch port of
``multigrid_prj_tpu/gmg.py``).

* ``sawtooth_cycle``: the reference's cycle (one fine residual, a stationary
  coarse solve of the error equation, then per level up: prolong and ``nu``
  smoother sweeps), with full-weighting restriction.
* ``v_cycle`` / ``w_cycle`` / ``fmg``: the correction-scheme cycles with the
  ``residual`` / ``downleg`` / ``padded_restrict`` / ``prolong_add`` /
  ``coarse_apply`` hooks of the JAX package.
* ``GMGSolver``: ``solve`` (with ``smoother_dtype``: defect correction
  whose cycle runs in that dtype) and ``solve_refined`` (float-float outer
  residuals), in 2D and 3D.

The JAX package runs each solve as one ``lax.while_loop``; here the loops are
Python loops that fetch one scalar per outer iteration (the residual norm
that goes into ``history``).  History semantics are the same: entry 0 is the
initial residual, and the loop stops at ``tol`` or ``maxit``.  Every such
fetch, and with ``inner_cg`` each stop test of the inner CG
(``ops/krylov.cg_arrays``), goes through ``utils/metrics.fetch`` (counted in
``COUNTERS["host_syncs"]``), and a solve's stages run inside the profiler
spans of ``utils/metrics`` (``SPAN_*``, ``level_spans``), which cost one check
each when no profiler records.

Devices are explicit: ``GMGSolver(device=...)`` makes every tensor there,
on the card unless the caller names another device.  Which function runs
each stencil operation is the solver's route (``ops/routes.py``), chosen
once per dtype: with ``use_pallas`` (the default on CUDA) float32 work takes
the hand-written kernels (the smoothers, residuals, float-float residual
and pair update, ``inner_cg`` operator apply and CG vector updates, in 2D
the padded grid transfers and the fused down-leg of ``fuse_downleg``, in
3D the exact-layout grid transfers); as in the JAX kernel
wrappers, which take float32 only, work in any other dtype (f64, or the
bf16 ``smoother_dtype`` cycle) takes the plain ops on every device and
launches nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from multigrid_prj_tpu_torch.grids import GridLevel, build_hierarchy
from multigrid_prj_tpu_torch.ops.extended import ff_from_div
from multigrid_prj_tpu_torch.ops.krylov import cg_arrays
from multigrid_prj_tpu_torch.ops.residual import norm2, rel_residual_norm
from multigrid_prj_tpu_torch.ops.routes import Route, kernel_route, plain_route
from multigrid_prj_tpu_torch.ops.stencil import boundary_mask, poisson_residual
from multigrid_prj_tpu_torch.ops.transfer import (
    crop_to,
    pad_to,
    prolong,
    prolong_padded,
    restrict_full_weighting,
    restrict_fw_padded,
)
from multigrid_prj_tpu_torch.ops.transfer import (
    prolong_add as plain_prolong_add,
)
from multigrid_prj_tpu_torch.utils.guards import check_finite
from multigrid_prj_tpu_torch.utils.metrics import (
    SPAN_BOTTOM,
    SPAN_CG_MASK,
    SPAN_COMBINE,
    SPAN_CYCLE,
    SPAN_FETCH,
    SPAN_FF_RESIDUAL,
    SPAN_SOLVE,
    SPAN_SOLVE_REFINED,
    SPAN_SPLIT,
    fetch,
    level_spans,
    span,
)

Smoother = Callable[..., torch.Tensor]  # (u, b, alpha, h, sweeps, logical_shape)


def stationary_solve(e0, b, alpha, h, smoother: Smoother, tol: float,
                     maxit: int, sweeps_per_check: int = 1,
                     logical_shape=None):
    """Iterate ``smoother`` on ``A e = b`` until ``||b - A e|| <= tol ||b||``.

    Returns ``(e, iterations, rel_norm)``; one scalar fetch per check.
    """
    b2 = norm2(b)
    tol2 = (tol * tol) * b2
    e, k, rn2 = e0, 0, b2
    while k < maxit:
        with span(SPAN_FETCH):
            above = fetch(rn2 > tol2)
        if not above:
            break
        e = smoother(e, b, alpha, h, sweeps_per_check,
                     logical_shape=logical_shape)
        rn2 = norm2(poisson_residual(e, b, alpha, h, logical_shape))
        k += 1
    rel = torch.sqrt(torch.where(b2 > 0, rn2 / b2, torch.zeros_like(b2)))
    return e, k, rel


def _logical(lev: GridLevel):
    """logical_shape argument for masked ops: None in the exact layout."""
    return lev.shape if lev.padded_shape is not None else None


def restrict_level(r, lev: GridLevel, nxt: GridLevel,
                   exact_restrict=restrict_full_weighting,
                   padded_restrict=restrict_fw_padded):
    """Restriction honouring each level's layout (padded halving or exact)."""
    if lev.padded_shape is not None:
        rc = padded_restrict(r, lev.shape)
        if nxt.padded_shape is None:
            rc = crop_to(rc, nxt.shape)
        return rc
    return exact_restrict(r)


def prolong_level(e, nxt: GridLevel, lev: GridLevel):
    """Prolongation from level ``nxt`` (coarse) up to ``lev`` (fine)."""
    if lev.padded_shape is not None:
        if nxt.padded_shape is None:
            e = pad_to(e, tuple(p // 2 for p in lev.padded_shape))
        return prolong_padded(e)
    return prolong(e, lev.shape)


def sawtooth_cycle(u, b, levels: Sequence[GridLevel], alpha: float,
                   smoother: Smoother, nu: int = 5, coarse_tol: float = 1e-1,
                   coarse_maxit: int = 2000,
                   restrict=restrict_full_weighting):
    """One sawtooth multigrid cycle on the error equation (reference parity;
    full weighting by default, ``restrict_inject`` for the strict mode)."""
    with span(level_spans(0).residual):
        r = poisson_residual(u, b, alpha, levels[0].h, _logical(levels[0]))
    rs = [r]
    for j, lev in enumerate(levels[1:], start=1):
        with span(level_spans(j - 1).restrict):
            rc = restrict_level(rs[-1], levels[j - 1], lev,
                                exact_restrict=restrict)
        if tuple(rc.shape) != lev.physical:
            raise RuntimeError(f"restricted {tuple(rc.shape)} != {lev.physical}")
        rs.append(rc)
    with span(SPAN_BOTTOM):
        e = torch.zeros_like(rs[-1])
        e, _, _ = stationary_solve(e, rs[-1], alpha, levels[-1].h, smoother,
                                   coarse_tol, coarse_maxit,
                                   logical_shape=_logical(levels[-1]))
    for j in range(len(levels) - 2, -1, -1):
        names = level_spans(j)
        with span(names.prolong_add):
            e = prolong_level(e, levels[j + 1], levels[j])
        with span(names.post_smooth):
            e = smoother(e, rs[j], alpha, levels[j].h, nu,
                         logical_shape=_logical(levels[j]))
    return u + e


def v_cycle(u, b, levels: Sequence[GridLevel], alpha: float,
            smoother: Smoother, nu1: int = 2, nu2: int = 2,
            coarse_sweeps: int = 100, restrict=restrict_full_weighting,
            gamma: int = 1, coarse_apply=None, residual=poisson_residual,
            downleg=None, padded_restrict=restrict_fw_padded,
            prolong_add=None, exact_prolong_add=plain_prolong_add,
            _level: int = 0):
    """Correction-scheme V-cycle (``gamma = 2`` gives the W-cycle).

    ``coarse_apply``: exact bottom solve ``b -> A^{-1} b`` (the dense
    inverse of ``GMGSolver(coarse="direct")``).  ``residual``: the residual
    implementation (``GMGSolver`` passes the CUDA kernel's wrapper).
    ``downleg``: fused pre-smooth+residual+restrict ``(u, b, lev, nxt, nu1)
    -> (u, r_coarse)`` on padded levels.  ``prolong_add``: fused ``u +
    prolong(e)`` on padded levels.  ``restrict`` and ``exact_prolong_add``:
    the restriction and ``u + prolong(e)`` of exact-layout levels
    (``GMGSolver`` passes its route's).
    """
    lev = levels[_level]
    h = lev.h
    logical = _logical(lev)
    if _level == len(levels) - 1:
        with span(SPAN_BOTTOM):
            if coarse_apply is not None:
                return coarse_apply(b)
            return smoother(u, b, alpha, h, coarse_sweeps,
                            logical_shape=logical)
    names = level_spans(_level)
    if downleg is not None and lev.padded_shape is not None:
        with span(names.restrict):
            u, rc = downleg(u, b, lev, levels[_level + 1], nu1)
            ec = torch.zeros_like(rc)
    else:
        with span(names.pre_smooth):
            u = smoother(u, b, alpha, h, nu1, logical_shape=logical)
        with span(names.residual):
            r = residual(u, b, alpha, h, logical)
        with span(names.restrict):
            rc = restrict_level(r, lev, levels[_level + 1],
                                exact_restrict=restrict,
                                padded_restrict=padded_restrict)
            ec = torch.zeros_like(rc)
    for _ in range(gamma):
        ec = v_cycle(ec, rc, levels, alpha, smoother, nu1=nu1, nu2=nu2,
                     coarse_sweeps=coarse_sweeps, restrict=restrict,
                     gamma=gamma, coarse_apply=coarse_apply,
                     residual=residual, downleg=downleg,
                     padded_restrict=padded_restrict,
                     prolong_add=prolong_add,
                     exact_prolong_add=exact_prolong_add, _level=_level + 1)
    nxt = levels[_level + 1]
    with span(names.prolong_add):
        if lev.padded_shape is None:
            u = exact_prolong_add(ec, u)
        elif prolong_add is not None and nxt.padded_shape is not None:
            u = prolong_add(ec, u)
        else:
            u = u + prolong_level(ec, nxt, lev)
    with span(names.post_smooth):
        return smoother(u, b, alpha, h, nu2, logical_shape=logical)


def w_cycle(u, b, levels, alpha, smoother, **kw):
    kw.setdefault("gamma", 2)
    return v_cycle(u, b, levels, alpha, smoother, **kw)


def fmg(b, levels: Sequence[GridLevel], alpha: float, smoother: Smoother,
        n_vcycles: int = 1, restrict=restrict_full_weighting, **vkw):
    """Full multigrid: coarsest-first nested iteration, then V-cycles per
    level (each on ``levels`` from index ``j``, so its spans name the
    levels by their index in the whole hierarchy)."""
    bs = [b]
    for j, lev in enumerate(levels[1:], start=1):
        bs.append(restrict_level(bs[-1], levels[j - 1], lev,
                                 exact_restrict=restrict))
    u = torch.zeros_like(bs[-1])
    for j in range(len(levels) - 1, -1, -1):
        if j < len(levels) - 1:
            u = prolong_level(u, levels[j + 1], levels[j])
        for _ in range(n_vcycles):
            u = v_cycle(u, bs[j], levels, alpha, smoother,
                        restrict=restrict, _level=j, **vkw)
    return u


@dataclasses.dataclass
class SolveResult:
    """Outcome of an outer multigrid solve: ``history`` is the per-iteration
    relative residual norm (numpy, the solve's dtype) the reference writes
    to ``MGGS4.txt``; ``converged`` is ``history[-1] <= tol``."""

    u: torch.Tensor
    history: np.ndarray  # shape (iterations + 1,)
    iterations: int
    converged: bool

    @property
    def convergence_factor(self) -> float:
        """Geometric-mean residual reduction per outer iteration."""
        h = self.history
        if len(h) < 2 or float(h[0]) == 0.0:
            return 0.0
        return float((h[-1] / h[0]) ** (1.0 / (len(h) - 1)))


def _tol_in(tol: float, dtype) -> float:
    """``tol`` rounded to ``dtype``: the JAX loops compare the history entry
    with the weakly typed Python ``tol`` in the array's dtype."""
    return float(torch.tensor(tol, dtype=dtype))


def _np_dtype(dtype):
    return torch.empty((), dtype=dtype).numpy().dtype


class GMGSolver:
    """Geometric multigrid solver for the Dirichlet Poisson problem.

    Parameters mirror the JAX ``GMGSolver`` (and through it the reference
    CLI), plus ``device`` (default the card; ``device="cpu"`` for the CPU).
    ``use_pallas`` keeps its JAX meaning -- route the float32 smoother,
    residuals, grid transfers and ``inner_cg`` apply and CG vector updates
    through the kernel functions (``ops/routes.kernel_route``) -- and
    defaults to True on CUDA and False on the CPU.  On the CPU,
    ``use_pallas=True`` runs the kernels' torch twins; ``False`` runs the
    XLA-order plain ops on any device.
    ``fuse_downleg`` (with ``use_pallas``, ``smoother="gs"`` and
    ``omega=1``) runs each padded level's pre-smoothing, residual and
    restriction as one ``rbgs_residual_restrict`` call, bit-equal to the
    three separate ones; that kernel is 2D, as the JAX one is, so a 3D
    solver keeps the separate ops.
    """

    def __init__(
        self,
        shape: Sequence[int],
        length: float = 10.0,
        alpha: float = 10.0,
        num_levels: int = 2,
        smoother: str = "gs",
        cycle: str = "sawtooth",
        nu: int = 5,
        pre_sweeps: int = 2,
        omega: float = 1.0,
        tol: float = 1e-11,
        maxit: int = 1000,
        coarse_tol: float = 1e-1,
        coarse_maxit: int = 2000,
        smoother_dtype=None,
        pad_align: int | None = None,
        use_pallas: bool | None = None,
        coarse: str = "direct",
        fuse_downleg: bool = False,
        device="cuda",
    ):
        self.device = torch.device(device)
        self.levels = build_hierarchy(shape, length, num_levels,
                                      pad_align=pad_align)
        self.alpha = float(alpha)
        self.length = float(length)
        self.tol = float(tol)
        self.maxit = int(maxit)
        self.nu = int(nu)
        self.pre_sweeps = int(pre_sweeps)
        self.cycle = cycle
        self.coarse_tol = float(coarse_tol)
        self.coarse_maxit = int(coarse_maxit)
        if use_pallas is None:
            use_pallas = self.device.type == "cuda"
        self.smoother_dtype = smoother_dtype
        self._logical0 = _logical(self.levels[0])
        # the routes, built once: float32 work takes the kernels with
        # use_pallas, every other dtype the plain ops (_route)
        self._plain_route = plain_route(smoother, omega)
        self._f32_route = (
            kernel_route(len(self.levels[0].shape), smoother, omega,
                         fuse_downleg, self.alpha)
            if use_pallas else self._plain_route)
        # direct bottom solve: dense inverse of the coarsest operator, built
        # once in f64 on the host and kept on the device (f64); solves use a
        # copy cast to their dtype
        self._coarse_inv = None
        self._coarse_inv_cast = {}
        if coarse == "direct" and cycle in ("v", "w"):
            inv = self._build_coarse_inverse()
            if inv is not None:
                self._coarse_inv = torch.from_numpy(inv).to(self.device)

    def _build_coarse_inverse(self, max_nodes: int = 4608):
        """Dense inverse of the coarsest-level stencil operator (numpy f64).

        Interior nodes get ``2*ndim*c`` on the diagonal and ``-c`` per
        neighbour; logical-boundary and dead-zone nodes are identity rows.
        Returns ``None`` when the coarse buffer exceeds ``max_nodes`` (the
        smoother iteration stays in that case).
        """
        lev = self.levels[-1]
        shape = lev.physical
        n_nodes = int(np.prod(shape))
        if n_nodes > max_nodes:
            return None
        logical = lev.shape
        c = self.alpha / (lev.h * lev.h)
        idx = np.arange(n_nodes).reshape(shape)
        coords = np.indices(shape)
        interior = np.ones(shape, dtype=bool)
        for d in range(len(shape)):
            interior &= (coords[d] >= 1) & (coords[d] <= logical[d] - 2)
        A = np.eye(n_nodes)
        rows = idx[interior]
        A[rows, rows] = 2 * len(shape) * c
        for d in range(len(shape)):
            for off in (-1, +1):
                nb = np.roll(idx, -off, axis=d)  # nb[p] = idx at p + off
                A[rows, nb[interior]] = -c
        return np.linalg.inv(A)

    def _coarse_inv_as(self, dtype):
        """The coarse inverse cast to ``dtype`` (cached per dtype)."""
        if self._coarse_inv is None:
            return None
        if dtype not in self._coarse_inv_cast:
            self._coarse_inv_cast[dtype] = self._coarse_inv.to(dtype)
        return self._coarse_inv_cast[dtype]

    @staticmethod
    def _coarse_apply_of(cinv):
        if cinv is None:
            return None

        def apply_inv(bb):
            # a float32 matvec in full float32, never TF32 (set explicitly;
            # it is the default)
            torch.backends.cuda.matmul.allow_tf32 = False
            m = cinv if cinv.dtype == bb.dtype else cinv.to(bb.dtype)
            return (m @ bb.reshape(-1)).reshape(bb.shape)

        return apply_inv

    @property
    def smoother(self) -> Smoother:
        """The float32 route's smoother (the JAX solver's attribute)."""
        return self._f32_route.smooth

    def _route(self, dtype) -> Route:
        """The route of work in ``dtype``: the JAX kernel wrappers take
        float32 only and send every other dtype (f64, the bf16
        ``smoother_dtype`` cycle) to XLA ops (``_is_supported``), so here
        such work takes the plain route on every device and launches
        nothing."""
        return self._f32_route if dtype == torch.float32 else self._plain_route

    def _cycle(self, route: Route, u, b, cinv=None):
        """One outer cycle on ``route``, after the sawtooth's
        pre-smoothing sweeps."""
        if self.cycle == "sawtooth":
            with span(level_spans(0).pre_smooth):
                u = route.smooth(u, b, self.alpha, self.levels[0].h,
                                 self.pre_sweeps,
                                 logical_shape=self._logical0)
            return sawtooth_cycle(u, b, self.levels, self.alpha, route.smooth,
                                  nu=self.nu, coarse_tol=self.coarse_tol,
                                  coarse_maxit=self.coarse_maxit)
        cycle = {"v": v_cycle, "w": w_cycle}.get(self.cycle)
        if cycle is None:
            raise ValueError(f"unknown cycle {self.cycle!r}")
        return cycle(u, b, self.levels, self.alpha, route.smooth,
                     nu1=self.pre_sweeps, nu2=self.nu,
                     coarse_apply=self._coarse_apply_of(cinv),
                     residual=route.residual, downleg=route.downleg,
                     restrict=route.exact_restrict,
                     padded_restrict=route.padded_restrict,
                     prolong_add=route.prolong_add,
                     exact_prolong_add=route.exact_prolong_add)

    def step(self, u, b, cinv=None):
        """One outer iteration: pre-smooths (sawtooth) + one cycle.

        ``cinv``: coarse inverse for the direct bottom solve (default: the
        stored one).

        With ``smoother_dtype`` the iteration is a defect correction, as in
        the JAX package: the residual in the outer dtype (through the
        kernel), one cycle on the error equation in ``smoother_dtype``
        (plain ops, coarse inverse cast to that dtype), and the correction
        added back in the outer dtype."""
        if cinv is None:
            cinv = self._coarse_inv
        phys = self.levels[0].physical
        if tuple(b.shape) != phys or tuple(u.shape) != phys:
            # the JAX package fails here too, deeper in the cycle (e.g. the
            # CLI's -smt 2 with -pad hands logical-shape vectors in)
            raise ValueError(f"step takes finest-level buffers of shape "
                             f"{phys}, got u {tuple(u.shape)} and b "
                             f"{tuple(b.shape)}")
        route = self._route(u.dtype)
        if self.smoother_dtype is not None:
            r = route.residual(u, b, self.alpha, self.levels[0].h,
                               self._logical0)
            e = self._error_cycle(r.to(self.smoother_dtype), cinv)
            return u + e.to(u.dtype)
        return self._cycle(route, u, b, cinv)

    def _error_cycle(self, r, cinv=None):
        """One cycle on the error equation ``A e = r`` from ``e = 0``."""
        return self._cycle(self._route(r.dtype), torch.zeros_like(r), r, cinv)

    def _input(self, x, name):
        """``x`` as a tensor on the solver's device (numpy is copied there;
        a tensor elsewhere is refused -- devices are explicit)."""
        if isinstance(x, np.ndarray):
            return torch.as_tensor(x, device=self.device)
        if x.device.type != self.device.type or (
                self.device.index is not None
                and x.device.index != self.device.index):
            raise ValueError(f"{name} is on {x.device}, the solver on "
                             f"{self.device}")
        return x

    def _padded(self, x):
        lev0 = self.levels[0]
        if lev0.padded_shape is not None and tuple(x.shape) == lev0.shape:
            return pad_to(x, lev0.padded_shape)
        return x

    def _rel_fetch(self, u, b):
        """The history entry of ``u``: its relative residual, fetched."""
        with span(SPAN_FETCH):
            return fetch(rel_residual_norm(u, b, self.alpha, self.levels[0].h,
                                           self._logical0))

    def _solve_impl(self, u, b, cinv=None):
        lev0 = self.levels[0]
        with span(SPAN_SPLIT):
            b, u = self._padded(b), self._padded(u)
        tol = _tol_in(self.tol, b.dtype)
        hist = [self._rel_fetch(u, b)]
        k = 0
        while k < self.maxit and hist[k] > tol:
            with span(SPAN_CYCLE):
                u = self.step(u, b, cinv)
            hist.append(self._rel_fetch(u, b))
            k += 1
        if lev0.padded_shape is not None:
            with span(SPAN_COMBINE):
                u = crop_to(u, lev0.shape)
        return u, k, np.asarray(hist, dtype=_np_dtype(b.dtype))

    def solve_refined(self, b, inner_cg: int = 0) -> SolveResult:
        """Solve with float-float outer residuals: f32 cycles on the error
        equation against an extended-precision residual, which reaches
        ~1e-8 where plain f32 floors at ``eps_f32 * kappa(A)``.  One
        extended residual per iteration, carried into the next correction
        and the history entry; each iteration's pair update runs with that
        residual (one launch on the kernel route: f32 with
        ``use_pallas``).

        ``inner_cg = k > 0`` replaces each correction's single cycle with
        ``k`` iterations of cycle-preconditioned CG on the f32 error
        equation (``ops/krylov.cg_arrays``, operator apply and vector
        updates through the kernels with ``use_pallas``).  Whether that
        pays depends on the grid and the device: see PERF.md for the
        H100's numbers.

        ``smoother_dtype`` is not read here: the error cycles run in the
        outer dtype, as in the JAX package."""
        with span(SPAN_SOLVE_REFINED):
            return self._solve_refined(self._input(b, "b"), inner_cg)

    def _solve_refined(self, b, inner_cg):
        lev0 = self.levels[0]
        h0 = lev0.h
        c = self.alpha / (h0 * h0)
        with span(SPAN_SPLIT):
            b = self._padded(b)
            d_hi, d_lo = ff_from_div(b, c)
            b2 = norm2(b)
            u_hi = torch.zeros_like(b)
            u_lo = torch.zeros_like(b)
        cinv = self._coarse_inv_as(b.dtype)
        route = self._route(b.dtype)

        def rel(r):
            with span(SPAN_FETCH):
                return fetch(torch.sqrt(norm2(r) / b2))

        if inner_cg:
            bmask = boundary_mask(b.shape, self._logical0, b.device)

            def inner_solve(r):
                # A with Dirichlet identity rows is not symmetric on the full
                # space; on the zero-boundary subspace it is the SPD interior
                # operator, and A and the cycle preserve that subspace: run
                # CG there and solve the identity rows directly
                with span(SPAN_CG_MASK):
                    r_inner = r.masked_fill(bmask, 0.0)
                e, _, _, _ = cg_arrays(
                    lambda v: route.apply(v, self.alpha, h0, self._logical0),
                    r_inner, tol=0.0, maxit=inner_cg,
                    M=lambda rr: self._error_cycle(rr, cinv),
                    xr_step=route.cg_xr_update, p_step=route.cg_p_update)
                with span(SPAN_CG_MASK):
                    return torch.where(bmask, r, e)
        else:
            def inner_solve(r):
                return self._error_cycle(r, cinv)

        with span(SPAN_FF_RESIDUAL):
            r = route.ff_residual(u_hi, u_lo, d_hi, d_lo, b, self.alpha, h0,
                                  self._logical0)
        hist = [rel(r)]
        tol = _tol_in(self.tol, b.dtype)
        spare = None  # the other pair of buffers
        k = 0
        while k < self.maxit and hist[k] > tol:
            with span(SPAN_CYCLE):
                e = inner_solve(r)
            # the update writes the new pair into the spare buffers (a
            # kernel's neighbours read the old pair), and the two pairs swap
            with span(SPAN_FF_RESIDUAL):
                old = (u_hi, u_lo)
                u_hi, u_lo, r = route.ff_update_residual(
                    u_hi, u_lo, e, d_hi, d_lo, b, self.alpha, h0,
                    self._logical0, out=spare)
                spare = old
            hist.append(rel(r))
            k += 1
        with span(SPAN_COMBINE):
            u = u_hi + u_lo
            if lev0.padded_shape is not None:
                u = crop_to(u, lev0.shape)
        hist_np = np.asarray(hist, dtype=_np_dtype(b.dtype))
        return SolveResult(u=u, history=hist_np, iterations=k,
                           converged=bool(hist_np[-1] <= tol))

    def solve(self, b, u0=None, fmg_start: bool = False) -> SolveResult:
        """Solve to tolerance.  ``b`` (and ``u0``) are LOGICAL-shape arrays;
        padding is handled internally and the solution is cropped back.

        ``fmg_start``: start from one full-multigrid pass.
        """
        with span(SPAN_SOLVE):
            b = self._input(b, "b")
            check_finite(b, "rhs b")
            if fmg_start and u0 is None:
                u0 = fmg(self._padded(b), self.levels, self.alpha,
                         self._route(b.dtype).smooth, nu1=self.pre_sweeps,
                         nu2=self.nu)
            u0 = torch.zeros_like(b) if u0 is None else self._input(u0, "u0")
            # the bottom solve runs in the cycle's dtype: the
            # defect-correction cycle's is smoother_dtype (one cast from the
            # f64 inverse)
            cycle_dtype = (b.dtype if self.smoother_dtype is None
                           else self.smoother_dtype)
            u, k, hist = self._solve_impl(u0, b,
                                          self._coarse_inv_as(cycle_dtype))
        return SolveResult(u=u, history=hist, iterations=k,
                           converged=bool(hist[-1] <= _tol_in(self.tol,
                                                              b.dtype)))
