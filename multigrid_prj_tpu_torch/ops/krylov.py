"""Krylov solvers: BiCGSTAB and CG (port of
``multigrid_prj_tpu/ops/krylov.py``).

Matrix-free (``A`` is any callable) with optional right preconditioning
(``M``), which is how a multigrid cycle becomes a Krylov preconditioner.
The JAX package runs each solver as one ``lax.while_loop``; here the loops
are Python loops that fetch one scalar per iteration (the stop test), with
the same breakdown guards (``eps = finfo.tiny * 1e4``) and the same
``history`` / ``hist_cap`` semantics.  Everything else stays on the device
of ``b``.  CG's stop test is a ``utils/metrics.fetch`` (counted in
``COUNTERS["host_syncs"]``, inside ``mg.fetch``), and its stages run inside
the ``mg.cg.*`` profiler spans, which cost one check each when no profiler
records.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from multigrid_prj_tpu_torch.utils.metrics import (
    SPAN_CG_APPLY,
    SPAN_CG_DOT,
    SPAN_CG_PRECOND,
    SPAN_CG_UPDATE,
    SPAN_FETCH,
    fetch,
    span,
)


@dataclasses.dataclass
class KrylovResult:
    x: torch.Tensor
    iterations: int
    rel_residual: float
    converged: bool
    # per-iteration relative residual norms ([initial, after it 1, ...]);
    # only populated when the solver was called with history=True
    history: Optional[torch.Tensor] = None


def _dot(a, b):
    return torch.vdot(a.reshape(-1), b.reshape(-1))


def _hist0(b, r0, bnorm, history, length):
    hist = torch.full((length,) if history else (1,), float("nan"),
                      dtype=b.dtype, device=b.device)
    hist[0] = torch.sqrt(_dot(r0, r0).real) / bnorm
    return hist


def bicgstab(
    A: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    tol: float = 1e-11,
    maxit: Optional[int] = None,
    M: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    history: bool = False,
    hist_cap: Optional[int] = None,
) -> KrylovResult:
    """Preconditioned BiCGSTAB for ``A x = b``; returns :class:`KrylovResult`.

    ``M`` approximates ``A^{-1}`` (identity if omitted -- the reference's
    configuration).  Stops at ``||r|| <= tol ||b||``, ``maxit``, or a
    breakdown of ``rho`` or ``omega``.  ``history=True`` records the
    per-iteration relative residual norms.
    """
    if x0 is None:
        x0 = torch.zeros_like(b)
    if maxit is None:
        maxit = b.numel()
    if M is None:
        M = lambda r: r
    eps = torch.finfo(b.dtype).tiny * 1e4

    def guard(v):
        return torch.where(v.abs() > eps, v, torch.full_like(v, eps))

    bnorm = torch.sqrt(_dot(b, b).real)
    bnorm = torch.where(bnorm > 0, bnorm, torch.ones_like(bnorm))
    r = b - A(x0)
    rhat = r
    hist = _hist0(b, r, bnorm, history,
                  (hist_cap if hist_cap is not None else maxit) + 1)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    x, p, v = x0, torch.zeros_like(b), torch.zeros_like(b)
    rho, alpha, omega = one, one, one
    k, ok = 0, True
    while (k < maxit and ok
           and bool(torch.sqrt(_dot(r, r).real) > tol * bnorm)):
        rho1 = _dot(rhat, r)
        beta = (rho1 / guard(rho)) * (alpha / guard(omega))
        p = r + beta * (p - omega * v)
        phat = M(p)
        v = A(phat)
        alpha = rho1 / guard(_dot(rhat, v))
        s = r - alpha * v
        shat = M(s)
        t = A(shat)
        omega = _dot(t, s) / guard(_dot(t, t))
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        ok = bool((rho1.abs() > eps) & (omega.abs() > eps))
        if history:
            idx = k + 1 if hist_cap is None else min(k + 1, hist_cap)
            hist[idx] = torch.sqrt(_dot(r, r).real) / bnorm
        rho = rho1
        k += 1
    rel = torch.sqrt(_dot(r, r).real) / bnorm
    return KrylovResult(x=x, iterations=k, rel_residual=float(rel),
                        converged=bool(rel <= tol),
                        history=hist[: k + 1] if history else None)


def cg(
    A: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    tol: float = 1e-11,
    maxit: Optional[int] = None,
    M: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    history: bool = False,
) -> KrylovResult:
    """Preconditioned conjugate gradients for SPD ``A``."""
    if maxit is None:
        maxit = b.numel()
    x, k, rel, hist = cg_arrays(A, b, x0=x0, tol=tol, maxit=maxit, M=M,
                                history=history)
    rel = float(rel)
    return KrylovResult(x=x, iterations=k, rel_residual=rel,
                        converged=rel <= tol,
                        history=hist[: k + 1] if history else None)


def cg_arrays(
    A: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    tol: float = 1e-11,
    maxit: int = 100,
    M: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    history: bool = False,
    hist_cap: Optional[int] = None,
) -> tuple:
    """CG core: returns ``(x, k, rel, hist)`` with ``x``, ``rel`` and
    ``hist`` tensors on ``b``'s device and ``k`` an int.

    ``hist_cap``: history-buffer length; writes past the cap clamp into the
    last slot.  When None the buffer holds every iteration.  With
    ``tol = 0`` the loop runs ``maxit`` iterations unless the residual
    vanishes (``||r|| > 0`` is still tested).
    """
    if x0 is None:
        x0 = torch.zeros_like(b)
    if M is None:
        M = lambda r: r
    with span(SPAN_CG_DOT):
        bnorm = torch.sqrt(_dot(b, b).real)
        bnorm = torch.where(bnorm > 0, bnorm, torch.ones_like(bnorm))
    with span(SPAN_CG_APPLY):
        r = A(x0)
    with span(SPAN_CG_UPDATE):
        r = b - r  # r0 = b - A x0, A x0 freed here
    with span(SPAN_CG_PRECOND):
        z = M(r)
    with span(SPAN_CG_DOT):
        hist = _hist0(b, r, bnorm, history,
                      (hist_cap if hist_cap is not None else maxit) + 1)
        rz = _dot(r, z)
    x, p, k = x0, z, 0
    while k < maxit:
        with span(SPAN_FETCH):
            above = fetch(torch.sqrt(_dot(r, r).real) > tol * bnorm)
        if not above:
            break
        with span(SPAN_CG_APPLY):
            Ap = A(p)
        with span(SPAN_CG_DOT):
            alpha = rz / _dot(p, Ap)
        with span(SPAN_CG_UPDATE):
            x = x + alpha * p
            r = r - alpha * Ap
        with span(SPAN_CG_PRECOND):
            z = M(r)
        with span(SPAN_CG_DOT):
            rz1 = _dot(r, z)
        with span(SPAN_CG_UPDATE):
            p = z + (rz1 / rz) * p
        if history:
            idx = k + 1 if hist_cap is None else min(k + 1, hist_cap)
            with span(SPAN_CG_DOT):
                hist[idx] = torch.sqrt(_dot(r, r).real) / bnorm
        rz = rz1
        k += 1
    with span(SPAN_CG_DOT):
        rel = torch.sqrt(_dot(r, r).real) / bnorm
    return x, k, rel, hist
