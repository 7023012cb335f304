"""The port's Krylov solvers (``multigrid_prj_tpu_torch/ops/krylov.py``) vs
``multigrid_prj_tpu/ops/krylov.py`` on a 33^2 f64 Poisson problem.

The operator is the plain stencil apply on both sides; the right-hand side
is seeded numpy noise with a zero Dirichlet boundary, so the iterates stay
in the subspace where the operator is SPD (CG needs that).  ``M`` is the
diagonal (Jacobi) preconditioner or one multigrid V-cycle step (the CLI's
``-smt 2`` preconditioner) of solvers with the same hierarchy and coarse
inverse.  The two sides sum their dot products in another order (XLA's
reduction vs torch's vdot), so the iterates differ by round-off: equal
iteration counts, ``x`` within 1e-10 relative.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multigrid_prj_tpu import gmg as jgmg
from multigrid_prj_tpu.ops import krylov as jk
from multigrid_prj_tpu.ops import stencil as jst
from multigrid_prj_tpu_torch.convert import solver_state_from_numpy
from multigrid_prj_tpu_torch.ops import krylov as tk
from multigrid_prj_tpu_torch.ops import stencil as tst

torch.set_num_threads(1)

N = 33
ALPHA = 10.0
H = 10.0 / (N - 1)
C = ALPHA / (H * H)


def _problem():
    rng = np.random.default_rng(7)
    b = rng.standard_normal((N, N))
    b[0, :] = b[-1, :] = b[:, 0] = b[:, -1] = 0.0
    diag = np.full((N, N), 4.0 * C)
    diag[0, :] = diag[-1, :] = diag[:, 0] = diag[:, -1] = 1.0
    return b, diag


def _sides(precond):
    """(A, b, M) for JAX and for the port, on the same data."""
    b, diag = _problem()
    jd, td = jnp.asarray(diag), torch.from_numpy(diag)
    jM = tM = None
    if precond == "diag":
        jM, tM = (lambda r: r / jd), (lambda r: r / td)
    elif precond == "mg":
        js = jgmg.GMGSolver(shape=(N, N), num_levels=3, cycle="v", nu=2,
                            use_pallas=False)
        state = dict(levels=[dataclasses.astuple(lev) for lev in js.levels],
                     coarse_inv=np.asarray(js._coarse_inv), length=js.length,
                     alpha=js.alpha, tol=js.tol, maxit=js.maxit, nu=js.nu,
                     pre_sweeps=js.pre_sweeps, cycle=js.cycle,
                     coarse_tol=js.coarse_tol, coarse_maxit=js.coarse_maxit)
        ts = solver_state_from_numpy(state, device="cpu",
                                     use_pallas=False)
        jM = lambda r: js.step(jnp.zeros_like(r), r)
        tM = lambda r: ts.step(torch.zeros_like(r), r)
    jside = (lambda x: jst.poisson_apply(x, ALPHA, H), jnp.asarray(b), jM)
    tside = (lambda x: tst.poisson_apply(x, ALPHA, H), torch.from_numpy(b),
             tM)
    return jside, tside


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


# Unpreconditioned (and diagonally scaled) BiCGSTAB amplifies the dot
# products' round-off about 2.7x per iteration on this problem (measured:
# relative history difference 3e-10 at iteration 20, 0.2 at 39), so those
# cases are compared over their first 15 iterations (maxit); CG and the
# multigrid-preconditioned BiCGSTAB run to tol.
@pytest.mark.parametrize("solver,precond,maxit", [
    ("cg", None, None), ("cg", "diag", None),
    ("bicgstab", None, 15), ("bicgstab", "diag", 15),
    ("bicgstab", "mg", None)])
def test_krylov_result_matches_jax(solver, precond, maxit):
    (jA, jb, jM), (tA, tb, tM) = _sides(precond)
    want = getattr(jk, solver)(jA, jb, tol=1e-10, maxit=maxit, M=jM,
                               history=True)
    got = getattr(tk, solver)(tA, tb, tol=1e-10, maxit=maxit, M=tM,
                              history=True)
    assert got.iterations == want.iterations
    assert got.converged == want.converged == (maxit is None)
    _close(got.x.numpy(), want.x, 1e-10)
    assert got.history.shape == (got.iterations + 1,)
    # entries near 1e-10 carry the dot products' round-off, amplified by
    # about kappa(A) ~ 4e2 at 33^2
    np.testing.assert_allclose(got.history.numpy(), np.asarray(want.history),
                               rtol=1e-6)
    assert abs(got.rel_residual - want.rel_residual) <= 1e-6 * want.rel_residual


@pytest.mark.parametrize("precond", [None, "diag"])
@pytest.mark.parametrize("tol,maxit,hist_cap", [(1e-10, 200, None),
                                                (0.0, 3, None),
                                                (1e-10, 200, 4)])
def test_cg_arrays_matches_jax(precond, tol, maxit, hist_cap):
    """``tol = 0`` runs exactly ``maxit`` iterations (the ``inner_cg``
    use); ``hist_cap`` clamps late history writes into the last slot."""
    (jA, jb, jM), (tA, tb, tM) = _sides(precond)
    wx, wk, wrel, whist = jk.cg_arrays(jA, jb, tol=tol, maxit=maxit, M=jM,
                                       history=True, hist_cap=hist_cap)
    gx, gk, grel, ghist = tk.cg_arrays(tA, tb, tol=tol, maxit=maxit, M=tM,
                                       history=True, hist_cap=hist_cap)
    assert gk == int(wk)
    if tol == 0.0:
        assert gk == maxit
    _close(gx.numpy(), wx, 1e-10)
    np.testing.assert_allclose(float(grel), float(wrel), rtol=1e-6)
    assert ghist.shape == whist.shape
    np.testing.assert_allclose(ghist.numpy(), np.asarray(whist), rtol=1e-6)
