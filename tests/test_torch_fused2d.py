"""Twins of the fused 2D kernels of ``multigrid_prj_tpu_torch.ops.cuda_stencil``
(the down-leg ``rbgs_residual_restrict``, ``poisson_apply_chain`` and
``rbgs_color_sweep``) vs the JAX Pallas functions in interpret mode, as
tests/test_pallas_stencil.py runs them, and the ``fuse_downleg`` solve vs
the JAX solver.  The CUDA kernels are held to these twins in
tests/test_torch_cuda.py.

Inputs are made with a seeded numpy generator and handed to both sides.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from multigrid_prj_tpu import gmg as jgmg
from multigrid_prj_tpu.models import poisson as jpoisson
from multigrid_prj_tpu.ops import pallas_stencil as ps
from multigrid_prj_tpu_torch.convert import solver_state_from_numpy
from multigrid_prj_tpu_torch.ops import cuda_stencil as cs
from multigrid_prj_tpu_torch.ops import transfer as ttr
from multigrid_prj_tpu_torch.ops.stencil import boundary_mask

torch.set_num_threads(1)

ALPHA = 10.0
# (physical shape, logical shape): JAX's down-leg test case (201 x 129 in a
# 256^2 buffer), a ragged one in a non-square buffer, an exact layout
DOWNLEG_CASES = [((256, 256), (201, 129)), ((256, 384), (201, 329))]
STENCIL_CASES = [((128, 128), None), ((256, 256), (129, 129))]


def _rand(shape, count, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(count)]


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


@pytest.mark.parametrize("shape,logical", DOWNLEG_CASES)
@pytest.mark.parametrize("sweeps", [1, 2, 3, 5])
def test_downleg_twin_matches_pallas(shape, logical, sweeps):
    """The twin against ``ps.rbgs_residual_restrict`` in interpret mode
    (sweeps 5: the composition on both sides).  The smoothed u differs by
    the smoother's FMA roundings (XLA contracts ``b * (1/c) + N``): held to
    2 ulp of the field's largest value, as the smoother alone.  The
    residual and restriction are bit-equal ops on both sides, so the
    coarse residual differs only through that u: held to 8 c max|du| (the
    stencil's weights sum to 8c) plus 2 ulp of its largest value.  The
    coarse edge and dead entries are exactly 0 on both sides (the smoothed
    residual is b - b on the logical boundary)."""
    u, b = _rand(shape, 2, seed=3)
    h = 10.0 / (logical[0] - 1)
    c = ALPHA / (h * h)
    with pltpu.force_tpu_interpret_mode():
        u_want, rc_want = (np.asarray(x) for x in ps.rbgs_residual_restrict(
            jnp.asarray(u), jnp.asarray(b), ALPHA, h, sweeps, logical))
    cs.reset_launch_counts()
    u_got, rc_got = (x.numpy() for x in cs.rbgs_residual_restrict(
        *_t(u, b), ALPHA, h, sweeps, logical))
    assert all(v == 0 for v in cs.LAUNCHES.values())  # the twin on the CPU
    assert rc_got.shape == (shape[0] // 2, shape[1] // 2)
    du = np.abs(u_got - u_want).max()
    assert du <= 2 * np.spacing(np.abs(u_want).max())
    bound = 8 * c * du + 2 * np.spacing(np.abs(rc_want).max())
    assert np.abs(rc_got - rc_want).max() <= bound
    nc_r, nc_c = (logical[0] + 1) // 2, (logical[1] + 1) // 2
    edge = np.ones(rc_got.shape, dtype=bool)
    edge[1:nc_r - 1, 1:nc_c - 1] = False
    assert not rc_got[edge].any() and not rc_want[edge].any()


@pytest.mark.parametrize("sweeps", [0, 2, 4])
def test_downleg_twin_is_the_composition(sweeps):
    """The twin is, op for op, the port's smoother, residual and padded
    restriction in a row (bit-equal), and refuses a missing logical shape,
    as the JAX function does."""
    shape, logical = (256, 384), (201, 329)
    u, b = _t(*_rand(shape, 2, seed=4))
    h = 10.0 / (logical[0] - 1)
    u2, rc = cs.rbgs_residual_restrict(u, b, ALPHA, h, sweeps, logical)
    want_u = cs.red_black_gauss_seidel(u, b, ALPHA, h, sweeps=sweeps,
                                       logical_shape=logical)
    r = cs.poisson_residual(want_u, b, ALPHA, h, logical)
    assert torch.equal(u2, want_u)
    assert torch.equal(rc, cs.restrict_fw_padded_fast(r, logical))
    assert torch.equal(rc, ttr.restrict_fw_padded(r, logical))
    with pytest.raises(ValueError, match="logical_shape"):
        cs.rbgs_residual_restrict(u, b, ALPHA, h, sweeps, None)


@pytest.mark.parametrize("shape,logical", STENCIL_CASES)
@pytest.mark.parametrize("applies", [1, 3, 8, 11])
def test_apply_chain_twin_matches_pallas(shape, logical, applies):
    """``A^applies u`` (11 crosses the 8-apply fusion boundary): the twin
    against ``ps.poisson_apply_chain`` in interpret mode.  Each apply is
    ``c * ((((4u - N) - S) - E) - W)``, where 4u is exact and nothing else
    contracts: bit-equal.  alpha = h^2 (c = 1) keeps 11 applies of a
    unit-size field in f32 range (growth ~8^s), as JAX's own chain test."""
    (u,) = _rand(shape, 1, seed=5)
    h = 10.0 / ((logical or shape)[0] - 1)
    alpha = h * h
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ps.poisson_apply_chain(jnp.asarray(u), alpha, h,
                                                 applies, logical))
    (ut,) = _t(u)
    got = cs.poisson_apply_chain(ut, alpha, h, applies, logical).numpy()
    assert np.all(np.isfinite(want))
    np.testing.assert_array_equal(got, want)
    x = ut
    for _ in range(applies):
        x = cs.poisson_apply(x, alpha, h, logical)
    assert torch.equal(torch.from_numpy(got), x)


def test_apply_chain_3d_chains_the_3d_apply():
    """A 3D tensor chains the 3D apply, as the JAX wrapper does."""
    from multigrid_prj_tpu_torch.ops import cuda_stencil_3d as c3

    (u,) = _t(*_rand((9, 10, 12), 1, seed=6))
    x = u
    for _ in range(3):
        x = c3.poisson_apply_3d(x, 1.0, 0.5)
    assert torch.equal(cs.poisson_apply_chain(u, 1.0, 0.5, 3), x)
    assert torch.equal(cs.poisson_apply_chain(u, 1.0, 0.5, 0), u)


@pytest.mark.parametrize("shape,logical", STENCIL_CASES)
@pytest.mark.parametrize("color", [0, 1])
def test_color_sweep_twin_matches_pallas(shape, logical, color):
    """One colour of ``ps.rbgs_color_sweep`` (interpret mode) against the
    twin.  The Pallas body divides ``b / c``; XLA's CPU backend divides by
    a constant through its reciprocal and contracts the first add, so a
    point can differ by a rounding or two: held to 2 ulp of the field's
    largest value.  The other colour keeps u and every boundary point gets
    b, exactly, on both sides."""
    u, b = _rand(shape, 2, seed=7)
    h = 10.0 / ((logical or shape)[0] - 1)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ps.rbgs_color_sweep(jnp.asarray(u), jnp.asarray(b),
                                              ALPHA, h, color, logical))
    got = cs.rbgs_color_sweep(*_t(u, b), ALPHA, h, color, logical).numpy()
    assert np.abs(got - want).max() <= 2 * np.spacing(np.abs(want).max())
    bnd = boundary_mask(shape, logical).numpy()
    parity = np.add.outer(np.arange(shape[0]), np.arange(shape[1])) % 2
    keep = ~bnd & (parity != color)
    np.testing.assert_array_equal(got[bnd], b[bnd])
    np.testing.assert_array_equal(got[keep], u[keep])
    np.testing.assert_array_equal(want[keep], u[keep])


def test_color_sweep_refuses_what_jax_refuses_and_takes_any_2d_shape():
    """Unlike the JAX kernel it takes an unaligned shape (65 x 67 here); a
    3D tensor or a colour other than 0 / 1 is refused."""
    u, b = _t(*_rand((65, 67), 2, seed=8))
    out = cs.rbgs_color_sweep(u, b, ALPHA, 0.1, 1)
    assert out.shape == (65, 67) and torch.equal(out[0], b[0])
    with pytest.raises(ValueError):
        cs.rbgs_color_sweep(u[None], b[None], ALPHA, 0.1, 0)
    with pytest.raises(ValueError):
        cs.rbgs_color_sweep(u, b, ALPHA, 0.1, 2)


def _state(js):
    return dict(levels=[dataclasses.astuple(lev) for lev in js.levels],
                coarse_inv=(None if js._coarse_inv is None
                            else np.asarray(js._coarse_inv)),
                length=js.length, alpha=js.alpha, tol=js.tol, maxit=js.maxit,
                nu=js.nu, pre_sweeps=js.pre_sweeps, cycle=js.cycle,
                coarse_tol=js.coarse_tol, coarse_maxit=js.coarse_maxit)


@pytest.mark.parametrize("method,tol,atol", [("solve_refined", 1e-8, 0.0),
                                             ("solve", 1e-3, 2e-5)])
def test_fused_downleg_solve_129_matches_jax_pallas(method, tol, atol):
    """129^2, 4 levels, pad 128, V(2,2), f32: ``solve_refined`` to 1e-8 and
    ``solve`` to 1e-3: the port's ``fuse_downleg`` solve through the twins
    against JAX ``GMGSolver(use_pallas=True, fuse_downleg=True)`` in
    interpret mode, with the same hierarchy and coarse inverse.  The
    pattern and bounds of tests/test_torch_gmg.py's unfused case (the twins
    differ from interpret mode by the roundings XLA contracts; measured
    history differences there 2.1e-5 relative, held to 1e-4).  ``solve``'s
    history is a plain f32 residual of an f32 iterate, whose round-off
    floor is eps_f32 kappa(A) ~ 8e-4 relative: its late entries differ by
    6.6e-6 absolute (measured), held to 2e-5 beside the 1e-4 relative.
    The port's fused history equals its unfused one exactly: the down-leg
    twin is the composition it replaces."""
    kw = dict(shape=(129, 129), length=10.0, alpha=10.0, num_levels=4,
              cycle="v", nu=2, pre_sweeps=2, tol=tol, maxit=60,
              pad_align=128)
    js = jgmg.GMGSolver(use_pallas=True, fuse_downleg=True, **kw)
    assert js._downleg_fn is not None
    fused = solver_state_from_numpy(_state(js), device="cpu", use_pallas=True,
                                    fuse_downleg=True)
    plain = solver_state_from_numpy(_state(js), device="cpu", use_pallas=True)
    assert fused._route(torch.float32).downleg is not None
    assert plain._route(torch.float32).downleg is None
    b = jpoisson.assemble_rhs(js.levels[0], 10.0, test=1, dtype=jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        want = getattr(js, method)(b)
    bt = torch.from_numpy(np.array(b))
    got = getattr(fused, method)(bt)
    ref = getattr(plain, method)(bt)
    assert want.converged and got.converged
    assert got.iterations == want.iterations == ref.iterations
    np.testing.assert_array_equal(got.history, ref.history)
    assert torch.equal(got.u, ref.u)
    np.testing.assert_allclose(got.history, np.asarray(want.history),
                               rtol=1e-4, atol=atol)
    u = got.u.numpy()
    assert u.shape == (129, 129) and np.all(np.isfinite(u))
    np.testing.assert_allclose(u, np.asarray(want.u),
                               atol=1e-6 * np.abs(u).max())
