"""The port's 3D GMG path and the ``smoother_dtype`` defect correction vs
the JAX package, on the CPU.

The RHS is BASELINE config 4's smooth pair (``bench.py``'s
``measure_vcycle3d``): ``f = sin(3x) cos(2y) + z`` inside, ``g = exp(x)
exp(-2y) z`` on the boundary.  The port solvers are built from the JAX
solvers' state (``convert.solver_state_from_numpy``), so both sides run the
same hierarchy and coarse inverse.

With ``use_pallas=True`` the port runs its kernel twins.  The JAX solver
reaches its 3D Pallas kernels only in an aligned padded layout, and a full
interpret-mode 3D solve compiles for many minutes on a CPU, so the JAX side
runs its XLA ops (which its kernels match to a rounding,
tests/test_pallas_stencil_3d.py): ``use_pallas=True`` on the unaligned
exact layout (where its wrappers take XLA themselves) and
``use_pallas=False`` on the padded one.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multigrid_prj_tpu import gmg as jgmg
from multigrid_prj_tpu.models import poisson as jpoisson
from multigrid_prj_tpu_torch import gmg as tgmg
from multigrid_prj_tpu_torch.convert import solver_state_from_numpy
from multigrid_prj_tpu_torch.grids import GridLevel
from multigrid_prj_tpu_torch.ops import cuda_stencil as cs
from multigrid_prj_tpu_torch.ops import cuda_stencil_3d as c3
from tests.test_torch_gmg import _state

torch.set_num_threads(1)

CONFIG4 = dict(length=1.0, alpha=1.0, cycle="v", nu=2, pre_sweeps=2)


def _rhs(js, dtype=jnp.float32):
    """Config 4's RHS on the JAX solver's finest level, as numpy."""
    return np.array(jpoisson.assemble_rhs(
        js.levels[0], js.length, dtype=dtype,
        f=lambda x, y, z: jnp.sin(3.0 * x) * jnp.cos(2.0 * y) + z,
        g=lambda x, y, z: jnp.exp(x) * jnp.exp(-2.0 * y) * z))


def _pair(jax_pallas, port_pallas, smoother_dtype=None, **kw):
    js = jgmg.GMGSolver(use_pallas=jax_pallas,
                        smoother_dtype=(None if smoother_dtype is None
                                        else jnp.bfloat16), **kw)
    ts = solver_state_from_numpy(_state(js), device="cpu",
                                 use_pallas=port_pallas,
                                 smoother_dtype=smoother_dtype)
    return js, ts


@pytest.mark.parametrize("shape,levels,pad,jax_pallas,iters", [
    ((17, 17, 17), 3, None, True, 10),
    ((33, 33, 33), 3, (8, 8, 128), False, 10)])
def test_solve_refined_twins_match_jax(shape, levels, pad, jax_pallas,
                                       iters):
    """f32 ff32-refined V(2,2) to 1e-8, config 4's RHS: the port's kernel
    twins against the JAX solver (17^3 exact layout, 5^3 bottom; 33^3 in
    (40, 40, 128) buffers, dead zones in all three axes, (10, 10, 32)
    bottom).  Same iterations; the twins differ from XLA by a rounding
    where XLA contracts an FMA or sums neighbours in another order, and the
    late entries (~1e-9) are ratios of residuals at the f32 cycle's
    round-off: measured 7.3e-5 relative at most, held to 1e-3 (the
    solutions came out identical)."""
    js, ts = _pair(jax_pallas, True, shape=shape, num_levels=levels,
                   pad_align=pad, tol=1e-8, maxit=40, **CONFIG4)
    b = _rhs(js)
    want = js.solve_refined(jnp.asarray(b))
    cs.reset_launch_counts()
    got = ts.solve_refined(torch.from_numpy(b))
    assert all(v == 0 for v in cs.LAUNCHES.values())  # twins on the CPU
    assert want.iterations == iters and want.converged
    assert got.iterations == want.iterations and got.converged
    np.testing.assert_allclose(got.history, want.history, rtol=1e-3)
    u = got.u.numpy()
    assert u.shape == shape and np.all(np.isfinite(u))
    np.testing.assert_allclose(u, np.asarray(want.u),
                               atol=1e-6 * np.abs(u).max())


@pytest.mark.parametrize("cycle,pad", [("v", None), ("w", None),
                                       ("sawtooth", None),
                                       ("v", (8, 8, 128))])
def test_solve_f64_matches_jax_xla_3d(cycle, pad):
    """Plain path (``use_pallas=False``) in f64, 17^3: the same iterations
    and histories to round-off (rtol 1e-8 plus the f64 floor of a relative
    residual, eps_f64 * kappa(A))."""
    js, ts = _pair(False, False, shape=(17, 17, 17), num_levels=3,
                   pad_align=pad, tol=1e-10, maxit=60,
                   **dict(CONFIG4, cycle=cycle))
    b = _rhs(js, jnp.float64)
    want = js.solve(jnp.asarray(b))
    got = ts.solve(torch.from_numpy(b))
    assert got.history.dtype == np.float64
    assert got.iterations == want.iterations and got.converged
    np.testing.assert_allclose(got.history, np.asarray(want.history),
                               rtol=1e-8, atol=1e-13)
    np.testing.assert_allclose(got.u.numpy(), np.asarray(want.u),
                               atol=1e-10 * np.abs(np.asarray(want.u)).max())


@pytest.mark.parametrize("port_pallas", [False, True])
def test_config4_refined_33_matches_jax(port_pallas):
    """tests/test_gmg_3d.py's config-4 pin at 33^3 (3 levels, bf16
    ``smoother_dtype``, ff32 to 1e-8): ``solve_refined`` does not read
    ``smoother_dtype`` on either side, so the cycles run in f32; the port
    takes the JAX package's iterations with its plain ops and with its
    kernel twins (histories measured 1.1e-4 relative apart at most, held to
    1e-3)."""
    js, ts = _pair(False, port_pallas, smoother_dtype=torch.bfloat16,
                   shape=(33, 33, 33), num_levels=3, tol=1e-8, maxit=40,
                   **CONFIG4)
    b = _rhs(js)
    want = js.solve_refined(jnp.asarray(b))
    got = ts.solve_refined(torch.from_numpy(b))
    assert want.converged and want.iterations <= 15
    assert got.iterations == want.iterations and got.converged
    assert float(got.history[-1]) <= 1e-8
    np.testing.assert_allclose(got.history, want.history, rtol=1e-3)


@pytest.mark.parametrize("port_pallas", [False, True])
@pytest.mark.parametrize("dims", [2, 3])
def test_bf16_defect_correction_solve_matches_jax(dims, port_pallas):
    """``.solve`` with ``smoother_dtype=bfloat16``: f32 residuals, bf16
    cycles on the error equation (plain ops on both sides, whatever
    ``use_pallas`` says), the correction added in f32.  2D: the 33^2
    problem of tests/test_gmg_3d.py (test function 1, tol 5e-5).  3D: 17^3
    with config 4's RHS to 2e-4 (the f32 residual floor is ~5e-5 there).
    XLA's CPU backend keeps a fused chain of bf16 ops in f32 and rounds
    once, where torch rounds every op to bf16, so the cycles' corrections
    differ by bf16 roundings: the iterations are held to +-1 and the shared
    history entries to 30 % (measured 19 % in 2D, 10 % in 3D; the same
    counts except 2D with the twins, 4 against 5, where JAX's fourth entry,
    5.5e-5, sits just above the tolerance)."""
    if dims == 2:
        kw = dict(shape=(33, 33), length=10.0, alpha=10.0, num_levels=3,
                  cycle="v", nu=2, pre_sweeps=2, tol=5e-5, maxit=60)
    else:
        kw = dict(shape=(17, 17, 17), num_levels=3, tol=2e-4, maxit=60,
                  **CONFIG4)
    js, ts = _pair(False, port_pallas, smoother_dtype=torch.bfloat16, **kw)
    if dims == 2:
        b = np.array(jpoisson.assemble_rhs(js.levels[0], 10.0, test=1,
                                           dtype=jnp.float32))
    else:
        b = _rhs(js)
    want = js.solve(jnp.asarray(b))
    cs.reset_launch_counts()
    got = ts.solve(torch.from_numpy(b))
    assert all(v == 0 for v in cs.LAUNCHES.values())
    assert want.converged and got.converged
    assert got.history.dtype == np.float32
    assert abs(got.iterations - want.iterations) <= 1
    n = min(got.iterations, want.iterations) + 1
    np.testing.assert_allclose(got.history[:n], np.asarray(want.history)[:n],
                               rtol=0.3)


def test_bf16_cycle_runs_plain_ops_in_bf16():
    """The defect-correction cycle runs in bf16 through the plain ops: the
    kernel route's residual sees only the f32 outer residual, its smoother
    is never called, and the bottom solve gets the inverse in bf16."""
    ts = tgmg.GMGSolver(shape=(17, 17, 17), num_levels=3, tol=1e-3,
                        maxit=10, smoother_dtype=torch.bfloat16,
                        use_pallas=True, device="cpu", **CONFIG4)
    route = ts._route(torch.float32)
    assert route.residual is c3.poisson_residual_3d
    seen = []

    def spy(u, b, *a):
        seen.append(u.dtype)
        return c3.poisson_residual_3d(u, b, *a)

    # the kernel route's smoother must not be called
    ts._f32_route = route._replace(residual=spy, smooth=None)
    b = torch.from_numpy(_rhs(jgmg.GMGSolver(shape=(17, 17, 17),
                                             num_levels=3, use_pallas=False,
                                             **CONFIG4)))
    out = ts.solve(b)
    assert out.converged and seen and set(seen) == {torch.float32}
    assert torch.bfloat16 in ts._coarse_inv_cast


def test_convert_accepts_3d_state_without_coarse_inverse():
    """A 3D JAX solver whose 17^3 bottom (4913 nodes) is above the dense
    inverse's 4608-node cap has ``coarse_inv=None``; the port solver built
    from its state has the same levels, no inverse, and the same solution
    (the bottom runs 100 RB-GS sweeps on both sides)."""
    js, ts = _pair(False, False, shape=(33, 33, 33), num_levels=2,
                   tol=1e-8, maxit=40, **CONFIG4)
    assert js._coarse_inv is None and ts._coarse_inv is None
    assert ts.levels == [GridLevel(*dataclasses.astuple(lev))
                         for lev in js.levels]
    assert ts.levels[-1].shape == (17, 17, 17)
    b = _rhs(js, jnp.float64)
    want = js.solve(jnp.asarray(b))
    got = ts.solve(torch.from_numpy(b))
    assert got.iterations == want.iterations and got.converged
    np.testing.assert_allclose(got.u.numpy(), np.asarray(want.u),
                               atol=1e-10 * np.abs(np.asarray(want.u)).max())
