"""Kernel twins of ``multigrid_prj_tpu_torch.ops.cuda_stencil`` vs the JAX
Pallas functions (interpret mode, as tests/test_pallas_stencil.py runs them).
The CUDA kernels are held to these twins in tests/test_torch_cuda.py.

Inputs are made with a seeded numpy generator and handed to both sides.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from multigrid_prj_tpu.ops import extended as jext
from multigrid_prj_tpu.ops import pallas_stencil as ps
from multigrid_prj_tpu_torch.ops import cuda_stencil as cs
from multigrid_prj_tpu_torch.ops import extended as text
from multigrid_prj_tpu_torch.ops import smoothers as sm
from multigrid_prj_tpu_torch.ops.stencil import boundary_mask

torch.set_num_threads(1)

ALPHA = 10.0
# (physical n, logical shape): aligned exact layout, and 129^2 in a 256^2
# padded buffer
CASES = [(128, None), (256, (129, 129))]


def _inputs(n, logical, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((n, n)).astype(np.float32)
    b = rng.standard_normal((n, n)).astype(np.float32)
    u_lo = (1e-8 * rng.standard_normal((n, n))).astype(np.float32)
    h = 10.0 / ((logical or (n, n))[0] - 1)
    return u, b, u_lo, h


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _ulp_diff(a, b):
    """Largest distance in units in the last place between two f32 arrays."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    return int(np.max(np.abs(ordered(a) - ordered(b))))


@pytest.mark.parametrize("n,logical", CASES)
@pytest.mark.parametrize("sweeps", [1, 2, 4, 5, 8, 9])
def test_rbgs_twin_matches_pallas(n, logical, sweeps):
    """Same op order as the fused Pallas kernel, but XLA's CPU backend
    contracts ``b * (1/c) + N`` into one FMA in interpret mode, so a point
    can differ by one rounding that the sweeps then carry: bound the
    difference by 2 ulp of the field's largest value.  5, 8 and 9 sweeps
    cross the 4-sweep fusion boundary of both packages (9: 4 + 4 + 1)."""
    u, b, _, h = _inputs(n, logical)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ps.red_black_gauss_seidel(
            jnp.asarray(u), jnp.asarray(b), ALPHA, h, sweeps=sweeps,
            logical_shape=logical))
    got = cs.red_black_gauss_seidel(*_t(u, b), ALPHA, h, sweeps=sweeps,
                                    logical_shape=logical).numpy()
    bound = 2 * np.spacing(np.abs(want).max())
    assert np.abs(got - want).max() <= bound
    # boundary and dead zone are pinned to b exactly
    bnd = boundary_mask((n, n), logical).numpy()
    np.testing.assert_array_equal(got[bnd], b[bnd])


@pytest.mark.parametrize("n,logical", CASES)
def test_residual_twin_matches_pallas(n, logical):
    """No contractible mul-add in this op order: bit-equal."""
    u, b, _, h = _inputs(n, logical)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ps.poisson_residual(jnp.asarray(u), jnp.asarray(b),
                                              ALPHA, h, logical))
    got = cs.poisson_residual(*_t(u, b), ALPHA, h, logical).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,logical", CASES)
def test_ff_residual_twin_matches_pallas(n, logical):
    """The two-sum chains are exact on both sides; the final
    ``c*t_hi + c*t_lo`` is one FMA under XLA and two roundings here:
    <= 2 ulp (tests/test_pallas_stencil.py holds the Pallas kernel to the
    same)."""
    u, b, u_lo, h = _inputs(n, logical)
    c = ALPHA / (h * h)
    d_hi, d_lo = (np.asarray(x) for x in jext.ff_from_div(jnp.asarray(b), c))
    args = (u, u_lo, d_hi, d_lo, b)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ps.ff_poisson_residual(
            *(jnp.asarray(a) for a in args), ALPHA, h, logical))
    got = cs.ff_poisson_residual(*_t(*args), ALPHA, h, logical).numpy()
    assert _ulp_diff(got, want) <= 2


@pytest.mark.parametrize("n,logical", CASES)
def test_apply_twin_matches_pallas(n, logical):
    """``c * ((((4u - N) - S) - E) - W)`` has no contractible mul-add:
    bit-equal (to the carry kernel at 256^2, the one-block kernel at
    128^2)."""
    u, _, _, h = _inputs(n, logical)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ps.poisson_apply(jnp.asarray(u), ALPHA, h, logical))
    got = cs.poisson_apply(*_t(u), ALPHA, h, logical).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,logical", CASES)
@pytest.mark.parametrize("sweeps", [2, 8, 11])
@pytest.mark.parametrize("omega", [0.8, 1.0])
def test_jacobi_twin_matches_pallas(n, logical, sweeps, omega):
    """Same op order as the fused Pallas kernel, but XLA's CPU backend
    contracts ``b * (1/c) + N`` and ``(1-omega) x + omega jac`` into FMAs in
    interpret mode: a point can differ by a rounding that the sweeps carry.
    Bound: 2 ulp of the field's largest value (measured 0.5).  11 sweeps
    cross the Pallas 8-sweep fusion boundary."""
    u, b, _, h = _inputs(n, logical)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ps.jacobi(jnp.asarray(u), jnp.asarray(b), ALPHA, h,
                                    omega=omega, sweeps=sweeps,
                                    logical_shape=logical))
    got = cs.jacobi(*_t(u, b), ALPHA, h, omega=omega, sweeps=sweeps,
                    logical_shape=logical).numpy()
    assert np.abs(got - want).max() <= 2 * np.spacing(np.abs(want).max())
    bnd = boundary_mask((n, n), logical).numpy()
    np.testing.assert_array_equal(got[bnd], b[bnd])


@pytest.mark.parametrize("shape,logical", [((64, 512), (61, 509)),
                                           ((128, 256), (127, 255)),
                                           ((64, 512), (64, 512))])
def test_restrict_twin_matches_pallas(shape, logical):
    """The twin is ``transfer.restrict_fw_padded``; the Pallas restriction
    equals it exactly (tests/test_pallas_stencil.py), and so does the
    twin: bit-equal."""
    r = np.random.default_rng(21).standard_normal(shape).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ps.restrict_fw_padded_fast(jnp.asarray(r), logical))
    got = cs.restrict_fw_padded_fast(*_t(r), logical).numpy()
    assert got.shape == (shape[0] // 2, shape[1] // 2)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(64, 512), (128, 512)])
def test_prolong_add_twin_matches_pallas(shape):
    """``u + prolong_padded(e)``: averages and one add, nothing to
    contract: bit-equal."""
    rng = np.random.default_rng(22)
    n, m = shape
    e = rng.standard_normal((n // 2, m // 2)).astype(np.float32)
    u = rng.standard_normal((n, m)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ps.prolong_add_padded_fast(jnp.asarray(e),
                                                     jnp.asarray(u)))
    got = cs.prolong_add_padded_fast(*_t(e, u)).numpy()
    np.testing.assert_array_equal(got, want)


def test_cpu_wrappers_do_not_launch_or_mutate():
    u, b, u_lo, h = _inputs(128, None)
    ut, bt = _t(u, b)
    cs.reset_launch_counts()
    cs.red_black_gauss_seidel(ut, bt, ALPHA, h, sweeps=2)
    cs.poisson_residual(ut, bt, ALPHA, h)
    cs.poisson_apply(ut, ALPHA, h)
    cs.jacobi(ut, bt, ALPHA, h, omega=0.8, sweeps=2)
    cs.restrict_fw_padded_fast(ut, (127, 127))
    cs.prolong_add_padded_fast(bt[:64, :64].contiguous(), ut)
    assert all(v == 0 for v in cs.LAUNCHES.values())
    np.testing.assert_array_equal(ut.numpy(), u)
    np.testing.assert_array_equal(bt.numpy(), b)


def test_sor_runs_the_plain_smoother():
    """``omega != 1`` is no kernel (as in the JAX wrapper): the wrapper
    returns ``ops/smoothers.red_black_gauss_seidel`` exactly."""
    u, b, _, h = _inputs(128, None)
    got = cs.red_black_gauss_seidel(*_t(u, b), ALPHA, h, sweeps=2, omega=1.2)
    want = sm.red_black_gauss_seidel(*_t(u, b), ALPHA, h, sweeps=2,
                                     omega=1.2)
    assert torch.equal(got, want)


@pytest.mark.parametrize("call", [
    lambda t: cs.poisson_residual(t, t, ALPHA, 0.1),
    lambda t: cs.red_black_gauss_seidel(t, t, ALPHA, 0.1),
    lambda t: cs.ff_poisson_residual(t, t, t, t, t, ALPHA, 0.1),
    lambda t: cs.poisson_apply(t, ALPHA, 0.1),
    lambda t: cs.jacobi(t, t, ALPHA, 0.1, omega=0.8),
    lambda t: cs.restrict_fw_padded_fast(t, (7, 7)),
    lambda t: cs.prolong_add_padded_fast(t[:4, :4], t),
])
def test_f64_off_the_cpu_is_refused(call):
    """f64 tensors off the CPU (a meta tensor stands in for a CUDA one, so
    this runs without a card) are refused before any launch, naming the
    ROADMAP item."""
    t = torch.empty((8, 8), dtype=torch.float64, device="meta")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        call(t)
