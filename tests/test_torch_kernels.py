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
@pytest.mark.parametrize("sweeps", [1, 2, 4, 5])
def test_rbgs_twin_matches_pallas(n, logical, sweeps):
    """Same op order as the fused Pallas kernel, but XLA's CPU backend
    contracts ``b * (1/c) + N`` into one FMA in interpret mode, so a point
    can differ by one rounding that the sweeps then carry: bound the
    difference by 2 ulp of the field's largest value."""
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


def test_cpu_wrappers_do_not_launch_or_mutate():
    u, b, u_lo, h = _inputs(128, None)
    ut, bt = _t(u, b)
    cs.reset_launch_counts()
    cs.red_black_gauss_seidel(ut, bt, ALPHA, h, sweeps=2)
    cs.poisson_residual(ut, bt, ALPHA, h)
    assert all(v == 0 for v in cs.LAUNCHES.values())
    np.testing.assert_array_equal(ut.numpy(), u)
