"""3D kernel twins of ``multigrid_prj_tpu_torch.ops.cuda_stencil_3d`` vs the
JAX package: the Pallas 3D functions in interpret mode (as
tests/test_pallas_stencil_3d.py runs them) at an aligned shape, and the XLA
ops at unaligned shapes; the ``cuda_stencil`` entry points' 3D dispatch on
CPU tensors; the refusals.  The CUDA kernels are held to these twins in
tests/test_torch_cuda.py.

Bounds: XLA's CPU backend contracts ``6u - nb`` and ``b / c + nb`` into
FMAs and sums the XLA neighbours in another order, so twin and JAX differ
by a rounding at some points.  Each result is held to a few ulp of its
largest value (pointwise ulp counts are meaningless where ``6u - nb``
cancels): the smoothers to 2 ulp (measured 0.125-0.625), apply and residual
to 4 ulp (measured 1-2).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from multigrid_prj_tpu.ops import pallas_stencil_3d as p3
from multigrid_prj_tpu.ops import smoothers as jsm
from multigrid_prj_tpu.ops import stencil as jst
from multigrid_prj_tpu_torch.ops import cuda_stencil as cs
from multigrid_prj_tpu_torch.ops import cuda_stencil_3d as c3
from multigrid_prj_tpu_torch.ops import smoothers as sm
from multigrid_prj_tpu_torch.ops import stencil as tst
from multigrid_prj_tpu_torch.ops.stencil import boundary_mask

torch.set_num_threads(1)

ALPHA = 10.0
ALIGNED = (16, 16, 128)  # (nz, ny, nx): the JAX wrappers take their kernels
LOGICAL = (14, 13, 120)
# unaligned: JAX runs XLA ops; the second catches swapped axes
UNALIGNED = [((17, 17, 17), None), ((20, 24, 136), (17, 21, 129))]


def _inputs(shape, logical, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal(shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    h = 10.0 / ((logical or shape)[0] - 1)
    return u, b, h


def _close(got, want, ulps):
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    bound = ulps * np.spacing(np.abs(want).max())
    assert np.abs(got - want).max() <= bound, \
        np.abs(got - want).max() / np.spacing(np.abs(want).max())


def _twins(u, b, h, logical, omega):
    tu, tb = torch.from_numpy(u), torch.from_numpy(b)
    return dict(
        apply=c3.poisson_apply_3d(tu, ALPHA, h, logical).numpy(),
        residual=c3.poisson_residual_3d(tu, tb, ALPHA, h, logical).numpy(),
        rbgs=c3.red_black_gauss_seidel_3d(tu, tb, ALPHA, h, sweeps=2,
                                          logical_shape=logical).numpy(),
        jacobi=c3.jacobi_3d(tu, tb, ALPHA, h, omega=omega, sweeps=3,
                            logical_shape=logical).numpy())


def _jax(mod_apply, mod_residual, mod_rbgs, mod_jacobi, u, b, h, logical,
         omega):
    U, B = jnp.asarray(u), jnp.asarray(b)
    return dict(
        apply=mod_apply(U, ALPHA, h, logical),
        residual=mod_residual(U, B, ALPHA, h, logical),
        rbgs=mod_rbgs(U, B, ALPHA, h, sweeps=2, logical_shape=logical),
        jacobi=mod_jacobi(U, B, ALPHA, h, omega=omega, sweeps=3,
                          logical_shape=logical))


BOUNDS = dict(apply=4, residual=4, rbgs=2, jacobi=2)


@pytest.mark.parametrize("logical", [None, LOGICAL])
@pytest.mark.parametrize("omega", [1.0, 0.8])
def test_twins_match_pallas_3d(logical, omega):
    u, b, h = _inputs(ALIGNED, logical)
    assert p3._is_supported3d(ALIGNED, jnp.float32)  # the kernels, not XLA
    with pltpu.force_tpu_interpret_mode():
        want = _jax(p3.poisson_apply_3d, p3.poisson_residual_3d,
                    p3.red_black_gauss_seidel_3d, p3.jacobi_3d, u, b, h,
                    logical, omega)
    got = _twins(u, b, h, logical, omega)
    for name, bound in BOUNDS.items():
        _close(got[name], want[name], bound)
    # boundary and dead zone are pinned to b exactly by the smoothers
    bnd = boundary_mask(ALIGNED, logical).numpy()
    for name in ("rbgs", "jacobi"):
        np.testing.assert_array_equal(got[name][bnd], b[bnd])


@pytest.mark.parametrize("logical", [None, LOGICAL])
@pytest.mark.parametrize("omega", [1.0, 0.8])
@pytest.mark.parametrize("sweeps", [1, 2, 5])
def test_jacobi_sweep_counts_match_pallas_3d(logical, omega, sweeps):
    """The Jacobi twin at 1, 2 and 5 sweeps (the fused march's groups: one
    launch of 1 or 2, and 4 + 1) against JAX's ``jacobi_3d``, one Pallas
    pass per sweep in interpret mode, beside the 3 sweeps above: within the
    smoothers' 2 ulp of the largest value; boundary and dead zone pinned to
    b exactly."""
    u, b, h = _inputs(ALIGNED, logical, seed=sweeps)
    with pltpu.force_tpu_interpret_mode():
        want = p3.jacobi_3d(jnp.asarray(u), jnp.asarray(b), ALPHA, h,
                            omega=omega, sweeps=sweeps,
                            logical_shape=logical)
    got = c3.jacobi_3d(torch.from_numpy(u), torch.from_numpy(b), ALPHA, h,
                       omega=omega, sweeps=sweeps,
                       logical_shape=logical).numpy()
    _close(got, want, BOUNDS["jacobi"])
    bnd = boundary_mask(ALIGNED, logical).numpy()
    np.testing.assert_array_equal(got[bnd], b[bnd])


@pytest.mark.parametrize("logical", [None, LOGICAL])
@pytest.mark.parametrize("sweeps", [2, 5])
def test_rbgs_sweep_counts_match_pallas_3d(logical, sweeps):
    """The smoother's twin at 2 sweeps (one z-marching launch on the card)
    and 5 (two: 4 + 1) against the Pallas kernel in interpret mode, within
    the smoothers' 2 ulp of the largest value; boundary and dead zone
    pinned to b exactly."""
    u, b, h = _inputs(ALIGNED, logical, seed=4)
    with pltpu.force_tpu_interpret_mode():
        want = p3.red_black_gauss_seidel_3d(
            jnp.asarray(u), jnp.asarray(b), ALPHA, h, sweeps=sweeps,
            logical_shape=logical)
    got = c3.red_black_gauss_seidel_3d(
        torch.from_numpy(u), torch.from_numpy(b), ALPHA, h, sweeps=sweeps,
        logical_shape=logical).numpy()
    _close(got, want, BOUNDS["rbgs"])
    bnd = boundary_mask(ALIGNED, logical).numpy()
    np.testing.assert_array_equal(got[bnd], b[bnd])


@pytest.mark.parametrize("shape,logical", UNALIGNED)
@pytest.mark.parametrize("omega", [1.0, 0.8])
def test_twins_match_xla_3d(shape, logical, omega):
    """Unaligned shapes (config 4's exact layout): the JAX wrappers run the
    XLA ops there, and the port its twins."""
    u, b, h = _inputs(shape, logical, seed=1)
    assert not p3._is_supported3d(shape, jnp.float32)
    want = _jax(jst.poisson_apply, jst.poisson_residual,
                jsm.red_black_gauss_seidel, jsm.jacobi, u, b, h, logical,
                omega)
    got = _twins(u, b, h, logical, omega)
    for name, bound in BOUNDS.items():
        _close(got[name], want[name], bound)


@pytest.mark.parametrize("shape,logical", [(ALIGNED, LOGICAL)] + UNALIGNED)
def test_cuda_stencil_dispatches_3d(shape, logical):
    """The 2D module's entry points send 3D tensors to the 3D twins on the
    CPU (before this dispatch they rolled only two axes with the 2D
    weights), and launch nothing there."""
    u, b, h = _inputs(shape, logical, seed=2)
    tu, tb = torch.from_numpy(u), torch.from_numpy(b)
    cs.reset_launch_counts()
    pairs = [
        (cs.poisson_apply(tu, ALPHA, h, logical),
         c3.poisson_apply_3d_plain(tu, ALPHA, h, logical)),
        (cs.poisson_residual(tu, tb, ALPHA, h, logical),
         c3.poisson_residual_3d_plain(tu, tb, ALPHA, h, logical)),
        (cs.red_black_gauss_seidel(tu, tb, ALPHA, h, sweeps=2,
                                   logical_shape=logical),
         c3.red_black_gauss_seidel_3d_plain(tu, tb, ALPHA, h, 2, logical)),
        (cs.jacobi(tu, tb, ALPHA, h, omega=0.8, sweeps=2,
                   logical_shape=logical),
         c3.jacobi_3d_plain(tu, tb, ALPHA, h, 0.8, 2, logical)),
    ]
    for got, want in pairs:
        assert torch.equal(got, want)
    # and the 3D twins are the 7-point operator: the plain apply agrees
    _close(pairs[0][0].numpy(), tst.poisson_apply(tu, ALPHA, h, logical), 4)
    assert all(v == 0 for v in cs.LAUNCHES.values())
    np.testing.assert_array_equal(tu.numpy(), u)


def test_sor_3d_runs_the_plain_smoother():
    """``omega != 1`` is no kernel (as in the JAX 3D wrapper): the wrapper
    returns ``ops/smoothers.red_black_gauss_seidel`` exactly."""
    u, b, h = _inputs((17, 17, 17), None, seed=3)
    tu, tb = torch.from_numpy(u), torch.from_numpy(b)
    want = sm.red_black_gauss_seidel(tu, tb, ALPHA, h, sweeps=2, omega=1.2)
    for fn in (cs.red_black_gauss_seidel, c3.red_black_gauss_seidel_3d):
        assert torch.equal(fn(tu, tb, ALPHA, h, sweeps=2, omega=1.2), want)


@pytest.mark.parametrize("call", [
    lambda t: c3.poisson_apply_3d(t, ALPHA, 0.1),
    lambda t: c3.poisson_residual_3d(t, t, ALPHA, 0.1),
    lambda t: c3.red_black_gauss_seidel_3d(t, t, ALPHA, 0.1),
    lambda t: c3.jacobi_3d(t, t, ALPHA, 0.1, omega=0.8),
    lambda t: cs.poisson_residual(t, t, ALPHA, 0.1),
])
def test_3d_f64_off_the_cpu_is_refused(call):
    """f64 off the CPU (a meta tensor stands in for a CUDA one, so this runs
    without a card) is refused before any launch, naming the ROADMAP
    item."""
    t = torch.empty((8, 8, 8), dtype=torch.float64, device="meta")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        call(t)


@pytest.mark.parametrize("call", [
    lambda t: cs.ff_poisson_residual(t, t, t, t, t, ALPHA, 0.1),
    lambda t: cs.restrict_fw_padded_fast(t, (7, 7, 7)),
    lambda t: cs.prolong_add_padded_fast(t[:4, :4, :4], t),
])
def test_2d_only_kernels_refuse_3d_off_the_cpu(call):
    """The transfer and float-float residual kernels are 2D (the JAX
    package has none for 3D either): an f32 3D tensor off the CPU is
    refused, with no fallback inside the wrapper."""
    t = torch.empty((8, 8, 8), dtype=torch.float32, device="meta")
    with pytest.raises(NotImplementedError, match="2D"):
        call(t)


@pytest.mark.parametrize("bad", [
    lambda t: (t, t[:, :, :7]),                 # shapes differ
    lambda t: (t, t.transpose(0, 2)),           # not contiguous
    lambda t: (t[0], t[0]),                     # 2D operands
])
def test_3d_wrappers_check_operands(bad):
    t = torch.empty((8, 8, 8), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError):
        c3._check_cuda3d("poisson_residual_3d", *bad(t))


def test_logical_shape_is_checked():
    with pytest.raises(ValueError):
        c3._logical3d((8, 8, 8), (9, 8, 8))
    with pytest.raises(ValueError):
        c3._logical3d((8, 8, 8), (8, 8))
    assert c3._logical3d((8, 8, 16), None) == (8, 8, 16)
