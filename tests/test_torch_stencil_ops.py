"""Plain torch ops of ``multigrid_prj_tpu_torch.ops`` (stencil, residual,
smoothers, transfer, extended) vs their JAX counterparts on the CPU, in f64
and f32, including padded buffers with a ``logical_shape``.

Inputs are made with a seeded numpy generator and handed to both sides.
Where an op has no multiply feeding an add, the results are asserted equal.
Otherwise XLA's CPU backend may contract the pair into one FMA (one rounding
fewer than torch's separate ops), so the bound is a few units of the dtype's
epsilon times the field's largest value (``_assert_close``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multigrid_prj_tpu.ops import extended as jext
from multigrid_prj_tpu.ops import residual as jres
from multigrid_prj_tpu.ops import smoothers as jsm
from multigrid_prj_tpu.ops import stencil as jst
from multigrid_prj_tpu.ops import transfer as jtr
from multigrid_prj_tpu_torch.ops import extended as text
from multigrid_prj_tpu_torch.ops import residual as tres
from multigrid_prj_tpu_torch.ops import smoothers as tsm
from multigrid_prj_tpu_torch.ops import stencil as tst
from multigrid_prj_tpu_torch.ops import transfer as ttr

torch.set_num_threads(1)

ALPHA = 10.0
DTYPES = [np.float64, np.float32]
# (physical shape, logical shape or None)
SHAPES = [((33, 33), None), ((64, 64), (49, 49)), ((24, 40), (17, 33)),
          ((9, 9, 9), None)]
SHAPES_2D = SHAPES[:3]


def _rand(shape, dtype, seed=0, n=1):
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal(shape).astype(dtype) for _ in range(n)]
    return out if n > 1 else out[0]


def _h(shape, logical):
    return 10.0 / ((logical or shape)[0] - 1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_close(got, want, ulps=4):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    bound = ulps * np.finfo(want.dtype).eps * max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= bound, (np.abs(got - want).max(), bound)


def _assert_equal(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# stencil + residual
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,logical", SHAPES)
def test_boundary_mask(shape, logical):
    _assert_equal(tst.boundary_mask(shape, logical),
                  jst.boundary_mask(shape, logical))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,logical", SHAPES)
def test_neighbor_sum(dtype, shape, logical):
    u = _rand(shape, dtype)
    _assert_equal(tst.neighbor_sum(_t(u)), jst.neighbor_sum(jnp.asarray(u)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,logical", SHAPES)
def test_poisson_apply_and_residual(dtype, shape, logical):
    u, b = _rand(shape, dtype, n=2)
    h = _h(shape, logical)
    _assert_close(tst.poisson_apply(_t(u), ALPHA, h, logical),
                  jst.poisson_apply(jnp.asarray(u), ALPHA, h, logical))
    _assert_close(tst.poisson_residual(_t(u), _t(b), ALPHA, h, logical),
                  jst.poisson_residual(jnp.asarray(u), jnp.asarray(b), ALPHA, h,
                                       logical))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,logical", SHAPES_2D)
def test_norms(dtype, shape, logical):
    """Sums run in another order than XLA's: relative bound of a few
    hundred epsilon."""
    u, b = _rand(shape, dtype, n=2)
    h = _h(shape, logical)
    rtol = 200 * np.finfo(dtype).eps
    np.testing.assert_allclose(float(tres.norm2(_t(u))),
                               float(jres.norm2(jnp.asarray(u))), rtol=rtol)
    np.testing.assert_allclose(
        float(tres.rel_residual_norm(_t(u), _t(b), ALPHA, h, logical)),
        float(jres.rel_residual_norm(jnp.asarray(u), jnp.asarray(b), ALPHA, h,
                                     logical)), rtol=rtol)


# ---------------------------------------------------------------------------
# smoothers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,logical", SHAPES_2D)
@pytest.mark.parametrize("omega", [1.0, 1.3])
def test_red_black_gauss_seidel(dtype, shape, logical, omega):
    u, b = _rand(shape, dtype, n=2)
    h = _h(shape, logical)
    got = tsm.red_black_gauss_seidel(_t(u), _t(b), ALPHA, h, sweeps=3,
                                     omega=omega, logical_shape=logical)
    want = jsm.red_black_gauss_seidel(jnp.asarray(u), jnp.asarray(b), ALPHA, h,
                                      sweeps=3, omega=omega,
                                      logical_shape=logical)
    _assert_close(got, want, ulps=16)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("omega", [1.0, 0.8])
def test_jacobi(dtype, omega):
    shape, logical = SHAPES_2D[1]
    u, b = _rand(shape, dtype, n=2)
    h = _h(shape, logical)
    got = tsm.jacobi(_t(u), _t(b), ALPHA, h, omega=omega, sweeps=3,
                     logical_shape=logical)
    want = jsm.jacobi(jnp.asarray(u), jnp.asarray(b), ALPHA, h, omega=omega,
                      sweeps=3, logical_shape=logical)
    _assert_close(got, want, ulps=16)


def test_make_smoother_names():
    u, b = _rand((17, 17), np.float64, n=2)
    for name in ("gs", "rbgs", "jacobi"):
        got = tsm.make_smoother(name)(_t(u), _t(b), ALPHA, 0.5, 2)
        want = jsm.make_smoother(name)(jnp.asarray(u), jnp.asarray(b), ALPHA,
                                       0.5, 2)
        _assert_close(got, want, ulps=16)
    with pytest.raises(ValueError):
        tsm.make_smoother("sor")


# ---------------------------------------------------------------------------
# transfer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(33, 33), (32, 32), (9, 9, 9)])
def test_restrictions_exact_layout(dtype, shape):
    r = _rand(shape, dtype)
    _assert_equal(ttr.restrict_inject(_t(r)), jtr.restrict_inject(jnp.asarray(r)))
    _assert_close(ttr.restrict_full_weighting(_t(r)),
                  jtr.restrict_full_weighting(jnp.asarray(r)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("coarse,fine", [((17, 17), (33, 33)),
                                          ((16, 16), (32, 32)),
                                          ((5, 5, 5), (9, 9, 9))])
def test_prolong(dtype, coarse, fine):
    e = _rand(coarse, dtype)
    _assert_equal(ttr.prolong(_t(e), fine), jtr.prolong(jnp.asarray(e), fine))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,logical", [((64, 64), (49, 49)),
                                           ((256, 256), (129, 129)),
                                           ((24, 40), (17, 33))])
def test_padded_transfers(dtype, shape, logical):
    r = _rand(shape, dtype)
    rc = ttr.restrict_fw_padded(_t(r), logical)
    _assert_close(rc, jtr.restrict_fw_padded(jnp.asarray(r), logical))
    ec = _rand(tuple(s // 2 for s in shape), dtype, seed=1)
    _assert_equal(ttr.prolong_padded(_t(ec)), jtr.prolong_padded(jnp.asarray(ec)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_pad_and_crop(dtype):
    a = _rand((17, 17), dtype)
    padded = ttr.pad_to(_t(a), (32, 32))
    _assert_equal(padded, jtr.pad_to(jnp.asarray(a), (32, 32)))
    _assert_equal(ttr.crop_to(padded, (17, 17)), a)
    assert ttr.crop_to(padded, (17, 17)).is_contiguous()
    with pytest.raises(ValueError):
        ttr.pad_to(_t(a), (16, 16))


# ---------------------------------------------------------------------------
# extended (float-float)
# ---------------------------------------------------------------------------


def _pairs(shape=(64, 64), seed=3):
    rng = np.random.default_rng(seed)
    big = rng.standard_normal((2,) + shape).astype(np.float32)
    small = (1e-8 * rng.standard_normal((2,) + shape)).astype(np.float32)
    return big[0], small[0], big[1], small[1]


@pytest.mark.parametrize("fn", ["two_sum", "fast_two_sum", "ff_add_f",
                                "ff_accumulate"])
def test_ff_scalar_chains_exact(fn):
    """Additions only: each result is the same rounding on both sides."""
    xh, xl, yh, _ = _pairs()
    args = {"two_sum": (xh, yh), "fast_two_sum": (xh, xl),
            "ff_add_f": (xh, xl, yh), "ff_accumulate": (xh, xl, yh)}[fn]
    got = getattr(text, fn)(*(_t(a) for a in args))
    want = getattr(jext, fn)(*(jnp.asarray(a) for a in args))
    for g, w in zip(got, want):
        _assert_equal(g, w)


def test_ff_add_exact_and_error_free():
    xh, xl, yh, yl = _pairs()
    got = text.ff_add(*(_t(a) for a in (xh, xl, yh, yl)))
    want = jext.ff_add(*(jnp.asarray(a) for a in (xh, xl, yh, yl)))
    for g, w in zip(got, want):
        _assert_equal(g, w)
    # the pair carries the exact sum to a few eps_f32^2 of the operands
    exact = (xh.astype(np.float64) + xl + yh + yl)
    pair = got[0].numpy().astype(np.float64) + got[1].numpy()
    scale = np.abs(xh).astype(np.float64) + np.abs(yh)
    assert np.all(np.abs(pair - exact) <= 16 * 2.0 ** -46 * scale)


def test_ff_from_div():
    """torch divides; XLA multiplies by a reciprocal and contracts the
    remainder into an FMA.  Both pairs stand for b / c within the pair's
    f32 remainder error (a few eps_f32 relative)."""
    b = _rand((64, 64), np.float32)
    c = ALPHA / (10.0 / 63) ** 2
    hi, lo = text.ff_from_div(_t(b), c)
    jhi, jlo = jext.ff_from_div(jnp.asarray(b), c)
    got = hi.numpy().astype(np.float64) + lo.numpy()
    want = np.asarray(jhi, np.float64) + np.asarray(jlo)
    np.testing.assert_allclose(got, want, rtol=4 * np.finfo(np.float32).eps)
    np.testing.assert_allclose(hi.numpy(), np.asarray(jhi),
                               rtol=np.finfo(np.float32).eps)


@pytest.mark.parametrize("shape,logical", [((64, 64), (49, 49)),
                                           ((33, 33), None), ((9, 9, 9), None)])
def test_ff_poisson_residual(shape, logical):
    """Same pair d on both sides; the two-sum chains are exact and the final
    ``c*t_hi + c*t_lo`` may be one FMA under XLA: <= 2 ulp."""
    u, b = _rand(shape, np.float32, n=2)
    u_lo = (1e-8 * _rand(shape, np.float32, seed=5)).astype(np.float32)
    h = _h(shape, logical)
    d_hi, d_lo = (np.asarray(x) for x in
                  jext.ff_from_div(jnp.asarray(b), ALPHA / (h * h)))
    args = (u, u_lo, d_hi, d_lo, b)
    got = text.ff_poisson_residual(*(_t(a) for a in args), ALPHA, h, logical)
    want = jext.ff_poisson_residual(*(jnp.asarray(a) for a in args), ALPHA, h,
                                    logical)
    want = np.asarray(want)
    gi = got.numpy().view(np.int32).astype(np.int64)
    wi = want.view(np.int32).astype(np.int64)
    same_sign = np.sign(got.numpy()) == np.sign(want)
    assert np.all(same_sign | (got.numpy() == want))
    assert np.max(np.abs(gi - wi)) <= 2
