"""Float-float ("ff32") extended precision for large-grid residuals.

Port of ``multigrid_prj_tpu/ops/extended.py``.  The solution is carried as
an unevaluated pair ``u = hi + lo`` and the residual is computed in the
scaled form ``r = c * ((b/c) - (4 u - sum(neighbours)))`` so every
extended-precision operation is an addition (two-sum).  A plain-f32 solve
floors at ``eps_f32 * kappa(A)`` (about 1e-4 at 129^2); the pair residual
lets the f32 cycle reach 1e-8.

Each line below is a separate torch op, so each result is rounded on its
own and nothing is contracted into an FMA (the two-sum chains are wrong if
any add is contracted).
"""

from __future__ import annotations

import torch

from multigrid_prj_tpu_torch.ops.stencil import boundary_mask, shift_fill_zero


def two_sum(a, b):
    """Knuth exact addition: returns (s, err) with a + b == s + err."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def fast_two_sum(a, b):
    """Dekker exact addition, valid when |a| >= |b|."""
    s = a + b
    err = b - (s - a)
    return s, err


def ff_add(x_hi, x_lo, y_hi, y_lo):
    """Pair + pair -> normalized pair."""
    s, e = two_sum(x_hi, y_hi)
    e = e + (x_lo + y_lo)
    return fast_two_sum(s, e)


def ff_add_f(x_hi, x_lo, y):
    """Pair + float -> normalized pair."""
    s, e = two_sum(x_hi, y)
    e = e + x_lo
    return fast_two_sum(s, e)


def ff_neg(x_hi, x_lo):
    """Negated pair."""
    return -x_hi, -x_lo


def ff_from_div(b: torch.Tensor, c: float):
    """Pair representation of ``b / c`` (refined with one Newton remainder).

    ``c`` becomes a 0-dim tensor on ``b``'s device: torch divides a CUDA
    tensor by a Python scalar as a multiply by the rounded reciprocal, but
    by a tensor as a true division, which is what the CPU does for both.
    """
    ct = torch.full((), c, dtype=b.dtype, device=b.device)
    hi = b / ct
    lo = (b - hi * ct) / ct
    return hi, lo


def ff_poisson_residual(u_hi, u_lo, d_hi, d_lo, b, alpha: float, h: float,
                        logical_shape=None):
    """Extended-precision ``r = b - A u`` for the Poisson stencil.

    ``d_hi, d_lo``: pair for ``b / c`` (from :func:`ff_from_div`).  Neighbour
    pairs are accumulated axis by axis, ``+1`` before ``-1``.
    """
    c = alpha / (h * h)
    ndim = u_hi.ndim
    if ndim == 2:
        acc_hi, acc_lo = 4.0 * u_hi, 4.0 * u_lo
    else:
        acc_hi, acc_lo = ff_add(4.0 * u_hi, 4.0 * u_lo, 2.0 * u_hi, 2.0 * u_lo)
    for ax in range(ndim):
        for off in (+1, -1):
            nb_hi = shift_fill_zero(u_hi, ax, off)
            nb_lo = shift_fill_zero(u_lo, ax, off)
            acc_hi, acc_lo = ff_add(acc_hi, acc_lo, -nb_hi, -nb_lo)
    t_hi, t_lo = ff_add(d_hi, d_lo, -acc_hi, -acc_lo)
    r_interior = c * t_hi + c * t_lo
    r_boundary = (b - u_hi) - u_lo
    bm = boundary_mask(u_hi.shape, logical_shape, u_hi.device)
    return torch.where(bm, r_boundary, r_interior)


def ff_accumulate(u_hi, u_lo, e):
    """(u_hi, u_lo) += e, renormalized."""
    return ff_add_f(u_hi, u_lo, e)


def ff_update_residual(u_hi, u_lo, e, d_hi, d_lo, b, alpha: float, h: float,
                       logical_shape=None, out=None):
    """A refined solve's step from a correction ``e``: the pair update
    (:func:`ff_accumulate`, at every point) and the extended residual of the
    updated pair (:func:`ff_poisson_residual`).  Returns ``(u_hi, u_lo,
    r)``; the twin of the kernels that fuse the two.  ``out``, the kernels'
    output buffers, is accepted and ignored: the result is new tensors."""
    u_hi, u_lo = ff_accumulate(u_hi, u_lo, e)
    return u_hi, u_lo, ff_poisson_residual(u_hi, u_lo, d_hi, d_lo, b, alpha,
                                           h, logical_shape)
