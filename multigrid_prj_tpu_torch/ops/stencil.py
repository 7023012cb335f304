"""Matrix-free Poisson stencil operator (5-point in 2D, 7-point in 3D).

Port of ``multigrid_prj_tpu/ops/stencil.py`` in the same operation order:

* boundary rows are Dirichlet identity rows,
* interior diagonal is ``2 * ndim * alpha / h^2``,
* interior off-diagonals are ``-alpha / h^2`` for the axis neighbours.

These are the plain (XLA-order) versions.  They run on any device; the
hand-written CUDA kernels and their twins live in ``ops/cuda_stencil.py``.
"""

from __future__ import annotations

import torch


def boundary_mask(shape, logical_shape=None, device=None) -> torch.Tensor:
    """Boolean mask of Dirichlet boundary nodes (any index 0 or n-1).

    ``logical_shape``: for a padded buffer the live grid occupies
    ``[0, logical)`` per axis; indices at or beyond ``logical - 1`` are
    boundary, which pins the dead zone to identity rows.
    """
    shape = tuple(int(s) for s in shape)
    logical = tuple(logical_shape) if logical_shape is not None else shape
    m = None
    for ax, n in enumerate(shape):
        idx = torch.arange(n, device=device)
        edge = (idx == 0) | (idx >= int(logical[ax]) - 1)
        view = [1] * len(shape)
        view[ax] = n
        edge = edge.view(view)
        m = edge if m is None else (m | edge)
    return m.expand(shape)


def interior_mask(shape) -> torch.Tensor:
    """Boolean mask of the interior nodes (``~boundary_mask``)."""
    return ~boundary_mask(shape)


def shift_fill_zero(u: torch.Tensor, axis: int, offset: int) -> torch.Tensor:
    """``u`` shifted by ``offset`` along ``axis``; vacated entries are zero.

    ``offset=+1`` returns the value of the neighbour at ``index+1``.
    """
    if offset not in (+1, -1):
        raise ValueError(f"offset must be +-1, got {offset}")
    n = u.shape[axis]
    out = torch.zeros_like(u)
    if offset == +1:
        out.narrow(axis, 0, n - 1).copy_(u.narrow(axis, 1, n - 1))
    else:
        out.narrow(axis, 1, n - 1).copy_(u.narrow(axis, 0, n - 1))
    return out


def neighbor_sum(u: torch.Tensor) -> torch.Tensor:
    """Sum of the 2*ndim axis neighbours, zero beyond the grid edge."""
    total = None
    for ax in range(u.ndim):
        t = shift_fill_zero(u, ax, +1) + shift_fill_zero(u, ax, -1)
        total = t if total is None else total + t
    return total


def poisson_diag(ndim: int, alpha: float, h: float) -> float:
    """Interior diagonal ``2 * ndim * alpha / h^2``."""
    return 2.0 * ndim * alpha / (h * h)


def poisson_apply(u: torch.Tensor, alpha: float, h: float,
                  logical_shape=None) -> torch.Tensor:
    """``y = A u``: identity at boundary rows,
    ``(alpha / h^2) * (2 * ndim * u - sum(neighbours))`` inside."""
    c = alpha / (h * h)
    interior = c * (2.0 * u.ndim * u - neighbor_sum(u))
    return torch.where(boundary_mask(u.shape, logical_shape, u.device),
                       u, interior)


def poisson_residual(u: torch.Tensor, b: torch.Tensor, alpha: float, h: float,
                     logical_shape=None) -> torch.Tensor:
    """``r = b - A u`` including boundary rows (``r = b - u`` there)."""
    return b - poisson_apply(u, alpha, h, logical_shape)


# The JAX package jit-compiles ``poisson_apply`` under this name; torch runs
# eagerly, so here it is the same function.
poisson_apply_jit = poisson_apply
