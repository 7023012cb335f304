"""Stationary smoothers (port of ``multigrid_prj_tpu/ops/smoothers.py``).

Red-black Gauss-Seidel and damped Jacobi in the XLA operation order of the
JAX package (``neighbor_sum`` order, ``b / c``).  Both force Dirichlet rows
to ``u = b``.  The kernel-order RB-GS (``b * (1/c) + N + S + E + W``) and its
CUDA kernel are in ``ops/cuda_stencil.py``.
"""

from __future__ import annotations

import torch

from multigrid_prj_tpu_torch.ops.stencil import boundary_mask, neighbor_sum


def _parity(shape, device) -> torch.Tensor:
    """``sum(indices) % 2`` per node (the red/black colour)."""
    parity = None
    for ax, n in enumerate(shape):
        view = [1] * len(shape)
        view[ax] = n
        idx = torch.arange(n, device=device).view(view)
        parity = idx if parity is None else parity + idx
    return parity % 2


def jacobi(u: torch.Tensor, b: torch.Tensor, alpha: float, h: float,
           omega: float = 1.0, sweeps: int = 1,
           logical_shape=None) -> torch.Tensor:
    """``sweeps`` damped-Jacobi sweeps on ``A u = b``.

    Interior: ``u <- (1-omega) u + omega (b/c + sum(neigh)) / (2*ndim)``;
    boundary rows: ``u <- b``.
    """
    c = alpha / (h * h)
    denom = 2.0 * u.ndim
    bmask = boundary_mask(u.shape, logical_shape, u.device)
    b_over_c = b / c
    for _ in range(sweeps):
        u_new = (b_over_c + neighbor_sum(u)) / denom
        if omega != 1.0:
            u_new = (1.0 - omega) * u + omega * u_new
        u = torch.where(bmask, b, u_new)
    return u


def red_black_gauss_seidel(u: torch.Tensor, b: torch.Tensor, alpha: float,
                           h: float, sweeps: int = 1, omega: float = 1.0,
                           logical_shape=None) -> torch.Tensor:
    """``sweeps`` red-black Gauss-Seidel sweeps on ``A u = b`` (colour 0
    first); ``omega != 1`` gives red-black SOR."""
    c = alpha / (h * h)
    denom = 2.0 * u.ndim
    bmask = boundary_mask(u.shape, logical_shape, u.device)
    parity = _parity(u.shape, u.device)
    b_over_c = b / c
    for _ in range(sweeps):
        for color in (0, 1):
            u_new = (b_over_c + neighbor_sum(u)) / denom
            if omega != 1.0:
                u_new = (1.0 - omega) * u + omega * u_new
            upd = (parity == color) & ~bmask
            u = torch.where(upd, u_new, u)
            u = torch.where(bmask, b, u)
    return u


def make_smoother(name: str, **kw):
    """Smoother factory: ``f(u, b, alpha, h, sweeps, logical_shape) -> u``.

    Names mirror the reference's ``-smt`` choices.
    """
    name = name.lower()
    omega = kw.get("omega", 1.0)
    if name in ("gs", "gauss_seidel", "rbgs", "red_black"):
        def f(u, b, alpha, h, sweeps=1, logical_shape=None):
            return red_black_gauss_seidel(u, b, alpha, h, sweeps=sweeps,
                                          omega=omega,
                                          logical_shape=logical_shape)

        return f
    if name == "jacobi":
        def f(u, b, alpha, h, sweeps=1, logical_shape=None):
            return jacobi(u, b, alpha, h, omega=omega, sweeps=sweeps,
                          logical_shape=logical_shape)

        return f
    raise ValueError(f"unknown smoother {name!r}")
