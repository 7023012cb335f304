"""Plain reference for the Dirichlet Poisson configurations: the discrete
system ``A u = b`` solved by textbook multigrid in plain torch.

``A`` is the ``(2 d + 1)``-point stencil on an ``n^d`` node grid of
spacing ``h = L / (n - 1)``: boundary rows are identity rows (``u = b``),
interior rows are ``(alpha / h^2) (2 d u - sum of the 2 d axis
neighbours) = b``.  :func:`solve` returns that system's solution in
float64, to a change of under ``1e-13`` of ``||u||`` per cycle, from the
same ``b`` the program is given.  It shares nothing with the program: its
cycle is V(2, 2) with lexicographic red-black Gauss-Seidel, full weighting
and linear interpolation down to a ``3^d`` grid, on rediscretised coarse
operators, with no padding, no kernels and no float-float pairs.

:func:`defect_correction` runs the same cycle as an outer iteration in a
lower precision (the plain residual ``b - A u`` and the cycle both in
``dtype``): the control that the comparison has to reject.
"""

from __future__ import annotations

import torch


def _inner(d):
    return (slice(1, -1),) * d


def _along(x, ax, start, stop, step=1):
    idx = [slice(None)] * x.ndim
    idx[ax] = slice(start, stop, step)
    return x[tuple(idx)]


def neighbour_sum(u):
    """Sum of the 2 d axis neighbours at each interior node."""
    total = None
    for ax in range(u.ndim):
        for lo in (0, 2):
            idx = [slice(1, -1)] * u.ndim
            idx[ax] = slice(lo, u.shape[ax] - 2 + lo)
            t = u[tuple(idx)]
            total = t if total is None else total + t
    return total


def apply(u, c):
    """``A u`` with ``c = alpha / h^2``: identity on the boundary."""
    y = u.clone()
    inner = _inner(u.ndim)
    y[inner] = c * (2 * u.ndim * u[inner] - neighbour_sum(u))
    return y


def residual(u, b, c):
    """``b - A u`` (``b - u`` on the boundary)."""
    return b - apply(u, c)


def _set_boundary(u, f):
    for ax in range(u.ndim):
        for i in (0, u.shape[ax] - 1):
            u.select(ax, i).copy_(f.select(ax, i))


def _colours(shape, device):
    """Boolean masks of the interior nodes whose index sum is even / odd."""
    total = None
    for ax, n in enumerate(shape):
        view = [1] * len(shape)
        view[ax] = n - 2
        idx = torch.arange(1, n - 1, device=device).view(view)
        total = idx if total is None else total + idx
    even = (total % 2 == 0).expand(tuple(n - 2 for n in shape))
    return even, ~even


def smooth(u, f, c, sweeps, colours):
    """``sweeps`` red-black Gauss-Seidel sweeps on the interior of ``u``."""
    inner = _inner(u.ndim)
    f_over_c = f[inner] / c
    for _ in range(sweeps):
        for mask in colours:
            gs = (f_over_c + neighbour_sum(u)) / (2 * u.ndim)
            u[inner] = torch.where(mask, gs, u[inner])


def restrict(r):
    """Full weighting onto the stride-2 grid; zero on its boundary."""
    x = r
    for ax in range(r.ndim):
        n = x.shape[ax]
        nc = (n + 1) // 2
        shape = list(x.shape)
        shape[ax] = nc
        y = x.new_zeros(shape)
        _along(y, ax, 1, nc - 1).copy_(
            0.25 * _along(x, ax, 1, n - 3, 2) + 0.5 * _along(x, ax, 2, n - 2, 2)
            + 0.25 * _along(x, ax, 3, n - 1, 2))
        x = y
    return x


def prolong(e):
    """Linear interpolation from the stride-2 grid."""
    x = e
    for ax in range(e.ndim):
        nc = x.shape[ax]
        shape = list(x.shape)
        shape[ax] = 2 * nc - 1
        y = x.new_empty(shape)
        _along(y, ax, 0, None, 2).copy_(x)
        _along(y, ax, 1, None, 2).copy_(
            0.5 * (_along(x, ax, 0, nc - 1) + _along(x, ax, 1, nc)))
        x = y
    return x


class Hierarchy:
    """Grids from ``shape`` (``2^k + 1`` per axis) down to ``3^d``, with
    each level's ``c = alpha / h^2`` and colour masks."""

    def __init__(self, shape, alpha, length, device):
        shape = tuple(int(n) for n in shape)
        if any(n < 3 or (n - 1) & (n - 2) for n in shape) or len(set(shape)) != 1:
            raise ValueError(f"the reference takes cubes of 2^k + 1 nodes, "
                             f"got {shape}")
        h = float(length) / (shape[0] - 1)
        self.shapes, self.c, self.colours = [], [], []
        while True:
            self.shapes.append(shape)
            self.c.append(float(alpha) / (h * h))
            self.colours.append(_colours(shape, device))
            if shape[0] == 3:
                break
            shape = tuple((n + 1) // 2 for n in shape)
            h *= 2.0


def vcycle(u, f, hier, level=0):
    """One V(2, 2) cycle on ``A u = f`` at ``level``, in place; the
    boundary of ``u`` is set to ``f``'s."""
    c, colours = hier.c[level], hier.colours[level]
    _set_boundary(u, f)
    if level == len(hier.shapes) - 1:
        smooth(u, f, c, 2, colours)
        return u
    smooth(u, f, c, 2, colours)
    r = residual(u, f, c)
    _set_boundary(r, torch.zeros_like(r))
    rc = restrict(r)
    ec = vcycle(torch.zeros_like(rc), rc, hier, level + 1)
    u += prolong(ec)
    smooth(u, f, c, 2, colours)
    return u


def solve(b, alpha, length, max_cycles=80, change_tol=1e-13):
    """The float64 solution of ``A u = b``.  Raises if the cycles have not
    settled to ``change_tol`` of ``||u||`` within ``max_cycles``."""
    b = b.to(torch.float64)
    hier = Hierarchy(b.shape, alpha, length, b.device)
    u = torch.zeros_like(b)
    for _ in range(max_cycles):
        prev = u.clone()
        vcycle(u, b, hier)
        change = float(torch.linalg.vector_norm(u - prev)
                       / torch.linalg.vector_norm(u))
        if change <= change_tol:
            return u
    raise RuntimeError(f"the reference multigrid did not settle: last change "
                       f"{change:.3e} of ||u|| after {max_cycles} cycles")


def defect_correction(b, alpha, length, dtype, tol, maxit):
    """The control: ``u += cycle(b - A u)`` with the residual and the cycle
    in ``dtype``, to ``||b - A u|| <= tol ||b||`` or ``maxit`` iterations.
    Returns ``(u, iterations, last relative residual)``."""
    b = b.to(dtype)
    hier = Hierarchy(b.shape, alpha, length, b.device)
    bnorm = float(torch.linalg.vector_norm(b.float()))
    u = torch.zeros_like(b)
    k = 0
    while True:
        r = residual(u, b, hier.c[0])
        rel = float(torch.linalg.vector_norm(r.float())) / bnorm
        if rel <= tol or k == maxit:
            return u, k, rel
        u = u + vcycle(torch.zeros_like(r), r, hier)
        k += 1
