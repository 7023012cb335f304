"""Plain reference for the P1 configurations: linear finite elements with
vertex quadrature on the structured triangulation of ``[0, L]^2``,
assembled and solved in plain torch, float64.

The mesh has ``n x n`` nodes; node (r, c) lies at ``(c h, r h)``, ``h = L
/ (n - 1)``, and each square with lower-left node (r, c) holds the
triangles (r, c) (r, c + 1) (r + 1, c) and (r, c + 1) (r + 1, c) (r + 1,
c + 1).  The harness's nodal grid ``b`` (node (i, j) at ``x = j h``, ``y =
L - i h``) is that mesh with its rows reversed, ``r = n - 1 - i``: ``b``
holds ``f`` at interior nodes and ``g`` at boundary nodes.

:func:`solve` assembles the stiffness ``K_e = alpha |T| grad phi_i . grad
phi_j`` of every triangle into one sparse matrix (rows in a padded gather
layout, so it applies in any dtype), the lumped load ``w_i f_i`` (``w_i``
the sum of ``|T| / 3`` over the triangles at node i) and the lifting ``-A
g`` of the boundary values, and solves the interior system by conjugate
gradients to a relative residual below ``1e-13``.  CG is preconditioned by
a symmetric textbook V-cycle on the grid: ``poisson_mg``'s red-black
Gauss-Seidel, full weighting and linear interpolation on rediscretised
5-point operators, whose finest operator equals the P1 stiffness on this
mesh (``alpha (4 u - neighbours)``; the diagonal couplings are 0).  It
returns the nodal field (``g`` on the boundary) on the harness's grid.
Nothing here comes from the program.

:func:`defect_correction` runs the V-cycle as an outer iteration on the
same assembled system in a lower precision: the control that the
comparison has to reject.
"""

from __future__ import annotations

import torch

from portbench import registry

mg = registry.load_module("reference", "poisson_mg")

F64 = torch.float64
_SYSTEMS: dict = {}  # (n, length, alpha, device) -> System, one per process


class System:
    """The assembled P1 system on ``n x n`` nodes of ``[0, length]^2``."""

    def __init__(self, n: int, length: float, alpha: float, device):
        h = float(length) / (n - 1)
        idx = torch.arange(n * n, device=device)
        r, c = idx // n, idx % n
        xy = torch.stack([c.to(F64) * h, r.to(F64) * h], dim=1)
        cell = torch.arange(n - 1, device=device)
        a = (cell[:, None] * n + cell[None, :]).reshape(-1)
        tris = torch.cat([torch.stack([a, a + 1, a + n], dim=1),
                          torch.stack([a + 1, a + n, a + n + 1], dim=1)])
        p = xy[tris]  # (M, 3, 2)
        x, y = p[..., 0], p[..., 1]
        twice_area = ((x[:, 1] - x[:, 0]) * (y[:, 2] - y[:, 0])
                      - (x[:, 2] - x[:, 0]) * (y[:, 1] - y[:, 0]))
        # grad phi_i = (y_j - y_k, x_k - x_j) / (2 |T|), (i, j, k) cyclic
        gx = (y.roll(-1, dims=1) - y.roll(-2, dims=1)) / twice_area[:, None]
        gy = (x.roll(-2, dims=1) - x.roll(-1, dims=1)) / twice_area[:, None]
        area = 0.5 * twice_area.abs()
        K = alpha * area[:, None, None] * (gx[:, :, None] * gx[:, None, :]
                                           + gy[:, :, None] * gy[:, None, :])
        rows = tris[:, :, None].expand(K.shape).reshape(-1)
        cols = tris[:, None, :].expand(K.shape).reshape(-1)
        A = torch.sparse_coo_tensor(torch.stack([rows, cols]), K.reshape(-1),
                                    (n * n, n * n),
                                    check_invariants=True).coalesce()
        (rows, cols), vals = A.indices(), A.values()
        counts = torch.bincount(rows, minlength=n * n)
        start = torch.cumsum(counts, 0) - counts
        slot = torch.arange(rows.numel(), device=device) - start[rows]
        width = int(counts.max())
        self.cols = idx[:, None].repeat(1, width)  # padding: the row itself
        self.vals = torch.zeros((n * n, width), dtype=F64, device=device)
        self.cols[rows, slot] = cols
        self.vals[rows, slot] = vals
        self.weights = torch.zeros(n * n, dtype=F64, device=device)
        self.weights.index_add_(
            0, tris.reshape(-1), (area / 3.0).repeat_interleave(3))
        self.interior = (r > 0) & (r < n - 1) & (c > 0) & (c < n - 1)
        self.n = n
        self.hier = mg.Hierarchy((n, n), alpha * h * h, length, device)

    def matvec(self, u):
        """``A u`` with every node's row, in ``u``'s dtype."""
        return (self.vals.to(u.dtype) * u[self.cols]).sum(dim=1)

    def apply(self, u):
        """``A_II u`` on the interior; 0 on the boundary (``u`` 0 there)."""
        return torch.where(self.interior, self.matvec(u),
                           torch.zeros((), dtype=u.dtype, device=u.device))

    def rhs_and_lift(self, b):
        """From the harness's grid ``b``: the interior right-hand side
        ``w_I f_I - A_IB g_B`` (0 on the boundary) and ``g`` on the
        boundary (0 inside), both nodal, float64."""
        nodal = b.to(F64).flip(0).reshape(-1)
        zero = torch.zeros((), dtype=F64, device=b.device)
        g = torch.where(self.interior, zero, nodal)
        rhs = self.weights * nodal - self.matvec(g)
        return torch.where(self.interior, rhs, zero), g

    def precondition(self, r):
        """One symmetric V-cycle on ``A_II e = r`` (nodal vectors)."""
        n = self.n
        e = _vcycle(torch.zeros((n, n), dtype=r.dtype, device=r.device),
                    r.view(n, n), self.hier)
        return e.reshape(-1)

    def grid(self, u, g):
        """The nodal field ``u`` inside and ``g`` on the boundary, on the
        harness's grid."""
        return torch.where(self.interior, u, g).view(self.n, self.n).flip(0)


def _vcycle(u, f, hier, level=0):
    """V(2, 2) on the interior of ``u`` (its boundary stays 0), the post
    sweeps in the pre sweeps' reverse colour order, so that the cycle is a
    symmetric operator."""
    c, colours = hier.c[level], hier.colours[level]
    if level == len(hier.shapes) - 1:  # one interior node: exact
        mg.smooth(u, f, c, 1, colours)
        return u
    mg.smooth(u, f, c, 2, colours)
    rc = mg.restrict(mg.residual(u, f, c))
    u += mg.prolong(_vcycle(torch.zeros_like(rc), rc, hier, level + 1))
    mg.smooth(u, f, c, 2, colours[::-1])
    return u


def system(n: int, length: float, alpha: float, device) -> System:
    """The assembled system, built once per process for its arguments."""
    key = (int(n), float(length), float(alpha), str(device))
    if key not in _SYSTEMS:
        _SYSTEMS[key] = System(int(n), float(length), float(alpha), device)
    return _SYSTEMS[key]


def _pcg(sys_, b, x, tol, maxit):
    """Preconditioned CG on ``A_II x = b`` from ``x`` until the recursive
    residual falls below ``tol ||b||``; returns ``x``."""
    bnorm = float(torch.linalg.vector_norm(b))
    r = b - sys_.apply(x)
    z = sys_.precondition(r)
    p = z.clone()
    rz = torch.dot(r, z)
    for _ in range(maxit):
        if float(torch.linalg.vector_norm(r)) <= tol * bnorm:
            break
        q = sys_.apply(p)
        step = rz / torch.dot(p, q)
        x = x + step * p
        r = r - step * q
        z = sys_.precondition(r)
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
    return x


def solve(b, alpha, length, tol=1e-13, maxit=200, restarts=3):
    """The float64 nodal solution for the harness's grid ``b``.  CG is
    restarted from the true residual until that is below ``tol ||b||``;
    raises if it is not after ``restarts`` restarts."""
    sys_ = system(b.shape[0], length, alpha, b.device)
    rhs, g = sys_.rhs_and_lift(b)
    x = torch.zeros_like(rhs)
    bnorm = float(torch.linalg.vector_norm(rhs))
    for _ in range(restarts + 1):
        x = _pcg(sys_, rhs, x, tol, maxit)
        rel = float(torch.linalg.vector_norm(rhs - sys_.apply(x))) / bnorm
        if rel <= tol:
            return sys_.grid(x, g)
    raise RuntimeError(f"the reference CG reached a relative residual of "
                       f"{rel:.3e}, not {tol:.0e}")


def defect_correction(b, alpha, length, dtype, tol, maxit):
    """The control: ``u += cycle(b - A u)`` with the residual and the cycle
    in ``dtype`` on the same assembled system, to ``||b - A u|| <= tol
    ||b||`` or ``maxit`` iterations.  Returns ``(u, iterations, last
    relative residual)``, ``u`` the nodal field on the harness's grid."""
    sys_ = system(b.shape[0], length, alpha, b.device)
    rhs, g = sys_.rhs_and_lift(b)
    rhs = rhs.to(dtype)
    bnorm = float(torch.linalg.vector_norm(rhs.float()))
    u = torch.zeros_like(rhs)
    k = 0
    while True:
        r = rhs - sys_.apply(u)
        rel = float(torch.linalg.vector_norm(r.float())) / bnorm
        if rel <= tol or k == maxit:
            return sys_.grid(u, g.to(dtype)), k, rel
        u = u + sys_.precondition(r)
        k += 1
