"""Poisson model problems: built-in test functions and RHS assembly.

Port of ``multigrid_prj_tpu/models/poisson.py``.  The three ``(f, g)`` pairs
match the reference's table:
    test 0: ``f = 1``, ``g = 0``
    test 1: ``f = -5 e^x e^{-2y}``, ``g = e^x e^{-2y}``
    test 2: ``f = -30 (cos(30 r)/r - 30 sin(30 r))`` (0 at ``r = 0``),
            ``g = sin(30 r)``, ``r = sqrt(x^2 + y^2)``
Out-of-range indices fall back to test 0 with a warning.  ``f`` is sampled
at interior nodes, ``g`` at boundary nodes, with ``coord(i, j) = (j h,
L - i h)``.  Tensors are made on the given ``device`` (the card unless the
caller names another) in the given ``dtype``.  ``poisson_fd_csr`` builds the
5-point FD matrix of the AMG path on the host, ``banded_csr`` the banded
matrix of the SpMV / SpMM benchmarks.
"""

from __future__ import annotations

import warnings
from typing import Callable, Sequence

import torch

from multigrid_prj_tpu_torch.grids import GridLevel
from multigrid_prj_tpu_torch.ops.stencil import boundary_mask


def _t0_f(x, y):
    return torch.ones_like(x)


def _t0_g(x, y):
    return torch.zeros_like(x)


def _t1_f(x, y):
    return -5.0 * torch.exp(x) * torch.exp(-2.0 * y)


def _t1_g(x, y):
    return torch.exp(x) * torch.exp(-2.0 * y)


def _t2_f(x, y):
    r = torch.sqrt(x * x + y * y)
    safe_r = torch.where(r == 0.0, torch.ones_like(r), r)
    val = -30.0 * (torch.cos(30.0 * r) / safe_r - 30.0 * torch.sin(30.0 * r))
    return torch.where(r == 0.0, torch.zeros_like(r), val)


def _t2_g(x, y):
    return torch.sin(30.0 * torch.sqrt(x * x + y * y))


TEST_FUNCTIONS: dict[int, tuple[Callable, Callable]] = {
    0: (_t0_f, _t0_g),
    1: (_t1_f, _t1_g),
    2: (_t2_f, _t2_g),
}


def get_test_functions(i: int) -> tuple[Callable, Callable]:
    """Select ``(f, g)`` with the reference's fallback to test 0."""
    if i not in TEST_FUNCTIONS:
        warnings.warn("Invalid test case index. Default test case selected.")
        return TEST_FUNCTIONS[0]
    return TEST_FUNCTIONS[i]


def grid_coords(shape: Sequence[int], length: float,
                dtype=torch.float32, device="cuda"):
    """Node coordinates: 2D ``x[i, j] = j h``, ``y[i, j] = L - i h``; 3D
    adds ``z[k] = L - k h`` on the leading axis."""
    shape = tuple(int(s) for s in shape)
    h = length / (shape[0] - 1)

    def iota(ax):
        view = [1] * len(shape)
        view[ax] = shape[ax]
        idx = torch.arange(shape[ax], device=device).to(dtype).view(view)
        return idx.expand(shape)

    if len(shape) == 2:
        return iota(1) * h, length - iota(0) * h
    if len(shape) == 3:
        return iota(2) * h, length - iota(1) * h, length - iota(0) * h
    raise ValueError(f"unsupported rank {len(shape)}")


def assemble_rhs(level: GridLevel, length: float, test: int = 1,
                 f: Callable | None = None, g: Callable | None = None,
                 dtype=torch.float32, device="cuda") -> torch.Tensor:
    """Sample ``f`` on interior nodes and ``g`` on boundary nodes of the
    LOGICAL grid.  Custom ``f``/``g`` callables override the registry."""
    if f is None or g is None:
        rf, rg = get_test_functions(test)
        f = f or rf
        g = g or rg
    coords = grid_coords(level.shape, length, dtype=dtype, device=device)
    bmask = boundary_mask(level.shape, device=device)
    return torch.where(bmask, g(*coords), f(*coords)).to(dtype).contiguous()


def poisson_fd_csr(nx: int, ny: int | None = None):
    """5-point FD Laplacian on the ``nx x ny`` interior-node grid as a
    :class:`~multigrid_prj_tpu_torch.ops.sparse.HostCSR` (Dirichlet
    eliminated): the algebraic test system of the AMG path at sizes where
    no mesh file exists.  Host NumPy; the same CSR (indptr, indices, data)
    as the JAX package's, built without its sort: each row's entries are
    laid out directly in column order (``i - ny``, ``i - 1``, ``i``,
    ``i + 1``, ``i + ny``)."""
    import numpy as np

    from multigrid_prj_tpu_torch.ops.sparse import HostCSR

    ny = nx if ny is None else ny
    n = nx * ny
    idx = np.arange(n, dtype=np.int64)
    ix, iy = idx // ny, idx % ny
    # candidate neighbours in ascending column order, with their validity
    cand = np.stack([idx - ny, idx - 1, idx, idx + 1, idx + ny], axis=1)
    valid = np.stack([ix > 0, iy > 0, np.ones(n, dtype=bool), iy < ny - 1,
                      ix < nx - 1], axis=1)
    vals = np.where(cand == idx[:, None], 4.0, -1.0)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(valid.sum(axis=1), out=indptr[1:])
    return HostCSR(indptr=indptr, indices=cand[valid], data=vals[valid],
                   shape=(n, n))


def banded_csr(n: int, half_band: int = 3, extra: int = 2):
    """The banded test matrix of the SpMV / SpMM benchmarks
    (``benchmarks/spmv_bench.py``): 8 on the diagonal, -1 on the offsets
    -1, 1, -17 * half_band and half_band * (i + 2) for ``i < extra``, so
    K = 4 + extra.  Host NumPy, the same CSR as the benchmark's."""
    import numpy as np

    from multigrid_prj_tpu_torch.ops.sparse import HostCSR

    offs = [0, -1, 1, -half_band * 17] + [half_band * (i + 2)
                                          for i in range(extra)]
    rows_l, cols_l, vals_l = [], [], []
    for o in offs:
        r = np.arange(max(0, -o), min(n, n - o), dtype=np.int64)
        rows_l.append(r)
        cols_l.append(r + o)
        vals_l.append(np.full(r.size, 8.0 if o == 0 else -1.0))
    return HostCSR.from_coo(np.concatenate(rows_l), np.concatenate(cols_l),
                            np.concatenate(vals_l), (n, n))
