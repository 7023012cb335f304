"""Sparse-matrix containers: host-side CSR for the setup phase, device-side
ELL/COO in torch for the solve phase (port of
``multigrid_prj_tpu/ops/sparse.py``).

``HostCSR`` and ``rap`` are host NumPy, copied from the JAX package with
the native hooks pointing at this package's ``native.py`` (the same
library), so both packages build identical hierarchies.  ``ELLMatrix`` is
the gather form of the JAX ``ELLMatrix`` on a torch device: rows padded to
``K`` slots, padding slots at column 0 with value 0, ``y = sum_k vals[:, k]
* x[cols[:, k]]``.  It is the plain path of the AMG solve (levels under
``pallas_min_rows``, dtypes other than f32, ``use_pallas=False``); the hand
kernel for the hot path is ``ops/cuda_spmv.CudaELL``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


def to_device(x, dtype=None, device="cuda") -> torch.Tensor:
    """Host array -> tensor on ``device`` (numpy casts to ``dtype`` first;
    ``dtype`` is a torch dtype)."""
    a = np.ascontiguousarray(np.asarray(x))
    if not a.flags.writeable:  # torch.from_numpy wants writable memory
        a = a.copy()
    return torch.from_numpy(a).to(device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# Host-side CSR (NumPy) — setup phase
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HostCSR:
    """Compressed-sparse-row matrix on the host (NumPy arrays)."""

    indptr: np.ndarray  # (n + 1,) int64
    indices: np.ndarray  # (nnz,) int64, column ids
    data: np.ndarray  # (nnz,) float64
    shape: Tuple[int, int]

    # -- construction -------------------------------------------------------

    @staticmethod
    def from_coo(rows, cols, vals, shape, sum_duplicates: bool = True) -> "HostCSR":
        """Build CSR from triplets, accumulating duplicates (the reference's
        CSR assembly scatter-add, ``CSRMatrix.cpp:55-64``) and dropping
        explicit zeros (its ``copy_from`` compression skips zeros,
        ``:3-22``)."""
        rows = np.asarray(rows, dtype=np.int64).reshape(-1)
        cols = np.asarray(cols, dtype=np.int64).reshape(-1)
        vals = np.asarray(vals, dtype=np.float64).reshape(-1)
        n, m = int(shape[0]), int(shape[1])
        if sum_duplicates and rows.size:
            from multigrid_prj_tpu_torch import native

            if native.available():
                res = native.coo_to_csr(rows, cols, vals, n)
                if res is not None:
                    indptr, indices, data = res
                    return HostCSR(indptr=indptr, indices=indices, data=data,
                                   shape=(n, m))
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        if sum_duplicates and rows.size:
            key_change = np.empty(rows.size, dtype=bool)
            key_change[0] = True
            key_change[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
            group_starts = np.flatnonzero(key_change)
            vals = np.add.reduceat(vals, group_starts)
            rows = rows[group_starts]
            cols = cols[group_starts]
        keep = vals != 0.0
        rows, cols, vals = rows[keep], cols[keep], vals[keep]
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(indptr, rows + 1, 1)
        np.cumsum(indptr, out=indptr)
        return HostCSR(indptr=indptr, indices=cols, data=vals, shape=(n, m))

    @staticmethod
    def from_dense(A: np.ndarray) -> "HostCSR":
        rows, cols = np.nonzero(A)
        return HostCSR.from_coo(rows, cols, A[rows, cols], A.shape)

    @staticmethod
    def eye(n: int) -> "HostCSR":
        idx = np.arange(n, dtype=np.int64)
        return HostCSR(
            indptr=np.arange(n + 1, dtype=np.int64),
            indices=idx,
            data=np.ones(n),
            shape=(n, n),
        )

    # -- basic queries -------------------------------------------------------

    @property
    def nnz(self) -> int:
        return int(self.data.size)

    @property
    def row_lengths(self) -> np.ndarray:
        return np.diff(self.indptr)

    def row(self, i: int):
        """(cols, vals) of row ``i`` — the reference's ``nonZerosInRow``
        (``CSRMatrix.cpp:42-52``) without the copy-out loop."""
        lo, hi = self.indptr[i], self.indptr[i + 1]
        return self.indices[lo:hi], self.data[lo:hi]

    def coeff(self, i: int, j: int) -> float:
        """Scalar probe (``CSRMatrix::coeff`` linear row scan, ``:24-40``)."""
        cols, vals = self.row(i)
        hit = np.flatnonzero(cols == j)
        return float(vals[hit[0]]) if hit.size else 0.0

    def diagonal(self) -> np.ndarray:
        n = min(self.shape)
        d = np.zeros(n)
        rows = np.repeat(np.arange(self.shape[0]), self.row_lengths)
        on_diag = rows == self.indices
        d_rows = rows[on_diag]
        d[d_rows[d_rows < n]] = self.data[on_diag][d_rows < n]
        return d

    def to_dense(self) -> np.ndarray:
        A = np.zeros(self.shape)
        rows = np.repeat(np.arange(self.shape[0]), self.row_lengths)
        A[rows, self.indices] = self.data
        return A

    def to_coo(self):
        rows = np.repeat(np.arange(self.shape[0], dtype=np.int64), self.row_lengths)
        return rows, self.indices.copy(), self.data.copy()

    # -- host linear algebra -------------------------------------------------

    def spmv(self, x: np.ndarray) -> np.ndarray:
        """Host SpMV (oracle / setup use)."""
        x = np.asarray(x).reshape(-1)
        prods = self.data * x[self.indices]
        out = np.zeros(self.shape[0])
        # segment sum over rows
        np.add.at(out, np.repeat(np.arange(self.shape[0]), self.row_lengths), prods)
        return out

    def spmm(self, X: np.ndarray) -> np.ndarray:
        """Host sparse x dense-block product ``Y = A @ X`` (oracle for the
        device SpMM paths; ``X`` is ``(m, nvec)``)."""
        X = np.asarray(X)
        prods = self.data[:, None] * X[self.indices, :]
        out = np.zeros((self.shape[0], X.shape[1]))
        np.add.at(out, np.repeat(np.arange(self.shape[0]), self.row_lengths), prods)
        return out

    def permute(self, perm: np.ndarray) -> "HostCSR":
        """Symmetric permutation ``A[perm][:, perm]`` (RCM reordering etc.)."""
        perm = np.asarray(perm, dtype=np.int64)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(perm.size)
        rows, cols, vals = self.to_coo()
        return HostCSR.from_coo(inv[rows], inv[cols], vals, self.shape)

    def rcm_permutation(self) -> np.ndarray:
        """Reverse Cuthill-McKee ordering (native lib when built) — reduces
        bandwidth so ELL row neighborhoods stay local on device."""
        from multigrid_prj_tpu_torch import native

        n = self.shape[0]
        perm = native.rcm(self.indptr, self.indices, n) if native.available() else None
        if perm is not None:
            return perm
        # Python fallback: BFS from min-degree nodes, neighbors by degree.
        deg = self.row_lengths
        visited = np.zeros(n, dtype=bool)
        order = []
        while len(order) < n:
            start = int(np.argmin(np.where(visited, np.iinfo(np.int64).max, deg)))
            queue = [start]
            visited[start] = True
            while queue:
                u = queue.pop(0)
                order.append(u)
                nbrs = [int(v) for v in self.row(u)[0] if not visited[v]]
                for v in sorted(nbrs, key=lambda x: deg[x]):
                    if not visited[v]:
                        visited[v] = True
                        queue.append(v)
        return np.asarray(order[::-1], dtype=np.int64)

    def transpose(self) -> "HostCSR":
        from multigrid_prj_tpu_torch import native

        n, m = self.shape
        if native.available() and self.nnz:
            res = native.csr_transpose(self.indptr, self.indices, self.data,
                                       n, m)
            if res is not None:
                indptr, indices, data = res
                return HostCSR(indptr=indptr, indices=indices, data=data,
                               shape=(m, n))
        rows, cols, vals = self.to_coo()
        return HostCSR.from_coo(cols, rows, vals, (self.shape[1], self.shape[0]),
                                sum_duplicates=False)

    def matmul(self, other: "HostCSR") -> "HostCSR":
        """SpGEMM ``C = self @ other``: native Gustavson (``mgtpu_spgemm``)
        when the runtime library is built, else the vectorised expansion.

        Expansion form: each nonzero ``a_ik`` expands into row ``k`` of
        ``other``; the expanded triplets are coalesced by :func:`from_coo`.
        Both paths add contributions in the same order (identical sparsity
        structure; values agree to the last ulp — reduceat sums segments
        pairwise).  Replaces the reference's two dense-index-probing
        passes (``AMG.hpp:314-362``).
        """
        A, B = self, other
        if A.shape[1] != B.shape[0]:
            raise ValueError(f"shape mismatch {A.shape} @ {B.shape}")
        from multigrid_prj_tpu_torch import native

        if native.available() and A.nnz and B.nnz:
            res = native.spgemm(A.indptr, A.indices, A.data,
                                B.indptr, B.indices, B.data,
                                A.shape[0], B.shape[1])
            if res is not None:
                indptr, indices, data = res
                return HostCSR(indptr=indptr, indices=indices, data=data,
                               shape=(A.shape[0], B.shape[1]))
        a_rows = np.repeat(np.arange(A.shape[0], dtype=np.int64), A.row_lengths)
        k = A.indices
        counts = B.indptr[k + 1] - B.indptr[k]  # expansion size per A-entry
        total = int(counts.sum())
        if total == 0:
            return HostCSR.from_coo([], [], [], (A.shape[0], B.shape[1]))
        # flat gather offsets into B for every expanded product
        starts = B.indptr[k]
        offset = np.arange(total, dtype=np.int64) - np.repeat(
            np.cumsum(counts) - counts, counts
        )
        gather = np.repeat(starts, counts) + offset
        c_rows = np.repeat(a_rows, counts)
        c_cols = B.indices[gather]
        c_vals = np.repeat(A.data, counts) * B.data[gather]
        return HostCSR.from_coo(c_rows, c_cols, c_vals, (A.shape[0], B.shape[1]))

    def __matmul__(self, other):
        if isinstance(other, HostCSR):
            return self.matmul(other)
        return self.spmv(other)


def rap(P: HostCSR, A: HostCSR) -> HostCSR:
    """Galerkin triple product ``Ac = P^T A P`` (``AMG.hpp:303-369``)."""
    return P.transpose().matmul(A).matmul(P)


# ---------------------------------------------------------------------------
# Device-side ELL — solve phase
# ---------------------------------------------------------------------------


def _ell_slots(csr: HostCSR, k: int):
    """Row-padded ``(n, k)`` column ids (int64) and values (f64) of ``csr``
    with padding slots at column 0, value 0."""
    n, _ = csr.shape
    lengths = csr.row_lengths
    cols = np.zeros((n, k), dtype=np.int64)
    vals = np.zeros((n, k), dtype=np.float64)
    rows = np.repeat(np.arange(n), lengths)
    slot = np.arange(csr.nnz, dtype=np.int64) - np.repeat(csr.indptr[:-1],
                                                          lengths)
    cols[rows, slot] = csr.indices
    vals[rows, slot] = csr.data
    return cols, vals


@dataclasses.dataclass
class ELLMatrix:
    """Row-padded sparse matrix on a torch device.

    ``cols[i, k]`` / ``vals[i, k]`` hold the k-th nonzero of row i; padding
    slots have ``cols = 0, vals = 0`` so the padded gather-multiply is exact.
    """

    cols: torch.Tensor  # (n, K) int32
    vals: torch.Tensor  # (n, K)
    shape: Tuple[int, int]

    @property
    def k(self) -> int:
        return self.cols.shape[1]

    @property
    def nnz_dense(self) -> int:
        """Stored slots including padding (the streamed footprint)."""
        return self.cols.numel()

    @staticmethod
    def from_host_csr(csr: HostCSR, k: int | None = None,
                      dtype=torch.float32, device="cuda") -> "ELLMatrix":
        n, m = csr.shape
        lengths = csr.row_lengths
        kmax = int(lengths.max()) if n else 0
        if k is None:
            k = kmax
        if kmax > k:
            raise ValueError(f"rows have up to {kmax} nonzeros > K={k}")
        cols, vals = _ell_slots(csr, k)
        return ELLMatrix(cols=to_device(cols, torch.int32, device),
                         vals=to_device(vals, dtype, device), shape=(n, m))

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        """``y = A x`` as gather + row reduction."""
        return (self.vals * x[self.cols]).sum(dim=1)

    def spmm(self, X: torch.Tensor) -> torch.Tensor:
        """Block product ``Y = A @ X`` for ``X`` of shape ``(m, nvec)``: one
        gather of ``X`` rows serves every right-hand side."""
        return (self.vals[:, :, None] * X[self.cols]).sum(dim=1)

    def to_host_csr(self) -> HostCSR:
        cols = self.cols.cpu().numpy()
        vals = self.vals.cpu().to(torch.float64).numpy()
        n, _ = self.shape
        rows = np.repeat(np.arange(n, dtype=np.int64), self.k).reshape(n,
                                                                       self.k)
        keep = vals != 0.0
        return HostCSR.from_coo(rows[keep], cols[keep], vals[keep], self.shape)


def coo_spmv(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
             x: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Device COO SpMV: products scattered into their rows (the JAX
    ``segment_sum``)."""
    prods = vals * x[cols]
    return torch.zeros(num_rows, dtype=prods.dtype,
                       device=prods.device).index_add_(0, rows, prods)
