"""Multi-rank algebraic multigrid: block-row sharded ELL levels with banded
halo exchange (port of ``multigrid_prj_tpu/parallel/sharded_amg.py`` on
``torch.distributed``).

* The solver RCM-reorders the system (``HostCSR.rcm_permutation``), so every
  level's matrix is banded and a block-row partition needs only a narrow
  band of remote ``x`` entries from each neighbour rank.
* Each level's operator and its P / P^T transfers become a
  :class:`ShardedELL`: rows partitioned over the ranks of a
  :class:`~.distributed.Mesh`, column ids relative to the owner's input
  block minus its halo, so the local apply reads
  ``cat(left_halo, x_local, right_halo)``.  The halo width of each operator
  is measured at set-up from its band; a level whose band reaches past one
  neighbour block, or whose blocks fall below ``min_rows_per_shard`` rows,
  and every level below it run replicated after an ``all_gather``.
* Halos move by one :meth:`Mesh.post_halo` per apply (edge ranks receive
  zeros); norms are ``all_reduce`` sums, so every rank takes the same loop
  decisions.  The loop reads the reduced residual norm once per iteration:
  the one host sync of a cycle.
* Smoothing is Chebyshev or damped Jacobi (SpMV based, as in the JAX
  package; multicolour GS stays a single-device feature).
* The kernel route (``use_pallas``, float32 only): each sharded level's
  local applies run ``ops/cuda_spmv.ell_local_spmv`` on the rank's block in
  the kernels' slot-major layout (:class:`CudaShardedELL`): the CUDA ELL
  SpMV kernel on the card, its twin on a CPU tensor.  Otherwise the gather
  apply runs (plain torch ops).  The replicated tail runs the plain gather
  ELL on every device, as the JAX tail runs XLA's gather on a TPU, and its
  bottom a dense LU solve.

Padding: a sharded level is padded to ``P * rows_per_shard`` rows; padded
rows have no entries (zero rows of A, P and P^T), ``inv_diag`` 1 and
``b`` 0, so they stay 0.  On the kernel route every real row sums its slots
in CSR order whatever the partition and padding adds exact zeros, so ``x``
after k cycles is bit-equal across world sizes; only the reduced norms
round differently, and they only decide when to stop.

Every division by a Python float is a true division by a 0-dim tensor
(``amg._div``), so the card and the CPU twin divide alike.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from multigrid_prj_tpu_torch.amg import (
    HIST_CAP,
    THETA_DEFAULT,
    AMGSolveResult,
    _div,
    _estimate_lmax,
    build_prolongation,
    coarsen_greedy,
    coarsen_pmis,
    smooth_prolongation,
)
from multigrid_prj_tpu_torch.ops.cuda_spmv import ell_local_spmv
from multigrid_prj_tpu_torch.ops.sparse import (
    ELLMatrix,
    HostCSR,
    rap,
    to_device,
)
from multigrid_prj_tpu_torch.parallel.distributed import Mesh
from multigrid_prj_tpu_torch.utils.config import on_cuda_flag
from multigrid_prj_tpu_torch.utils.guards import check_finite

AXIS = "x"


# ---------------------------------------------------------------------------
# Sharded ELL operator
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ShardedELL:
    """Row-partitioned ELL operator with a banded halo contract.

    ``cols_rel[r, k]`` indexes ``cat(left_halo, x_local, right_halo)`` of
    row ``r``'s owner rank; ``halo`` is the band width in input rows past the
    owner's block on either side.  :func:`build_sharded_ell` returns the full
    padded arrays on the host; :meth:`block` one rank's rows on its device.
    """

    vals: torch.Tensor  # (out_n_pad, K), or (out_rows, K) for one block
    cols_rel: torch.Tensor  # int32, same shape
    halo: int
    in_rows: int
    out_rows: int

    def block(self, index: int, device) -> "ShardedELL":
        """Rank ``index``'s rows, contiguous on ``device``."""
        rows = slice(index * self.out_rows, (index + 1) * self.out_rows)
        return ShardedELL(
            vals=self.vals[rows].contiguous().to(device),
            cols_rel=self.cols_rel[rows].contiguous().to(device),
            halo=self.halo, in_rows=self.in_rows, out_rows=self.out_rows)


def build_sharded_ell(csr: HostCSR, out_n_pad: int, in_n_pad: int, p: int,
                      dtype=torch.float32) -> Optional[ShardedELL]:
    """Partition ``csr`` rows over ``p`` shards; ``None`` if any row needs
    columns beyond the immediate neighbours (single-hop halo contract).
    Padding slots and padded rows point at the owner's block start, with
    value 0."""
    n, m = csr.shape
    out_rows = out_n_pad // p
    in_rows = in_n_pad // p
    lengths = csr.row_lengths
    k = max(1, int(lengths.max()) if n else 1)
    cols = np.zeros((out_n_pad, k), dtype=np.int64)
    vals = np.zeros((out_n_pad, k), dtype=np.float64)
    rows = np.repeat(np.arange(n), lengths)
    slot = np.arange(csr.nnz, dtype=np.int64) - np.repeat(csr.indptr[:-1],
                                                          lengths)
    cols[rows, slot] = csr.indices
    vals[rows, slot] = csr.data
    own_start = (np.arange(out_n_pad) // out_rows) * in_rows
    pad_mask = np.ones((out_n_pad, k), dtype=bool)
    pad_mask[rows, slot] = False
    cols = np.where(pad_mask, own_start[:, None], cols)
    lo = cols.min(axis=1)
    hi = cols.max(axis=1)
    halo = int(max(
        (own_start - lo).max(initial=0),
        (hi - (own_start + in_rows) + 1).max(initial=0),
        0,
    ))
    if halo > in_rows:
        return None
    rel = cols - (own_start - halo)[:, None]
    assert rel.min() >= 0 and rel.max() < in_rows + 2 * halo
    return ShardedELL(vals=torch.from_numpy(vals).to(dtype),
                      cols_rel=torch.from_numpy(rel.astype(np.int32)),
                      halo=halo, in_rows=in_rows, out_rows=out_rows)


def _exchange_halos(m: ShardedELL, x_local: torch.Tensor,
                    mesh: Mesh) -> torch.Tensor:
    """``cat(left_halo, x_local, right_halo)`` from one ``halo``-row
    exchange with the neighbour ranks (zeros beyond the global ends); no
    exchange when the operator's halo is 0."""
    if not m.halo:
        return x_local
    left, right = mesh.post_halo(x_local, w=m.halo).wait()
    return torch.cat([left, x_local, right])


def sharded_ell_apply(m: ShardedELL, x_local: torch.Tensor,
                      mesh: Mesh) -> torch.Tensor:
    """``y_local = (A x)_local`` on a rank's block: one banded halo
    exchange, then a local gather and row sum (the plain path)."""
    x_ext = _exchange_halos(m, x_local, mesh)
    return (m.vals * x_ext[m.cols_rel]).sum(dim=1)


# ---------------------------------------------------------------------------
# The kernel route: the rank's block on the ELL SpMV kernel
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CudaShardedELL:
    """A rank's block of a :class:`ShardedELL` in the kernels' slot-major
    layout (counterpart of the JAX ``PallasShardedELL``): ``colsT`` (K,
    out_rows) int32 ids absolute in the rank's ``x_ext`` and ``valsT`` (K,
    out_rows), both contiguous.  The TPU layout's int16 window ids and its
    width refusals were Mosaic limits, so every block takes this layout."""

    colsT: torch.Tensor
    valsT: torch.Tensor


def build_cuda_sharded(m: ShardedELL) -> CudaShardedELL:
    """The kernel layout of a rank's block ``m`` (counterpart of
    ``build_pallas_sharded``; never ``None``)."""
    return CudaShardedELL(colsT=m.cols_rel.T.contiguous(),
                          valsT=m.vals.T.contiguous())


def cuda_sharded_apply(cm: CudaShardedELL, m: ShardedELL,
                       x_local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``y_local = (A x)_local`` through ``ell_local_spmv`` on the extended
    input (counterpart of ``pallas_sharded_apply``): the CUDA kernel on the
    card, its twin on the CPU; same halo contract as
    :func:`sharded_ell_apply`."""
    return ell_local_spmv(cm.colsT, cm.valsT, _exchange_halos(m, x_local,
                                                              mesh))


# ---------------------------------------------------------------------------
# Sharded level + solver
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ShardedAMGLevel:
    """One sharded level: this rank's blocks of A, P (coarse -> this level)
    and P^T, ``inv_diag`` and the kernel layouts (None: the gather)."""

    A: ShardedELL
    inv_diag: torch.Tensor  # (out_rows,)
    lmax: float
    P: Optional[ShardedELL] = None
    Pt: Optional[ShardedELL] = None
    A_fast: Optional[CudaShardedELL] = None
    P_fast: Optional[CudaShardedELL] = None
    Pt_fast: Optional[CudaShardedELL] = None


def apply_sharded(m: ShardedELL, fast: Optional[CudaShardedELL],
                  x_local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Local operator apply, through the kernel route when prepared."""
    if fast is not None:
        return cuda_sharded_apply(fast, m, x_local, mesh)
    return sharded_ell_apply(m, x_local, mesh)


class ShardedAMGSolver:
    """Block-row sharded AMG V-cycle solver over a ``("x",)`` rank mesh.

    Host set-up as :class:`multigrid_prj_tpu_torch.amg.AMGSolver` (RCM,
    strength, coarsening, smoothed interpolation on the F-rows, Galerkin
    RAP); the solve runs ``num_sharded`` fine levels distributed and the
    remaining levels replicated after an ``all_gather``.  Arguments are the
    JAX solver's, plus ``device`` (the card unless the caller names
    another: the current CUDA device, ``cuda:LOCAL_RANK`` under NCCL).
    ``use_pallas``: ``True`` / ``False``, or ``"auto"`` / ``None`` for "on
    CUDA"; the kernel route runs in float32 only, other dtypes run the plain
    ops on every device.  Each rank keeps its own blocks on its device.

    Collectives per cycle on ``P > 1`` ranks: one halo exchange per apply
    (``(nu1 + nu2) * cheb_degree`` smoother applies of A with Chebyshev,
    ``nu1 + nu2`` with Jacobi, one residual apply of A, one of P^T and one
    of P per sharded level, and one apply of A for the residual norm) for
    each operator whose halo is not 0, one ``all_gather`` and one
    ``all_reduce``; a solve adds one ``all_reduce`` for ``|b|^2`` and one
    ``all_gather`` that assembles ``x``.
    """

    def __init__(
        self,
        A: HostCSR,
        mesh: Mesh,
        num_levels: int = 5,
        theta: float = THETA_DEFAULT,
        coarsening: str = "pmis",
        interp: str = "smoothed",  # "smoothed" | "direct" (as AMGSolver)
        smoother: str = "chebyshev",  # "chebyshev" | "jacobi"
        cheb_degree: int = 3,
        nu1: int = 1,
        nu2: int = 1,
        seed: int = 0,
        min_coarse: int = 8,
        min_rows_per_shard: int = 64,
        dtype: torch.dtype = torch.float32,
        tol: float = 1e-8,
        maxit: int = 100,
        use_pallas: bool | str | None = "auto",
        device="cuda",
    ):
        self._configure(mesh, smoother, cheb_degree, nu1, nu2, dtype, tol,
                        maxit, use_pallas, device)
        perm = A.rcm_permutation()
        A = A.permute(perm)
        coarsen = {"pmis": coarsen_pmis, "greedy": coarsen_greedy}[coarsening]
        host_matrices: List[HostCSR] = [A]
        host_P: List[HostCSR] = []
        lmax = {}
        cur = A
        for li in range(num_levels - 1):
            if cur.shape[0] <= min_coarse:
                break
            labels = coarsen(cur, theta, seed)
            if labels.sum() == cur.shape[0]:
                break
            Pm = build_prolongation(cur, labels, theta)
            if interp == "smoothed":
                # F-rows only, exactly as AMGSolver (identical hierarchy);
                # the estimate is kept for the Chebyshev interval
                lmax[li] = _estimate_lmax(cur)
                Pm = smooth_prolongation(
                    cur, Pm, lmax[li],
                    coarse_rows=np.flatnonzero(labels == 1))
            cur = rap(Pm, cur)
            host_P.append(Pm)
            host_matrices.append(cur)
        self._build(host_matrices, host_P, perm, lmax, min_rows_per_shard)

    @classmethod
    def from_hierarchy(cls, host_matrices: Sequence[HostCSR],
                       host_P: Sequence[HostCSR], mesh: Mesh, perm=None,
                       lmax=None, smoother: str = "chebyshev",
                       cheb_degree: int = 3, nu1: int = 1, nu2: int = 1,
                       min_rows_per_shard: int = 64,
                       dtype: torch.dtype = torch.float32, tol: float = 1e-8,
                       maxit: int = 100, use_pallas="auto", device="cuda"):
        """A solver on a hierarchy set up elsewhere (``convert.py``, or
        another solver's ``host_matrices`` / ``host_P``): the host operators
        and prolongations in the internal (RCM) frame, the permutation
        (None: the identity) and per-level ``lmax`` estimates (0 or None
        where not computed)."""
        self = cls.__new__(cls)
        self._configure(mesh, smoother, cheb_degree, nu1, nu2, dtype, tol,
                        maxit, use_pallas, device)
        known = {i: float(v) for i, v in enumerate(lmax or ()) if v}
        n = host_matrices[0].shape[0]
        perm = np.arange(n) if perm is None else np.asarray(perm, np.int64)
        self._build(list(host_matrices), list(host_P), perm, known,
                    min_rows_per_shard)
        return self

    def _configure(self, mesh, smoother, cheb_degree, nu1, nu2, dtype, tol,
                   maxit, use_pallas, device):
        if mesh.axis_names != (AXIS,):
            raise ValueError(f"the sharded AMG solver partitions over one "
                             f"mesh axis, {(AXIS,)}; got {mesh.axis_names}")
        if mesh.index < 0:
            raise ValueError("this rank holds no block of the mesh")
        if smoother not in ("chebyshev", "jacobi"):
            raise ValueError(f"smoother must be 'chebyshev' or 'jacobi', got "
                             f"{smoother!r}")
        self.mesh = mesh
        self.p = mesh.size
        self.device = torch.device(device)
        self.dtype = dtype
        self._use_pallas = (on_cuda_flag(use_pallas, self.device,
                                         "use_pallas")
                            and dtype == torch.float32)
        self.smoother_name = smoother
        self.cheb_degree = int(cheb_degree)
        self.nu1, self.nu2 = int(nu1), int(nu2)
        self.tol, self.maxit = float(tol), int(maxit)

    def _build(self, host_matrices, host_P, perm, lmax, min_rows_per_shard):
        """Choose the sharded levels, then ship this rank's blocks, the
        replicated tail and the bottom's LU factors to the device."""
        p, dtype, device = self.p, self.dtype, self.device
        self.host_matrices, self.host_P = host_matrices, host_P
        self._perm = perm
        perm_t = torch.from_numpy(perm)
        self._perm_dev = perm_t.to(device)
        self._inv_perm_dev = torch.argsort(perm_t).to(device)

        def lmax_of(i):
            if self.smoother_name != "chebyshev":
                return 0.0
            if i not in lmax:
                lmax[i] = _estimate_lmax(host_matrices[i])
            return lmax[i]

        pads = [-(-M.shape[0] // p) * p for M in host_matrices]
        self.n_pads = pads
        built = []  # (A, P, Pt) full padded ShardedELLs of each level
        for l, M in enumerate(host_matrices[:-1]):
            if pads[l] // p < min_rows_per_shard:
                break
            Pm = host_P[l]
            ops = (build_sharded_ell(M, pads[l], pads[l], p, dtype),
                   build_sharded_ell(Pm, pads[l], pads[l + 1], p, dtype),
                   build_sharded_ell(Pm.transpose(), pads[l + 1], pads[l], p,
                                     dtype))
            if any(op is None for op in ops):
                break
            built.append(ops)
        if not built:
            raise ValueError(
                f"level 0 ({host_matrices[0].shape[0]} rows) not shardable "
                f"over {p} devices (band too wide or < {min_rows_per_shard} "
                "rows/shard)")
        self.num_sharded = ns = len(built)

        def fast(m):
            return build_cuda_sharded(m) if self._use_pallas else None

        idx = self.mesh.index
        self.sharded_levels: List[ShardedAMGLevel] = []
        for l, ops in enumerate(built):
            d = host_matrices[l].diagonal()
            inv = np.ones(pads[l])
            inv[: d.size] = np.where(d == 0, 1.0, d)
            A_b, P_b, Pt_b = (op.block(idx, device) for op in ops)
            R = A_b.out_rows
            self.sharded_levels.append(ShardedAMGLevel(
                A=A_b,
                inv_diag=to_device(1.0 / inv[idx * R:(idx + 1) * R], dtype,
                                   device),
                lmax=float(lmax_of(l)), P=P_b, Pt=Pt_b, A_fast=fast(A_b),
                P_fast=fast(P_b), Pt_fast=fast(Pt_b)))
        del built

        # replicated tail: plain gather ELL levels from num_sharded down to
        # the bottom, which is solved densely
        self.tail_matrices = host_matrices[ns:]
        self._tail = []
        for i, M in enumerate(self.tail_matrices[:-1], start=ns):
            d = M.diagonal()
            Pm = host_P[i]
            self._tail.append((
                ELLMatrix.from_host_csr(M, dtype=dtype, device=device),
                to_device(1.0 / np.where(d == 0, 1.0, d), dtype, device),
                float(lmax_of(i)),
                ELLMatrix.from_host_csr(Pm, dtype=dtype, device=device),
                ELLMatrix.from_host_csr(Pm.transpose(), dtype=dtype,
                                        device=device)))
        # the JAX tail solves the bottom with jnp.linalg.solve each cycle;
        # torch.linalg.solve is lu_factor then lu_solve, and the factors
        # depend on the matrix only, so they are computed once here
        self._bottom_lu = torch.linalg.lu_factor(to_device(
            host_matrices[-1].to_dense(), dtype, device))
        # per level, 0 where not estimated (the bottom's is never needed)
        self.lmax = [lmax.get(i, 0.0) for i in range(len(host_matrices))]

    # -- smoothers (local blocks, halo exchange inside the applies) --------

    def _apply(self, m, fast, x):
        return apply_sharded(m, fast, x, self.mesh)

    def _smooth(self, lvl: ShardedAMGLevel, x, b, sweeps: int):
        for _ in range(sweeps):
            if self.smoother_name == "chebyshev":
                x = self._cheb(lvl, x, b)
            else:
                r = b - self._apply(lvl.A, lvl.A_fast, x)
                x = x + (2.0 / 3.0) * r * lvl.inv_diag
        return x

    def _cheb(self, lvl: ShardedAMGLevel, x, b, lmin_ratio: float = 0.30):
        lmax = 1.05 * lvl.lmax
        lmin = lmin_ratio * lvl.lmax
        theta = 0.5 * (lmax + lmin)
        delta = 0.5 * (lmax - lmin)
        sigma = theta / delta
        rho = 1.0 / sigma
        r = b - self._apply(lvl.A, lvl.A_fast, x)
        p_ = _div(r * lvl.inv_diag, theta)
        x = x + p_
        for _ in range(self.cheb_degree - 1):
            rho_new = 1.0 / (2.0 * sigma - rho)
            r = b - self._apply(lvl.A, lvl.A_fast, x)
            p_ = (rho_new * rho) * p_ + (2.0 * rho_new / delta) * (
                r * lvl.inv_diag)
            x = x + p_
            rho = rho_new
        return x

    # -- replicated tail V-cycle (plain ELL on gathered vectors) -----------

    def _tail_smooth(self, ell, idg, lmax, x, b, sweeps: int):
        for _ in range(sweeps):
            if self.smoother_name == "chebyshev" and lmax > 0:
                hi = 1.05 * lmax
                lo = 0.30 * lmax
                th, de = 0.5 * (hi + lo), 0.5 * (hi - lo)
                sg = th / de
                rho = 1.0 / sg
                r = b - ell.spmv(x)
                p_ = _div(r * idg, th)
                x = x + p_
                for _ in range(self.cheb_degree - 1):
                    rho_n = 1.0 / (2.0 * sg - rho)
                    r = b - ell.spmv(x)
                    p_ = (rho_n * rho) * p_ + (2.0 * rho_n / de) * (r * idg)
                    x = x + p_
                    rho = rho_n
            else:
                r = b - ell.spmv(x)
                x = x + (2.0 / 3.0) * r * idg
        return x

    def _tail_vcycle(self, x, b, idx: int):
        if idx == len(self._tail):
            return torch.linalg.lu_solve(*self._bottom_lu, b[:, None])[:, 0]
        ell, idg, lmax, Pe, Pte = self._tail[idx]
        x = self._tail_smooth(ell, idg, lmax, x, b, self.nu1)
        r = b - ell.spmv(x)
        bc = Pte.spmv(r)
        ec = self._tail_vcycle(torch.zeros_like(bc), bc, idx + 1)
        x = x + Pe.spmv(ec)
        return self._tail_smooth(ell, idg, lmax, x, b, self.nu2)

    # -- sharded V-cycle -----------------------------------------------------

    def _v_local(self, x, b, l: int):
        lvl = self.sharded_levels[l]
        x = self._smooth(lvl, x, b, self.nu1)
        r = b - self._apply(lvl.A, lvl.A_fast, x)
        rc = self._apply(lvl.Pt, lvl.Pt_fast, r)
        if l + 1 < self.num_sharded:
            ec = self._v_local(torch.zeros_like(rc), rc, l + 1)
        else:
            r_full = self.mesh.all_gather_rows(rc)
            nc = self.tail_matrices[0].shape[0]
            e_full = self._tail_vcycle(r_full.new_zeros(nc), r_full[:nc], 0)
            e_pad = torch.cat([e_full, e_full.new_zeros(r_full.shape[0]
                                                         - nc)])
            rows_c = rc.shape[0]
            i = self.mesh.index
            ec = e_pad[i * rows_c:(i + 1) * rows_c]
        x = x + self._apply(lvl.P, lvl.P_fast, ec)
        return self._smooth(lvl, x, b, self.nu2)

    def _solve_local(self, b):
        """Cycles from zero on this rank's block of ``b`` until the global
        relative residual reaches ``tol`` or ``maxit`` cycles ran: ``(x
        block, iterations, rel tensor, history tensor)``.  One host sync
        per iteration (the loop's test of the reduced norm)."""
        lvl0 = self.sharded_levels[0]
        mesh = self.mesh
        b2 = mesh.all_reduce(torch.sum(b * b))

        def rel_of(rn2):
            return torch.sqrt(torch.where(b2 > 0, rn2 / b2,
                                          torch.zeros_like(rn2)))

        tol2 = torch.tensor(self.tol ** 2, dtype=b.dtype, device=b.device)
        stop = tol2 * b2
        hist = torch.full((HIST_CAP + 1,), float("nan"), dtype=b.dtype,
                          device=b.device)
        hist[0] = rel_of(b2)
        x = torch.zeros_like(b)
        k, rn2 = 0, b2
        while k < self.maxit and bool(rn2 > stop):
            x = self._v_local(x, b, 0)
            r = b - self._apply(lvl0.A, lvl0.A_fast, x)
            rn2 = mesh.all_reduce(torch.sum(r * r))
            k += 1
            hist[min(k, HIST_CAP)] = rel_of(rn2)
        return x, k, rel_of(rn2), hist

    # -- public API ----------------------------------------------------------

    @property
    def level_sizes(self) -> list[int]:
        return [M.shape[0] for M in self.host_matrices]

    def _local_rhs(self, b):
        """This rank's block of the padded RCM-frame ``b`` (numpy, or a
        tensor on the solver's device; the global vector in the caller's
        frame), in the solve dtype on the device."""
        if isinstance(b, torch.Tensor):
            if b.device.type != self.device.type:
                raise ValueError(f"b is on {b.device}, the solver on "
                                 f"{self.device}")
            bp = b.to(self.dtype).index_select(0, self._perm_dev)
        else:
            bp = to_device(np.asarray(b)[self._perm], self.dtype,
                           self.device)
        R = self.n_pads[0] // self.p
        bp = torch.cat([bp, bp.new_zeros(self.n_pads[0] - bp.shape[0])])
        return bp[self.mesh.index * R:(self.mesh.index + 1) * R]

    def solve(self, b) -> AMGSolveResult:
        """Solve ``A x = b``; ``b`` is the global right-hand side in the
        caller's frame on every rank.  Returns an
        :class:`~multigrid_prj_tpu_torch.amg.AMGSolveResult`: unpacks as
        ``(x, iterations, rel_residual)`` like the JAX solver, ``x`` the
        global solution in the caller's frame on the solver's device on
        every rank, and carries ``.history``."""
        check_finite(b, "rhs b")
        x, k, rel, hist = self._solve_local(self._local_rhs(b))
        n = self.host_matrices[0].shape[0]
        x = self.mesh.all_gather_rows(x)[:n].index_select(0,
                                                          self._inv_perm_dev)
        hist = hist[: min(k, HIST_CAP) + 1].cpu().numpy()
        return AMGSolveResult(x, k, float(rel), hist,
                              history_truncated=k > HIST_CAP)

    def step(self, b) -> torch.Tensor:
        """One sharded V-cycle from zero: this rank's block of the padded
        RCM-frame result (``mesh.all_gather_rows`` of it is what the JAX
        ``step`` returns)."""
        b = self._local_rhs(b)
        return self._v_local(torch.zeros_like(b), b, 0)
