"""Classical algebraic multigrid (PyTorch port of ``multigrid_prj_tpu/amg.py``):
setup (strength, coarsening, interpolation, Galerkin RAP) on the host, solve
cycles on a torch device.

* Setup is host NumPy, copied from the JAX package with the native hooks
  pointing at this package's ``native.py`` (the same library) and the same
  NumPy call sequence (``_estimate_lmax`` draws from ``default_rng(7)``), so
  both packages build bit-identical hierarchies.
* Each level's operator goes to the device as an ``ELLMatrix`` (gather form)
  and, on the kernel path, as a ``CudaELL`` (``A_fast``/``P_fast``/
  ``Pt_fast``), whose SpMV is the hand-written kernel of ``csrc/spmv.cu``;
  the cycle's residual, prolong-add and Chebyshev steps run its fused
  forms (one launch each, bit-equal to the SpMV and the torch ops after
  it), and each level's cycle starts from a zero ``x`` without an SpMV.
  The kernel path (``use_pallas``, default on CUDA) runs only where the JAX
  package runs its Pallas kernel: f32, levels of at least
  ``pallas_min_rows`` rows.  Small intermediate levels run a dense matvec
  (``A_dense``) and the bottom a dense inverse, both ``torch.matmul`` as
  XLA matmuls in JAX; other dtypes and the ``mcgs`` smoother's per-colour
  gathers are plain torch ops.
* ``solve``, ``solve_pcg``, ``solve_refined`` (float-float outer residuals;
  on the kernel path through ``CudaELL.residual_ff``) and
  ``reference_sawtooth_pass``.  The JAX package runs each solve as one
  ``lax.while_loop``; here the loops are Python loops with one scalar fetch
  per iteration (the stop test, through ``utils/metrics.fetch``), and the
  history is written on the device with the JAX semantics (``HIST_CAP``,
  entry 0, ``history_truncated``) and fetched once, at the end.
  ``solve_p1`` runs ``solve_refined`` (its answer summed on the device) on
  a P1 system's device-side load and returns the nodal field there.
* ``solve`` and ``solve_refined`` open ``GMGSolver``'s profiler spans
  (``utils/metrics``: root, split, float-float residual, fetch, cycle with
  each level's stages and the bottom, combine); ``setup_times`` holds the
  set-up's seconds by phase, and the first solve's are kept beside them
  (``utils/metrics.PhaseTimer``, the solver's set-up record).

Defaults follow the JAX package with CUDA in the TPU's place: ``dtype=None``
is f64 on the CPU and f32 on CUDA, ``smoother="auto"`` Chebyshev on CUDA and
multicolour Gauss-Seidel on the CPU, ``reorder="auto"`` RCM iff the kernel
path is on (the kernels do not need it; it keeps the CUDA hierarchy equal
to the TPU's).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from multigrid_prj_tpu_torch.ops.cuda_spmv import CudaELL
from multigrid_prj_tpu_torch.ops.extended import ff_add_f
from multigrid_prj_tpu_torch.ops.krylov import cg_arrays
from multigrid_prj_tpu_torch.ops.sparse import (
    ELLMatrix,
    HostCSR,
    _ell_slots,
    rap,
    to_device,
)
from multigrid_prj_tpu_torch.ops.sparse_extended import (
    ELLPair,
    ell_residual_ff,
    ff_pair_from_f64,
)
from multigrid_prj_tpu_torch.utils.config import on_cuda_flag
from multigrid_prj_tpu_torch.utils.guards import check_finite
from multigrid_prj_tpu_torch.utils.metrics import (
    SPAN_BOTTOM,
    SPAN_COMBINE,
    SPAN_CYCLE,
    SPAN_FETCH,
    SPAN_FF_RESIDUAL,
    SPAN_SOLVE,
    SPAN_SOLVE_REFINED,
    SPAN_SPLIT,
    PhaseTimer,
    fetch,
    level_spans,
    span,
)

THETA_DEFAULT = 0.2  # AMG/include/AMG.hpp:21 (EPSILON)

# Residual-history buffer length, as in the JAX package (past the cap the
# last slot keeps the newest value).
HIST_CAP = 512

# Small intermediate levels run a dense matvec on the kernel path (the JAX
# package's cap, a TPU measurement kept for parity: ROADMAP.md section A).
DENSE_MAX_ROWS = 4096


class AMGSolveResult(tuple):
    """``(x, iterations, rel_residual)`` triple with a ``history`` attribute
    (the per-iteration relative residual norms, numpy) and
    ``history_truncated`` (True when the solve ran past ``HIST_CAP``)."""

    history: np.ndarray
    history_truncated: bool

    def __new__(cls, x, iterations: int, rel_residual: float, history,
                history_truncated: bool = False):
        self = super().__new__(cls, (x, iterations, rel_residual))
        self.history = np.asarray(history)
        self.history_truncated = bool(history_truncated)
        return self

    @property
    def x(self):
        return self[0]

    @property
    def iterations(self) -> int:
        return self[1]

    @property
    def rel_residual(self) -> float:
        return self[2]


# ---------------------------------------------------------------------------
# Setup phase (host, NumPy)
# ---------------------------------------------------------------------------


def strength_mask(A: HostCSR, theta: float = THETA_DEFAULT) -> np.ndarray:
    """Boolean mask over ``A.data``: entry is a strong off-diagonal connection.

    Vectorised form of ``strong_connections_in_row`` (``AMG.hpp:105-130``).
    """
    n = A.shape[0]
    rows = np.repeat(np.arange(n), A.row_lengths)
    offdiag = rows != A.indices
    absval = np.abs(A.data)
    row_max = np.zeros(n)
    np.maximum.at(row_max, rows[offdiag], absval[offdiag])
    return offdiag & (absval >= theta * row_max[rows]) & (row_max[rows] > 0)


def _strong_lists(A: HostCSR, strong: np.ndarray):
    """Per-row strong neighbor lists as (indptr-style offsets, flat cols)."""
    n = A.shape[0]
    rows = np.repeat(np.arange(n), A.row_lengths)
    s_rows = rows[strong]
    s_cols = A.indices[strong]
    counts = np.bincount(s_rows, minlength=n)
    ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=ptr[1:])
    return ptr, s_cols


def coarsen_greedy(
    A: HostCSR, theta: float = THETA_DEFAULT, seed: int = 0
) -> np.ndarray:
    """The reference's greedy sequential coarsening, made deterministic.

    Reproduces ``select_coarse_nodes`` (``AMG.hpp:150-198``): per-node
    counter = #strong connections; start from a (seeded) random node; mark
    it coarse, its strong neighbors fine, bump their strong neighbors'
    counters by 2; next pivot = highest-index node with nonzero counter
    (the reference's scan keeps overwriting, ``AMG.hpp:184-192``).

    Returns labels: 1 = coarse, 0 = fine.
    """
    n = A.shape[0]
    strong = strength_mask(A, theta)
    ptr, s_cols = _strong_lists(A, strong)
    rng = np.random.default_rng(seed)
    idx = int(rng.integers(0, n + 1)) % n  # getRandomInit range is [0, max]

    from multigrid_prj_tpu_torch import native

    if native.available() and n:
        labels = native.greedy_coarsen(ptr, s_cols, n, idx)
    else:
        counter = np.diff(ptr).astype(np.int64)  # undecided iff counter > 0
        fine = np.zeros(n, dtype=bool)
        while counter[idx] > 0:
            counter[idx] = 0
            for c in s_cols[ptr[idx]: ptr[idx + 1]]:
                if counter[c] > 0:
                    fine[c] = True
                    counter[c] = 0
                    for c2 in s_cols[ptr[c]: ptr[c + 1]]:
                        if counter[c2] > 0:
                            counter[c2] += 2
            nz = np.flatnonzero(counter > 0)
            if nz.size == 0:
                break
            idx = int(nz[-1])
        labels = (~fine).astype(np.int8)  # untouched (isolated) nodes stay coarse
    # The reference divides by zero when a fine node has no strong *coarse*
    # neighbor (strength is not symmetric, SURVEY.md §7.5); promote such
    # orphans to coarse so interpolation is always well defined.
    rows = np.repeat(np.arange(n), A.row_lengths)
    has_c = np.zeros(n, dtype=bool)
    sel = strong & (labels[A.indices] == 1)
    has_c[rows[sel]] = True
    labels[(labels == 0) & ~has_c] = 1
    return labels


def coarsen_pmis(
    A: HostCSR, theta: float = THETA_DEFAULT, seed: int = 0
) -> np.ndarray:
    """Deterministic PMIS coarsening (parallel-friendly; the TPU-idiomatic
    replacement for the reference's sequential loop, SURVEY.md §7.4.3).

    Independent-set selection on the symmetrised strength graph with hashed
    random weights; fine nodes with no coarse strong neighbor are promoted
    so interpolation is always well defined.
    """
    n = A.shape[0]
    strong = strength_mask(A, theta)
    rows = np.repeat(np.arange(n), A.row_lengths)
    sr, sc = rows[strong], A.indices[strong]
    # symmetrise: i ~ j if either direction is strong
    er = np.concatenate([sr, sc])
    ec = np.concatenate([sc, sr])
    lam = np.bincount(er, minlength=n).astype(np.float64)  # degree weight
    rng = np.random.default_rng(seed)
    w = lam + rng.random(n)
    state = np.zeros(n, dtype=np.int8)  # 0 undecided, 1 coarse, 2 fine
    state[lam == 0] = 1  # isolated nodes are coarse (interpolated by identity)
    # active edge set shrinks permanently: a decided endpoint never reverts,
    # so its edges can never contribute to a later round's nbr_max — the
    # rounds cost O(remaining edges), not O(all edges) each (measured 3.7 s
    # -> ~0.6 s on the 1M-row FD system; identical selection sequence)
    aer, aec = er, ec
    for _ in range(n):
        und = state == 0
        if not und.any():
            break
        both = und[aer] & und[aec]
        aer, aec = aer[both], aec[both]
        # a node wins if its weight beats every undecided neighbor's weight
        nbr_max = np.zeros(n)
        np.maximum.at(nbr_max, aer, w[aec])
        winners = und & (w > nbr_max)
        if not winners.any():  # ties (measure-zero with random weights)
            winners = und & (w >= nbr_max)
        state[winners] = 1
        # undecided neighbors of new coarse nodes become fine
        new_fine = (state[aer] == 0) & (state[aec] == 1)
        state[aer[new_fine]] = 2
    # guarantee every fine node has a strong coarse neighbor
    has_c = np.zeros(n, dtype=bool)
    has_c[sr[state[sc] == 1]] = True
    orphan = (state == 2) & ~has_c
    state[orphan] = 1
    return (state == 1).astype(np.int8)


def build_prolongation(
    A: HostCSR, labels: np.ndarray, theta: float = THETA_DEFAULT
) -> HostCSR:
    """Direct interpolation P (n_fine x n_coarse), reference weight formula.

    Coarse row: single 1 at its coarse column (``AMG.hpp:243-247``).
    Fine row i: ``w_k = a_ik / sum_{strong coarse k} a_ik``
    (``AMG.hpp:249-293``; the alpha factor cancels — see module docstring).
    """
    n = A.shape[0]
    labels = np.asarray(labels, dtype=np.int8)
    coarse_ids = np.flatnonzero(labels == 1)
    col_of = -np.ones(n, dtype=np.int64)
    col_of[coarse_ids] = np.arange(coarse_ids.size)
    strong = strength_mask(A, theta)
    rows = np.repeat(np.arange(n), A.row_lengths)
    # entries of P from fine rows: strong connections to coarse nodes
    sel = strong & (labels[A.indices] == 1) & (labels[rows] == 0)
    pr, pc, pv = rows[sel], col_of[A.indices[sel]], A.data[sel]
    denom = np.zeros(n)
    np.add.at(denom, pr, pv)
    if np.any((labels == 0) & (denom == 0)):
        # orphaned fine rows should have been promoted by the coarsener
        bad = np.flatnonzero((labels == 0) & (denom == 0))
        raise ValueError(f"fine nodes with no strong coarse neighbor: {bad[:10]}")
    pv = pv / denom[pr]
    # coarse rows: identity
    cr = coarse_ids
    cc = col_of[coarse_ids]
    cv = np.ones(coarse_ids.size)
    return HostCSR.from_coo(
        np.concatenate([pr, cr]),
        np.concatenate([pc, cc]),
        np.concatenate([pv, cv]),
        (n, coarse_ids.size),
    )


def smooth_prolongation(A: HostCSR, P: HostCSR, lmax: float,
                        omega_factor: float = 4.0 / 3.0,
                        drop_tol: float = 0.02,
                        coarse_rows: np.ndarray | None = None) -> HostCSR:
    """Jacobi-smoothed interpolation ``P_s = (I - omega D^{-1} A) P``.

    The standard smoothed-aggregation upgrade applied to the classical
    direct-interpolation P: one damped-Jacobi application of the fine
    operator smooths the interpolation basis, which repairs the weak
    two-level rate of pure direct weights (measured on the 512^2 FD
    Poisson system with PMIS + Chebyshev(3): rho/cycle 0.88 with direct
    weights -> 0.113 smoothed; 10 V-cycles to 1e-10).
    ``omega = omega_factor / lmax(D^{-1} A)`` (4/3 is the SA classic).

    With ``coarse_rows`` given (the solver always passes it), smoothing
    applies to F-rows only — Jacobi-smoothed *classical* interpolation:
    C-rows keep their exact identity entry, so no column can be emptied
    and singular Galerkin operators cannot arise (see
    :func:`_inv_diag_guarded`).  Measured: F-row-only smoothing also
    *improves* the cycle (less Galerkin fill, faster coarsening,
    coarse-level condition numbers 1e22 -> 7e1 on the 512^2 chain).

    The reference's AMG has no analog (its interpolation is direct-only,
    ``AMG/include/AMG.hpp:230-300``); construction beyond the reference,
    same capability class.  ``drop_tol``: entries of the smoothed P below
    ``drop_tol * max|row|`` are dropped to bound Galerkin fill (relative
    row-wise filtering, the standard SA practice).
    """
    omega = omega_factor / float(lmax)
    n = A.shape[0]
    inv_d = _inv_diag_guarded(A)  # weak-diagonal rows smooth as identity
    if coarse_rows is not None:
        # Jacobi-smoothed CLASSICAL interpolation smooths F-rows only:
        # every C-row keeps its exact identity entry, so no P column can
        # ever be emptied (by smoothing or by the drop filter) — an empty
        # column is an exactly singular Galerkin coarse operator.
        inv_d = inv_d.copy()
        inv_d[np.asarray(coarse_rows)] = 0.0
    # form the smoother S = I - omega D^{-1} A explicitly (A's structure
    # with scaled values, +1 on the diagonal) and take ONE SpGEMM S @ P —
    # the previous A @ P + triplet-concat + re-sort form cost two extra
    # O(nnz log nnz) coalescing passes (measured setup hot spot, VERDICT r4
    # weak #3).  Identical contribution multiset per (i, j) entry.
    rows_a = np.repeat(np.arange(n), A.row_lengths)
    on_diag = rows_a == A.indices
    if int(on_diag.sum()) != n:
        # a row without a structural diagonal cannot host the identity
        # entry in-place; no such matrix arises from FD/FEM/Galerkin
        # operators, but fall back to an explicit identity concat safely
        rows = np.concatenate([rows_a, np.arange(n)])
        cols = np.concatenate([A.indices, np.arange(n)])
        vals = np.concatenate([(-omega * inv_d[rows_a]) * A.data, np.ones(n)])
        S = HostCSR.from_coo(rows, cols, vals, (n, n))
    else:
        s_vals = (-omega * inv_d[rows_a]) * A.data
        s_vals[on_diag] += 1.0
        keep_s = s_vals != 0.0  # unsmoothed (C/weak) rows: pure identity
        counts = np.bincount(rows_a[keep_s], minlength=n)
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        S = HostCSR(indptr=indptr, indices=A.indices[keep_s],
                    data=s_vals[keep_s], shape=(n, n))
    Ps = S.matmul(P)
    if drop_tol > 0 and Ps.nnz:
        r2 = np.repeat(np.arange(Ps.shape[0]), Ps.row_lengths)
        row_max = np.zeros(Ps.shape[0])
        np.maximum.at(row_max, r2, np.abs(Ps.data))
        keep = np.abs(Ps.data) >= drop_tol * row_max[r2]
        # rescale kept entries so each row sum is preserved (partition of
        # unity — dropping without rescaling breaks interpolation of
        # constants and diverges)
        sum_before = np.bincount(r2, weights=Ps.data,
                                 minlength=Ps.shape[0])
        sum_after = np.bincount(r2[keep], weights=Ps.data[keep],
                                minlength=Ps.shape[0])
        scale = np.where(np.abs(sum_after) > 1e-12 * np.abs(sum_before),
                         sum_before / np.where(sum_after == 0, 1.0, sum_after),
                         1.0)
        # rows of Ps are already sorted: rebuild the CSR directly instead
        # of another from_coo sort
        counts = np.bincount(r2[keep], minlength=Ps.shape[0])
        indptr = np.zeros(Ps.shape[0] + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        Ps = HostCSR(indptr=indptr, indices=Ps.indices[keep],
                     data=Ps.data[keep] * scale[r2[keep]], shape=Ps.shape)
    return Ps


def greedy_coloring(A: HostCSR) -> tuple[np.ndarray, int]:
    """Greedy graph coloring of the matrix adjacency (host, setup-time).

    Powers the multicolor Gauss-Seidel smoother — the parallel equivalent of
    the reference's sequential sweep (``AMG/include/Utilities.hpp:38-98``).
    Dispatches to the native C++ implementation when built.
    """
    n = A.shape[0]
    from multigrid_prj_tpu_torch import native

    if native.available() and n:
        return native.greedy_coloring(A.indptr, A.indices, n)
    colors = -np.ones(n, dtype=np.int64)
    for i in range(n):
        cols, _ = A.row(i)
        used = set(colors[c] for c in cols if c != i and colors[c] >= 0)
        c = 0
        while c in used:
            c += 1
        colors[i] = c
    return colors, int(colors.max()) + 1 if n else 0


def _inv_diag_guarded(A: HostCSR) -> np.ndarray:
    """``1/diag(A)`` with entries zeroed where the diagonal is pathologically
    small relative to the row magnitude (``|d_i| <= 0.1 max_j |a_ij|``).

    Galerkin coarse operators of smoothed-P hierarchies are not M-matrices;
    a near-zero diagonal does occur in practice (512^2 FD chain, level 2:
    d = 6.9e-3 against off-diagonals ~15).  An unguarded ``omega/d`` there
    blows the smoothed-P row up to ~1e5, the drop filter then removes the
    row's own coarse entry, and the column vanishes — planting an exactly
    empty row (singular coarse operator) two levels down.  Zeroing the
    inverse for such rows makes every D^{-1}-based operation treat them as
    unsmoothed, which is always safe.
    """
    n = A.shape[0]
    d = A.diagonal()
    rows = np.repeat(np.arange(n), A.row_lengths)
    row_max = np.zeros(n)
    np.maximum.at(row_max, rows, np.abs(A.data))
    # 0.1: Jacobi smoothing assumes rough diagonal dominance; rows far
    # from it (the observed pathological case: d/row_max = 4.5e-4) turn
    # omega*D^{-1} into an amplifier, not a smoother
    weak = np.abs(d) <= 0.1 * row_max
    return np.where(weak, 0.0, 1.0 / np.where(d == 0.0, 1.0, d))


def _estimate_lmax(A: HostCSR, iters: int = 12, seed: int = 7) -> float:
    """Power iteration on ``D^{-1} A`` (host, setup-time; guarded D).

    The row-segment index is computed once and the SpMV runs through
    ``np.bincount`` (one fused pass) instead of ``HostCSR.spmv``'s
    per-call ``np.repeat`` + ``np.add.at`` — ~5x on the 1M-row FD system,
    where the estimate was a measured setup hot spot (VERDICT r4 weak #3).
    12 iterations: the estimate's consumers both carry safety margins
    (Chebyshev interval uses ``1.05 * lmax``; the SA omega tolerates a few
    percent either way), so the last digits of a 25-iteration estimate buy
    nothing."""
    n = A.shape[0]
    inv_d = _inv_diag_guarded(A)
    rows = np.repeat(np.arange(n), A.row_lengths)
    idx, dat = A.indices, A.data
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n)
    v /= np.linalg.norm(v)
    lam = 1.0
    for _ in range(iters):
        w = np.bincount(rows, weights=dat * v[idx], minlength=n) * inv_d
        nw = np.linalg.norm(w)
        if nw == 0:
            return 1.0
        lam = nw
        v = w / nw
    return float(lam)


# ---------------------------------------------------------------------------
# Device-side hierarchy
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ColorBlock:
    """The rows of one colour as a contiguous ELL sub-block, so a multicolour
    GS sweep touches every nonzero once."""

    rows: torch.Tensor  # (nc,) int32 global row ids of this colour
    cols: torch.Tensor  # (nc, K) int32
    vals: torch.Tensor  # (nc, K)
    inv_diag: torch.Tensor  # (nc,)


@dataclasses.dataclass
class AMGLevel:
    """One AMG level on the device."""

    A: ELLMatrix
    diag: torch.Tensor
    color: torch.Tensor  # (n,) int32 colour ids for multicolour GS
    n_colors: int
    P: Optional[ELLMatrix] = None  # to the NEXT (coarser) level
    Pt: Optional[ELLMatrix] = None
    rhs: Optional[torch.Tensor] = None  # reference-compat coarse rhs
    lmax: float = 0.0  # largest eigenvalue estimate of D^-1 A
    color_blocks: Tuple[ColorBlock, ...] = ()
    # kernel-path operators (ops/cuda_spmv.py); None runs the gather ELL
    A_fast: Optional[CudaELL] = None
    P_fast: Optional[CudaELL] = None
    Pt_fast: Optional[CudaELL] = None
    # dense operator of a small intermediate level on the kernel path
    A_dense: Optional[torch.Tensor] = None


def apply_A(lvl: AMGLevel, x: torch.Tensor) -> torch.Tensor:
    """``A x`` on a level: dense matvec, CUDA kernel or gather ELL."""
    if lvl.A_dense is not None:
        return lvl.A_dense @ x
    return lvl.A_fast.spmv(x) if lvl.A_fast is not None else lvl.A.spmv(x)


def apply_P(lvl: AMGLevel, xc: torch.Tensor) -> torch.Tensor:
    return lvl.P_fast.spmv(xc) if lvl.P_fast is not None else lvl.P.spmv(xc)


def _fast_A(lvl: AMGLevel) -> Optional[CudaELL]:
    """The kernel operator that ``apply_A`` runs on a level, else None."""
    return lvl.A_fast if lvl.A_dense is None else None


def residual_A(lvl: AMGLevel, x: torch.Tensor, b: torch.Tensor):
    """``b - A x`` on a level (one launch where ``apply_A`` is a kernel)."""
    fast = _fast_A(lvl)
    return fast.residual(x, b) if fast is not None else b - apply_A(lvl, x)


def prolong_add(lvl: AMGLevel, x: torch.Tensor, xc: torch.Tensor):
    """``x + P xc`` (one launch where ``apply_P`` is a kernel)."""
    if lvl.P_fast is not None:
        return lvl.P_fast.spmv_add(xc, x)
    return x + apply_P(lvl, xc)


def apply_Pt(lvl: AMGLevel, r: torch.Tensor) -> torch.Tensor:
    return lvl.Pt_fast.spmv(r) if lvl.Pt_fast is not None else lvl.Pt.spmv(r)


def _to_device_level(A: HostCSR, dtype, device, with_colors: bool = True):
    ell = ELLMatrix.from_host_csr(A, dtype=dtype, device=device)
    diag_np = A.diagonal()
    diag = to_device(diag_np, dtype, device)
    if not with_colors:
        # the colouring (and per-colour ELL blocks) only power mcgs
        return (ell, diag, torch.zeros(A.shape[0], dtype=torch.int32,
                                       device=device), 0, ())
    colors, n_colors = greedy_coloring(A)
    cols_np, vals_np = _ell_slots(A, ell.k)
    blocks = []
    safe_diag = np.where(diag_np == 0, 1.0, diag_np)
    for c in range(n_colors):
        rows_c = np.flatnonzero(colors == c)
        blocks.append(ColorBlock(
            rows=to_device(rows_c, torch.int32, device),
            cols=to_device(cols_np[rows_c], torch.int32, device),
            vals=to_device(vals_np[rows_c], dtype, device),
            inv_diag=to_device(1.0 / safe_diag[rows_c], dtype, device),
        ))
    return (ell, diag, to_device(colors, torch.int32, device), n_colors,
            tuple(blocks))


def _div(t: torch.Tensor, c: float) -> torch.Tensor:
    """``t / c`` as a true division on every device (torch on CUDA divides
    by a Python scalar as a multiply by its rounded reciprocal)."""
    return t / torch.full((), c, dtype=t.dtype, device=t.device)


def mc_gs_sweep(level: AMGLevel, x: torch.Tensor, b: torch.Tensor):
    """One multicolour Gauss-Seidel sweep: per colour, the exact GS update
    ``x_c <- x_c + (b - A x)_c / diag_c`` with the freshest ``x``, computed
    on that colour's row block only.  Works on a copy of ``x``."""
    x = x.clone()
    for blk in level.color_blocks:
        ax = (blk.vals * x[blk.cols]).sum(dim=1)
        delta = (b[blk.rows] - ax) * blk.inv_diag
        x.index_add_(0, blk.rows, delta)  # rows are distinct
    return x


def jacobi_sweep(level: AMGLevel, x, b, omega: float = 2.0 / 3.0):
    r = residual_A(level, x, b)
    return x + omega * r / level.diag


def chebyshev_smooth(level: AMGLevel, x, b, degree: int = 3,
                     lmin_ratio: float = 0.30):
    """Degree-``degree`` Chebyshev polynomial smoother on
    ``[lmin_ratio * lmax, 1.05 * lmax]`` of ``D^{-1} A`` (``degree`` SpMVs,
    no inner products; ``lmax`` estimated once at setup).  Where ``apply_A``
    is a kernel, each step (the SpMV and its vector updates) is one launch
    of ``CudaELL.cheb_step``, bit-equal to the torch ops below; ``x`` None
    is a zero ``x``."""
    lmax = 1.05 * level.lmax
    lmin = lmin_ratio * level.lmax
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta
    rho = 1.0 / sigma
    fast = _fast_A(level)
    if fast is not None:
        p, x = fast.cheb_step(x, b, level.diag, None, 0.0, theta, True)
        for _ in range(degree - 1):
            rho_new = 1.0 / (2.0 * sigma - rho)
            p, x = fast.cheb_step(x, b, level.diag, p, rho_new * rho,
                                  2.0 * rho_new / delta, False)
            rho = rho_new
        return x
    if x is None:
        x = torch.zeros_like(b)
    r = b - apply_A(level, x)
    p = _div(r / level.diag, theta)
    x = x + p
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        r = b - apply_A(level, x)
        p = (rho_new * rho) * p + (2.0 * rho_new / delta) * (r / level.diag)
        x = x + p
        rho = rho_new
    return x



class AMGSolver:
    """Classical AMG: host setup, solve on a torch device.

    Parameters mirror the JAX ``AMGSolver``, plus ``device`` (default the
    card; ``device="cpu"`` for the CPU); ``use_pallas``
    keeps its JAX meaning (route the f32 level operators and the float-float
    residual through the kernel functions); ``None`` and ``"auto"`` mean "on
    CUDA", as the JAX ``"auto"`` means "on a TPU backend".  On the CPU,
    ``use_pallas=True`` runs the kernels' torch twins.
    """

    def __init__(
        self,
        A: HostCSR,
        num_levels: int = 5,
        theta: float = THETA_DEFAULT,
        coarsening: str = "pmis",  # "pmis" | "greedy" (reference-compat)
        interp: str = "smoothed",  # "smoothed" | "direct" (reference-compat)
        smoother: str = "auto",  # "auto" | "mcgs" | "jacobi" | "chebyshev"
        cheb_degree: int = 3,
        seed: int = 0,
        min_coarse: int = 8,
        dtype: torch.dtype | None = None,
        rhs: Optional[np.ndarray] = None,
        use_pallas: bool | str | None = None,
        reorder: str = "auto",  # "rcm" | "none" | "auto" (rcm iff kernels)
        pallas_min_rows: int = 4096,
        device="cuda",
    ):
        self._configure(theta, smoother, cheb_degree, dtype, use_pallas,
                        pallas_min_rows, device)
        coarsen = {"pmis": coarsen_pmis, "greedy": coarsen_greedy}[coarsening]
        phase = self._timer.phase
        # the permutation is internal: every public entry point translates
        # b in and x out
        if reorder == "rcm" or (reorder == "auto" and self._use_pallas):
            with phase("rcm"):
                self._perm = A.rcm_permutation()
                A = A.permute(self._perm)
            if rhs is not None:
                rhs = np.asarray(rhs)[self._perm]

        self.host_matrices: List[HostCSR] = [A]
        self.host_P: List[HostCSR] = []
        cur = A
        for li in range(num_levels - 1):
            if cur.shape[0] <= min_coarse:
                break
            with phase("coarsening"):
                labels = coarsen(cur, theta, seed)
            if labels.sum() == cur.shape[0]:  # no coarsening progress
                break
            with phase("interpolation"):
                P = build_prolongation(cur, labels, theta)
                if interp == "smoothed":
                    P = smooth_prolongation(
                        cur, P, self._lmax_of(li),
                        coarse_rows=np.flatnonzero(labels == 1))
            with phase("rap"):
                cur = rap(P, cur)
            self.host_P.append(P)
            self.host_matrices.append(cur)
        self._build_levels(rhs)

    @classmethod
    def from_hierarchy(cls, host_matrices, host_P, perm=None, lmax=None,
                       bottom_inv=None, rhs=None, theta=THETA_DEFAULT,
                       smoother="auto", cheb_degree=3, dtype=None,
                       use_pallas=None, pallas_min_rows=4096, device="cuda"):
        """A solver on a hierarchy set up elsewhere (``convert.py``): the
        host operators and prolongations in the internal (permuted) frame,
        the permutation, per-level ``lmax`` estimates (0 or None where not
        computed) and the bottom level's inverse (computed if None).
        ``rhs`` is in the caller's frame."""
        self = cls.__new__(cls)
        self._configure(theta, smoother, cheb_degree, dtype, use_pallas,
                        pallas_min_rows, device)
        self._perm = None if perm is None else np.asarray(perm, np.int64)
        self.host_matrices = list(host_matrices)
        self.host_P = list(host_P)
        self._lmax = {i: float(v) for i, v in enumerate(lmax or ()) if v}
        if rhs is not None and self._perm is not None:
            rhs = np.asarray(rhs)[self._perm]
        self._build_levels(rhs, bottom_inv)
        return self

    def _configure(self, theta, smoother, cheb_degree, dtype, use_pallas,
                   pallas_min_rows, device):
        self.device = torch.device(device)
        on_cuda = self.device.type == "cuda"
        self.theta = theta
        if dtype is None:
            dtype = torch.float32 if on_cuda else torch.float64
        self.dtype = dtype
        # "auto": Chebyshev on CUDA, whose hot op is the SpMV kernel;
        # multicolour GS on the CPU (as the JAX package on TPU / CPU)
        if smoother == "auto":
            smoother = "chebyshev" if on_cuda else "mcgs"
        self.smoother_name = smoother
        self.cheb_degree = int(cheb_degree)
        self._use_pallas = (on_cuda_flag(use_pallas, self.device, "use_pallas")
                            and dtype == torch.float32)
        self._pallas_min_rows = int(pallas_min_rows)
        self._perm = None
        self._perm_dev = self._inv_perm_dev = None
        self._lmax: dict[int, float] = {}
        self._ell_pair = self._ell_pair_fast = None
        self._timer = PhaseTimer(owner="AMGSolver")
        if on_cuda:
            # float32 matmuls (dense levels, bottom inverse) in full float32,
            # never TF32 (the default; set explicitly)
            torch.backends.cuda.matmul.allow_tf32 = False

    def _lmax_of(self, i: int) -> float:
        """lmax of level ``i``, estimated once (smoothed P and the Chebyshev
        interval both need it)."""
        if i not in self._lmax:
            self._lmax[i] = _estimate_lmax(self.host_matrices[i])
        return self._lmax[i]

    @property
    def setup_times(self) -> dict[str, float]:
        """Self seconds of each set-up phase so far (wall seconds less a
        set-up phase nested in it, as the kernel library's load): ``rcm``
        (the reordering), ``coarsening`` (strength and C/F splitting),
        ``interpolation`` (the prolongations and every lmax estimate, which
        smoothed interpolation and Chebyshev both read), ``rap`` (the
        Galerkin products), ``upload`` (the transposes, layouts and copies
        to the device; the float-float operator at the first
        ``solve_refined``) and ``bottom_inverse`` (at the first cycle)."""
        return dict(self._timer.phases)

    def _fast(self, M: HostCSR) -> Optional[CudaELL]:
        if not self._use_pallas or M.shape[0] < self._pallas_min_rows:
            return None
        return CudaELL.build(M, dtype=self.dtype, device=self.device)

    def _build_levels(self, rhs, inv_bottom=None):
        """Ship every level to the device; ``inv_bottom`` (numpy) is the
        bottom operator's inverse, computed here in f64 when None."""
        dtype, device = self.dtype, self.device
        self.levels: List[AMGLevel] = []
        rhs_l = None if rhs is None else np.asarray(rhs, dtype=np.float64)
        n_levels = len(self.host_matrices)
        if self.smoother_name == "chebyshev":
            with self._timer.phase("interpolation"):
                for i in range(n_levels):
                    self._lmax_of(i)
        with self._timer.phase("upload"):
            self._upload_levels(rhs_l, dtype, device, n_levels)
        self._inv_bottom = inv_bottom
        self._coarse_dense_dev = None

    def _upload_levels(self, rhs_l, dtype, device, n_levels):
        """Each level's operators on the device, into ``levels``."""
        for i, M in enumerate(self.host_matrices):
            ell, diag, colors, n_colors, blocks = _to_device_level(
                M, dtype, device, with_colors=(self.smoother_name == "mcgs"))
            lmax = (self._lmax_of(i) if self.smoother_name == "chebyshev"
                    else 0.0)
            P = Pt = P_fast = Pt_fast = Pt_host = None
            if i < len(self.host_P):
                Pt_host = self.host_P[i].transpose()  # once per level
                P = ELLMatrix.from_host_csr(self.host_P[i], dtype=dtype,
                                            device=device)
                Pt = ELLMatrix.from_host_csr(Pt_host, dtype=dtype,
                                             device=device)
                P_fast = self._fast(self.host_P[i])
                Pt_fast = self._fast(Pt_host)
            lvl_rhs = None
            if rhs_l is not None:
                lvl_rhs = to_device(rhs_l, dtype, device)
                if Pt_host is not None:
                    rhs_l = Pt_host.spmv(rhs_l)
            A_dense = None
            if (0 < M.shape[0] <= DENSE_MAX_ROWS and i < n_levels - 1
                    and self._use_pallas):
                # small intermediate levels (the bottom runs the inverse),
                # on the kernel path only, as in the JAX package
                A_dense = to_device(M.to_dense(), dtype, device)
            self.levels.append(
                AMGLevel(A=ell, diag=diag, color=colors, n_colors=n_colors,
                         P=P, Pt=Pt, rhs=lvl_rhs, lmax=lmax,
                         color_blocks=blocks, A_fast=self._fast(M),
                         P_fast=P_fast, Pt_fast=Pt_fast, A_dense=A_dense))

    @property
    def _coarse_dense(self) -> torch.Tensor:
        """Dense inverse of the coarsest operator for the direct bottom
        solve: one matvec per cycle, inverted once on the host in f64 at
        the first use (a solver that never cycles, as ``amg_debug``'s
        one-level smoother, never pays the O(n^3) inversion)."""
        if self._coarse_dense_dev is None:
            with self._timer.phase("bottom_inverse"):
                inv = self._inv_bottom
                if inv is None:
                    bottom = self.host_matrices[-1].to_dense()
                    try:
                        inv = np.linalg.inv(bottom)
                    except np.linalg.LinAlgError:
                        # a (numerically) singular bottom operator must not
                        # kill setup; the outer cycle corrects the
                        # inconsistent part
                        inv = np.linalg.pinv(bottom)
                self._coarse_dense_dev = to_device(inv, self.dtype,
                                                   self.device)
            self._inv_bottom = None
        return self._coarse_dense_dev

    # -- diagnostics ---------------------------------------------------------

    @property
    def level_sizes(self) -> list[int]:
        return [M.shape[0] for M in self.host_matrices]

    @property
    def operator_complexity(self) -> float:
        return sum(M.nnz for M in self.host_matrices) / self.host_matrices[0].nnz

    # -- solve: standard residual-correction V-cycle -------------------------

    def _smooth(self, lvl: AMGLevel, x, b, sweeps: int):
        """``sweeps`` sweeps from ``x`` (None: zero) on ``A x = b``."""
        if x is None and (self.smoother_name != "chebyshev" or sweeps == 0):
            x = torch.zeros_like(b)
        for _ in range(sweeps):
            if self.smoother_name == "mcgs":
                x = mc_gs_sweep(lvl, x, b)
            elif self.smoother_name == "chebyshev":
                x = chebyshev_smooth(lvl, x, b, degree=self.cheb_degree)
            else:
                x = jacobi_sweep(lvl, x, b)
        return x

    def _vcycle_impl(self, x, b, nu1=1, nu2=1, _level=0):
        """One V(nu1, nu2) cycle from ``x`` (None: zero, as each coarse
        level starts)."""
        lvl = self.levels[_level]
        if _level == len(self.levels) - 1:
            with span(SPAN_BOTTOM):
                return self._coarse_dense @ b  # the precomputed inverse
        names = level_spans(_level)
        with span(names.pre_smooth):
            x = self._smooth(lvl, x, b, nu1)
        with span(names.residual):
            r = residual_A(lvl, x, b)
        with span(names.restrict):
            bc = apply_Pt(lvl, r)
        xc = self._vcycle_impl(None, bc, nu1, nu2, _level + 1)
        with span(names.prolong_add):
            x = prolong_add(lvl, x, xc)
        with span(names.post_smooth):
            return self._smooth(lvl, x, b, nu2)

    def vcycle(self, x, b, nu1: int = 1, nu2: int = 1):
        """One V(nu1, nu2) cycle in the internal (permuted) frame."""
        return self._vcycle_impl(x, b, nu1, nu2)

    def _solve_impl(self, x, b, tol, maxit):
        b2 = torch.sum(b * b)

        def rel_of(rn2):
            return torch.sqrt(torch.where(b2 > 0, rn2 / b2,
                                          torch.zeros_like(rn2)))

        def rn2_of(x):
            r = residual_A(self.levels[0], x, b)
            return torch.sum(r * r)

        hist = torch.full((HIST_CAP + 1,), float("nan"), dtype=b.dtype,
                          device=b.device)
        tol_t = torch.full((), tol, dtype=b.dtype, device=b.device)
        stop = tol_t * tol_t * b2
        k = 0
        with span(SPAN_FETCH):
            rn2 = rn2_of(x)
            hist[0] = rel_of(rn2)
            go = k < maxit and fetch(rn2 > stop)
        while go:
            with span(SPAN_CYCLE):
                x = self._vcycle_impl(x, b)
            k += 1
            with span(SPAN_FETCH):
                rn2 = rn2_of(x)
                hist[min(k, HIST_CAP)] = rel_of(rn2)
                go = k < maxit and fetch(rn2 > stop)
        return x, k, rel_of(rn2), hist

    # -- permutation translation (internal RCM frame <-> caller frame) -------

    def _perm_in(self, v):
        if self._perm is None:
            return v
        if isinstance(v, torch.Tensor):
            if self._perm_dev is None:
                self._perm_dev = to_device(self._perm, torch.int64,
                                           self.device)
            return v.index_select(0, self._perm_dev)
        return np.asarray(v)[self._perm]

    def _perm_out(self, x):
        if self._perm is None:
            return x
        if isinstance(x, torch.Tensor):
            if self._inv_perm_dev is None:
                inv = np.empty_like(self._perm)
                inv[self._perm] = np.arange(self._perm.size)
                self._inv_perm_dev = to_device(inv, torch.int64, self.device)
            return x.index_select(0, self._inv_perm_dev)
        out = np.empty_like(np.asarray(x))
        out[self._perm] = np.asarray(x)
        return out

    def _on_device(self, v, name):
        """``v`` unchanged if numpy, else checked to lie on the solver's
        device (devices are explicit: a tensor elsewhere is refused)."""
        if isinstance(v, torch.Tensor) and (
                v.device.type != self.device.type
                or (self.device.index is not None
                    and v.device.index != self.device.index)):
            raise ValueError(f"{name} is on {v.device}, the solver on "
                             f"{self.device}")
        return v

    def _input(self, v, name):
        """``v`` (numpy or a tensor on the solver's device) in the internal
        frame, as a tensor of the solve dtype on the device."""
        v = self._perm_in(self._on_device(v, name))
        if isinstance(v, torch.Tensor):
            return v.to(self.dtype)
        return to_device(v, self.dtype, self.device)

    @staticmethod
    def _result(x, k, rel, hist):
        """The result of ``k`` iterations, ``x`` in the caller's frame; the
        history and ``rel`` come to the host in one copy."""
        n = min(k, HIST_CAP) + 1
        host = torch.cat([hist[:n], rel.reshape(1).to(hist.dtype)]).cpu()
        host = host.numpy()
        return AMGSolveResult(x, k, float(host[-1]), host[:-1],
                              history_truncated=k > HIST_CAP)

    def solve(self, b, x0=None, tol: float = 1e-10, maxit: int = 100):
        """V-cycle iteration to relative residual ``tol``.

        Returns an :class:`AMGSolveResult`: unpacks as ``(x, iterations,
        rel_residual)`` with ``x`` a tensor on the device (caller frame),
        and carries ``.history``.  A right-hand side with a NaN or an
        infinity raises ``ValueError`` (found where the loop stops at its
        first test, which such a ``b`` always makes it do).
        """
        with self._timer.solve_span(SPAN_SOLVE):
            return self._solve(b, x0, tol, maxit)

    def _solve(self, b, x0, tol, maxit):
        with span(SPAN_SPLIT):
            b = self._input(b, "b")
            x0 = torch.zeros_like(b) if x0 is None else self._input(x0, "x0")
        x, k, rel, hist = self._solve_impl(x0, b, tol, maxit)
        if k == 0:
            check_finite(b, "rhs b")
        with span(SPAN_COMBINE):
            return self._result(self._perm_out(x), k, rel, hist)

    def _ff_residual(self):
        """The float-float residual ``(b_hi, b_lo, x_hi, x_lo) -> r`` on the
        finest operator (its pair operator built at the first call)."""
        if self._use_pallas:
            if self._ell_pair_fast is None:
                with self._timer.phase("upload"):
                    self._ell_pair_fast = CudaELL.build(
                        self.host_matrices[0], dtype=torch.float32,
                        pair=True, device=self.device)
            return self._ell_pair_fast.residual_ff
        if self._ell_pair is None:
            with self._timer.phase("upload"):
                self._ell_pair = ELLPair.from_host_csr(self.host_matrices[0],
                                                       device=self.device)

        def residual(b_hi, b_lo, x_hi, x_lo):
            return ell_residual_ff(self._ell_pair, b_hi, b_lo, x_hi, x_lo)
        return residual

    def solve_refined(self, b, tol: float = 1e-10, maxit: int = 100,
                      on_device: bool = False):
        """Iterative refinement with float-float extended-precision
        residuals: the V-cycle runs in the solver's dtype, the outer
        residual ``r = b - A x`` with error-free transformations (the
        kernel of ``CudaELL.residual_ff`` on the kernel path, else
        ``ops/sparse_extended.ell_residual_ff``), the iterate carried as an
        f32 pair.  Returns ``(x, iterations, rel_residual)`` like
        :meth:`solve`, with ``x`` the pair summed on the host in f64 (a
        numpy array), so the extended precision survives the return; with
        ``on_device``, summed in f64 on the device (a tensor there).  A
        non-finite ``b`` raises as in :meth:`solve`."""
        with self._timer.solve_span(SPAN_SOLVE_REFINED):
            return self._solve_refined(b, tol, maxit, on_device)

    def _solve_refined(self, b, tol, maxit, on_device):
        f32 = torch.float32
        with span(SPAN_SPLIT):
            b = self._perm_in(self._on_device(b, "b"))
            residual = self._ff_residual()
            b_hi, b_lo = ff_pair_from_f64(b, device=self.device)
            b2 = torch.sum(b_hi * b_hi)
            # residual carry: ONE extended-precision evaluation per
            # iteration (the one at the end of iteration k is the residual
            # iteration k+1 corrects)
            hist = torch.full((HIST_CAP + 1,), float("nan"), dtype=f32,
                              device=self.device)
            hist[0] = 1.0  # x0 = 0
            x_hi = torch.zeros_like(b_hi)
            x_lo = torch.zeros_like(b_hi)
            tol_t = torch.full((), tol, dtype=f32, device=self.device)
            stop = tol_t * tol_t * b2

        def rel_of(rn2):
            return torch.sqrt(torch.where(b2 > 0, rn2 / b2,
                                          torch.zeros_like(rn2)))

        with span(SPAN_FF_RESIDUAL):
            r = residual(b_hi, b_lo, x_hi, x_lo)
        rn2 = b2
        k = 0
        with span(SPAN_FETCH):
            go = k < maxit and fetch(rn2 > stop)
        while go:
            with span(SPAN_CYCLE):
                e = self._vcycle_impl(None, r.to(self.dtype)).to(f32)
            with span(SPAN_FF_RESIDUAL):
                x_hi, x_lo = ff_add_f(x_hi, x_lo, e)
                r = residual(b_hi, b_lo, x_hi, x_lo)
            k += 1
            with span(SPAN_FETCH):
                rn2 = torch.sum(r * r)
                hist[min(k, HIST_CAP)] = rel_of(rn2)
                go = k < maxit and fetch(rn2 > stop)
        if k == 0:
            check_finite(b, "rhs b")
        with span(SPAN_COMBINE):
            # back to the caller's order (a permutation commutes with the
            # pair sum), the sum in f64 on the device or on the host
            if on_device:
                x = self._perm_out(x_hi.to(torch.float64)
                                   + x_lo.to(torch.float64))
            else:
                x_hi, x_lo = self._perm_out(x_hi), self._perm_out(x_lo)
                x = (x_hi.cpu().numpy().astype(np.float64)
                     + x_lo.cpu().numpy().astype(np.float64))
            return self._result(x, k, rel_of(rn2), hist)

    def solve_p1(self, system, f_nodes, g_nodes, tol: float = 1e-10,
                 maxit: int = 100):
        """Solve a P1 system for nodal data on the device: ``system``
        (``models/fem.P1System``, whose ``A`` this solver was set up on)
        turns nodal ``f`` and ``g`` (tensors on the solver's device) into
        the right-hand side, :meth:`solve_refined` solves for the interior
        with its answer summed on the device (``on_device``), and the
        system puts the nodal field back together.  Returns an
        :class:`AMGSolveResult` whose ``x`` is the nodal field, float64 on
        the device.  The load and the field run on the device just outside
        ``solve_refined``'s root span."""
        g_nodes = self._on_device(g_nodes, "g")
        b = system.load(self._on_device(f_nodes, "f"), g_nodes)
        res = self.solve_refined(b, tol, maxit, on_device=True)
        return AMGSolveResult(system.field(res.x, g_nodes), res.iterations,
                              res.rel_residual, res.history,
                              res.history_truncated)

    def solve_pcg(self, b, x0=None, tol: float = 1e-10, maxit: int = 200):
        """AMG-preconditioned conjugate gradients (one V(1,1) cycle as the
        preconditioner, on ``ops/krylov.cg_arrays``).  Returns
        ``(x, iterations, rel_residual)`` like :meth:`solve`."""
        b = self._input(b, "b")
        x0 = torch.zeros_like(b) if x0 is None else self._input(x0, "x0")
        lvl0 = self.levels[0]
        x, k, rel, hist = cg_arrays(
            lambda v: apply_A(lvl0, v), b, x0=x0, tol=tol, maxit=maxit,
            M=lambda r: self._vcycle_impl(None, r),
            history=True, hist_cap=HIST_CAP)
        return self._result(self._perm_out(x), k, rel, hist)

    # -- reference-compat sawtooth pass --------------------------------------

    def reference_sawtooth_pass(self, x, pre: int = 10, coarse: int = 200,
                                post: int = 10):
        """One pass of the reference's solve scheme
        (``AMG/src/AMG.cpp:277-308``): down-leg {smooth ``pre`` sweeps on
        (A_l, rhs_l); restrict the *solution* ``x_{l+1} = P^T x_l``},
        ``coarse`` sweeps at the bottom, up-leg {``x_l += P x_{l+1}``;
        smooth ``post`` sweeps}.  Needs ``rhs=`` at setup.  The transfers
        run the gather ELL, as in the JAX package."""
        if self.levels[0].rhs is None:
            raise ValueError("reference_sawtooth_pass needs rhs= at setup")
        xs = [self._input(x, "x")]
        L = len(self.levels)
        for l in range(L - 1):
            lvl = self.levels[l]
            xs[l] = self._smooth(lvl, xs[l], lvl.rhs, pre)
            xs.append(lvl.Pt.spmv(xs[l]))
        xs[L - 1] = self._smooth(self.levels[L - 1], xs[L - 1],
                                 self.levels[L - 1].rhs, coarse)
        for l in range(L - 2, -1, -1):
            lvl = self.levels[l]
            xs[l] = xs[l] + lvl.P.spmv(xs[l + 1])
            xs[l] = self._smooth(lvl, xs[l], lvl.rhs, post)
        return self._perm_out(xs[0])

    def residual_norm(self, x, b) -> float:
        r = self._input(b, "b") - self.levels[0].A.spmv(self._input(x, "x"))
        return float(torch.sqrt(torch.sum(r * r)))
