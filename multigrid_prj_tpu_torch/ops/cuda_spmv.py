"""CUDA ELL kernels of the AMG solve, with their plain twins.

Counterpart of ``multigrid_prj_tpu/ops/pallas_spmv.py`` (sources in
``csrc/spmv.cu``):

* ``ell_local_spmv`` / ``CudaELL.spmv`` replace ``PallasELL.spmv2d``
  (``_spmv_kernel``, ``_spmv_compact_kernel``, ``_spmv_windowed_kernel``)
  and ``ell_local_spmv2d`` (``_spmv_kernel``): 8 B per slot streamed plus
  the x gather.
* ``ell_ff_residual`` / ``CudaELL.residual_ff`` replace
  ``PallasELL.residual_ff`` (``_ffres_kernel``, ``_ffres_compact_kernel``):
  12 B per slot plus two gathers.
* ``ell_spmm`` / ``CudaELL.spmm`` replace ``PallasELL.spmm`` / ``spmm2d``
  (``_spmm_kernel``): 8 B per slot once for up to 8 vectors, plus the
  gathered rows of ``X``.  ``ELLMatrix.spmm`` stays the plain op, as in
  the JAX package.
* ``ell_spmv_axpy`` (``CudaELL.residual``, ``CudaELL.spmv_add``) and
  ``ell_cheb_step`` (``CudaELL.cheb_step``) replace no TPU kernel: the
  SpMV with the subtraction or addition after it (the AMG cycle's
  residual ``b - A x`` and prolong-add ``x + P e``), and one step of
  ``amg.chebyshev_smooth`` with its vector updates, which the JAX package
  leaves to XLA around the SpMV.  Each is bit-equal to the SpMV followed
  by those torch ops.

One slot-major ELL layout serves every matrix: ``colsT`` (K, n) int32
absolute column ids, ``valsT`` (K, n) f32 (plus ``valsT_lo`` in pair mode);
K is the longest row; a padding slot has value 0 and its row's first
column.  ``CudaELL.build`` takes any sparsity, RCM-ordered or not, square or
rectangular, and never returns None: the TPU layouts' windows, compact
tile lists and int16 relative ids were workarounds for Mosaic's gather and
have no counterpart here.

CPU tensors run the plain torch twin (``*_plain``: the kernel's operation
order per slot, slots taken in order ``k = 0 .. K-1``, each step a separate
torch op); CUDA tensors launch the kernel or raise, and operands
split between the CPU and a card are refused.  There is no fallback.
Each launch adds one to its ``cuda_stencil.LAUNCHES`` entry (``spmv``,
``spmv_axpy``, ``cheb_step``, ``ff_residual_ell``, ``ell_spmm``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from multigrid_prj_tpu_torch.ops.cuda_stencil import (
    LAUNCHES,
    _lib,
    _ptr,
    _raise_on,
    _stream,
)
from multigrid_prj_tpu_torch.ops.sparse import HostCSR, to_device
from multigrid_prj_tpu_torch.ops.sparse_extended import (
    ELLPair,
    ell_residual_ff,
)


def _on_cpu(name, *tensors) -> bool:
    """True when every operand lies on the CPU (the twin runs), False when
    none does (the kernel launches); operands split across devices are
    refused."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if "cpu" in kinds:
        raise ValueError(f"{name}: operands on {sorted(kinds)}")
    return False


def _check_cuda_ell(name, colsT, vals, vecs) -> bool:
    """Whether the twin runs: ``True`` when every operand lies on the CPU,
    ``False`` when the ELL kernels take them (int32 (K, n) column ids, f32
    (K, n) values, f32 1D vectors, all contiguous on one CUDA device);
    anything else raises.  The first test, a few attribute reads per
    operand, passes a solve's launches; the rest only names the fault."""
    dev = colsT.get_device()
    fits = (dev >= 0 and colsT.dtype is torch.int32 and colsT.dim() == 2
            and colsT.is_contiguous() and colsT.shape[1] < 2 ** 31)
    for t in vals if fits else ():
        fits = (t.dtype is torch.float32 and t.get_device() == dev
                and t.shape == colsT.shape and t.is_contiguous())
        if not fits:
            break
    for t in vecs if fits else ():
        fits = (t.dtype is torch.float32 and t.get_device() == dev
                and t.dim() == 1 and t.is_contiguous())
        if not fits:
            break
    if fits:
        return False
    if _on_cpu(name, colsT, *vals, *vecs):
        return True
    for v in (*vals, *vecs):
        if v.dtype != torch.float32:
            raise NotImplementedError(
                f"{name}: the CUDA kernels take float32, got {v.dtype} (the "
                "AMG solver runs other dtypes on the plain gather path)")
    if colsT.dtype != torch.int32 or colsT.ndim != 2:
        raise ValueError(f"{name}: colsT must be a 2D int32 tensor")
    if colsT.shape[1] >= 2 ** 31:
        raise ValueError(f"{name}: {colsT.shape[1]} rows exceed int32")
    for t in (colsT, *vals, *vecs):
        if t.device != colsT.device:
            raise ValueError(f"{name}: operands on {t.device} and "
                             f"{colsT.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    for t in vals:
        if t.shape != colsT.shape:
            raise ValueError(f"{name}: values {tuple(t.shape)} and column "
                             f"ids {tuple(colsT.shape)} differ")
    for t in vecs:
        if t.ndim != 1:
            raise ValueError(f"{name}: vectors must be 1D, got "
                             f"{tuple(t.shape)}")
    return False


# ---------------------------------------------------------------------------
# SpMV
# ---------------------------------------------------------------------------


def ell_spmv_plain(colsT, valsT, x):
    """Twin of the SpMV kernel: ``acc = 0``, then per slot ``acc = acc +
    valsT[k] * x[colsT[k]]``."""
    acc = torch.zeros(colsT.shape[1], dtype=valsT.dtype, device=valsT.device)
    for k in range(colsT.shape[0]):
        acc = acc + valsT[k] * x[colsT[k]]
    return acc


def ell_local_spmv(colsT, valsT, x):
    """``y = A x`` on raw slot-major arrays: ``colsT``/``valsT`` (K, n), ``x``
    (m,) -> ``y`` (n,).  The counterpart of ``ell_local_spmv2d``."""
    if _check_cuda_ell("ell_local_spmv", colsT, (valsT,), (x,)):
        return ell_spmv_plain(colsT, valsT, x)
    K, n = colsT.shape
    y = torch.empty(n, dtype=torch.float32, device=x.device)
    _raise_on(_lib().mg_ell_spmv(colsT.data_ptr(), valsT.data_ptr(),
                                 x.data_ptr(), y.data_ptr(), n, K,
                                 _stream()), "ell_spmv")
    LAUNCHES["spmv"] += 1
    return y


def ell_spmv_axpy_plain(colsT, valsT, x, z, subtract: bool):
    """Twin of the SpMV-and-add kernel: the SpMV twin, then ``z - y`` or
    ``z + y`` as one torch op."""
    y = ell_spmv_plain(colsT, valsT, x)
    return z - y if subtract else z + y


def ell_spmv_axpy(colsT, valsT, x, z, subtract: bool):
    """``z - A x`` (``subtract``) or ``z + A x`` on raw slot-major arrays:
    ``colsT``/``valsT`` (K, n), ``x`` (m,), ``z`` (n,) -> (n,)."""
    if _check_cuda_ell("ell_spmv_axpy", colsT, (valsT,), (x, z)):
        return ell_spmv_axpy_plain(colsT, valsT, x, z, subtract)
    K, n = colsT.shape
    if z.shape != (n,):
        raise ValueError(f"ell_spmv_axpy: z has shape {tuple(z.shape)}, "
                         f"the matrix {n} rows")
    y = torch.empty(n, dtype=torch.float32, device=x.device)
    _raise_on(_lib().mg_ell_spmv_axpy(
        colsT.data_ptr(), valsT.data_ptr(), x.data_ptr(), z.data_ptr(),
        y.data_ptr(), n, K, int(subtract), _stream()), "ell_spmv_axpy")
    LAUNCHES["spmv_axpy"] += 1
    return y


def ell_cheb_step_plain(colsT, valsT, x, b, d, p, c1, c2, first: bool):
    """Twin of the Chebyshev step kernels: ``amg.chebyshev_smooth``'s torch
    ops, ``r = b - A x`` (``x`` None: a zero ``x``), then ``p = (r / d) /
    theta`` on the first step (``c2`` is theta, as a 0-dim tensor: a true
    division) or ``p = c1 p + c2 (r / d)``, and ``x + p``.  Returns ``(p,
    x + p)``."""
    if x is None:
        x = torch.zeros_like(b)
    r = b - ell_spmv_plain(colsT, valsT, x)
    if first:
        p = (r / d) / torch.full((), c2, dtype=r.dtype, device=r.device)
    else:
        p = c1 * p + c2 * (r / d)
    return p, x + p


def ell_cheb_step(colsT, valsT, x, b, d, p, c1: float, c2: float,
                  first: bool):
    """One Chebyshev step on raw slot-major arrays of a square matrix:
    ``x``, ``b``, ``d`` (the diagonal) and ``p`` (n,), ``x`` None for zero,
    ``p`` unused on the first step.  Returns ``(p, x_out)``; on the card
    ``p`` is updated in place (a first step writes a new one) and
    ``x_out`` is new."""
    vecs = (b, d) + ((x,) if x is not None else ()) + \
        ((p,) if not first else ())
    if _check_cuda_ell("ell_cheb_step", colsT, (valsT,), vecs):
        return ell_cheb_step_plain(colsT, valsT, x, b, d, p, c1, c2,
                                   first)
    K, n = colsT.shape
    for v in vecs:
        if v.shape != (n,):
            raise ValueError(f"ell_cheb_step: a vector has shape "
                             f"{tuple(v.shape)}, the matrix {n} rows")
    if first:
        p = torch.empty(n, dtype=torch.float32, device=b.device)
    elif x is None:
        raise ValueError("ell_cheb_step: only the first step takes x = 0")
    x_out = torch.empty(n, dtype=torch.float32, device=b.device)
    _raise_on(_lib().mg_ell_cheb_step(
        colsT.data_ptr(), valsT.data_ptr(),
        None if x is None else x.data_ptr(), b.data_ptr(), d.data_ptr(),
        p.data_ptr(), x_out.data_ptr(), n, K, c1, c2, int(first),
        _stream()), "ell_cheb_step")
    LAUNCHES["cheb_step"] += 1
    return p, x_out


# ---------------------------------------------------------------------------
# SpMM
# ---------------------------------------------------------------------------

# vectors one SpMM launch carries (its accumulators live in registers);
# wider blocks go in chunks, as PallasELL.spmm chunks what VMEM cannot hold
MAX_SPMM_VECTORS = 8


def ell_spmm_plain(colsT, valsT, X):
    """Twin of the SpMM kernel: ``acc = 0``, then per slot ``acc = acc +
    valsT[k][:, None] * X[colsT[k]]``; column by column the SpMV twin."""
    acc = torch.zeros((colsT.shape[1], X.shape[1]), dtype=valsT.dtype,
                      device=valsT.device)
    for k in range(colsT.shape[0]):
        acc = acc + valsT[k][:, None] * X[colsT[k]]
    return acc


def ell_spmm(colsT, valsT, X):
    """``Y = A X`` on raw slot-major arrays: ``colsT``/``valsT`` (K, n),
    ``X`` (m, nvec) -> ``Y`` (n, nvec); up to ``MAX_SPMM_VECTORS`` vectors
    per launch, wider blocks in chunks."""
    if _on_cpu("ell_spmm", colsT, valsT, X):
        return ell_spmm_plain(colsT, valsT, X)
    if X.ndim != 2:
        raise ValueError(f"ell_spmm: X must be 2D, got {tuple(X.shape)}")
    K, n = colsT.shape
    outs = []
    for s in range(0, X.shape[1], MAX_SPMM_VECTORS):
        Xc = X[:, s:s + MAX_SPMM_VECTORS].contiguous()
        _check_cuda_ell("ell_spmm", colsT, (valsT,), (Xc.view(-1),))
        Y = torch.empty((n, Xc.shape[1]), dtype=torch.float32,
                        device=X.device)
        _raise_on(_lib().mg_ell_spmm(_ptr(colsT), _ptr(valsT), _ptr(Xc),
                                     _ptr(Y), n, K, Xc.shape[1], _stream()),
                  "ell_spmm")
        LAUNCHES["ell_spmm"] += 1
        outs.append(Y)
    if not outs:
        return torch.empty((n, 0), dtype=torch.float32, device=X.device)
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# float-float residual
# ---------------------------------------------------------------------------


def ell_ff_residual_plain(colsT, vhT, vlT, b_hi, b_lo, x_hi, x_lo):
    """Twin of the float-float residual kernel: the gather form
    ``sparse_extended.ell_residual_ff`` on the slot-major arrays, which
    runs ``_ffres_kernel``'s operation order per slot (``two_prod`` with
    the Veltkamp splits, ``e + vh*gl + vl*gh``, the cascaded ``two_sum``
    from ``(b_hi, b_lo)`` renormalised by ``fast_two_sum``; each a separate
    torch op, so nothing is contracted)."""
    A = ELLPair(cols=colsT.T, vals_hi=vhT.T, vals_lo=vlT.T,
                shape=(colsT.shape[1], colsT.shape[1]))
    return ell_residual_ff(A, b_hi, b_lo, x_hi, x_lo)


def ell_ff_residual(colsT, vhT, vlT, b_hi, b_lo, x_hi, x_lo):
    """``r = b - A x`` with ``A`` (``vhT + vlT``), ``b`` and ``x`` carried as
    f32 pairs, on raw slot-major arrays (square A); returns f32 ``r``."""
    vecs = (b_hi, b_lo, x_hi, x_lo)
    if _check_cuda_ell("ell_ff_residual", colsT, (vhT, vlT), vecs):
        return ell_ff_residual_plain(colsT, vhT, vlT, b_hi, b_lo, x_hi,
                                     x_lo)
    K, n = colsT.shape
    r = torch.empty(n, dtype=torch.float32, device=x_hi.device)
    _raise_on(_lib().mg_ell_ff_residual(
        colsT.data_ptr(), vhT.data_ptr(), vlT.data_ptr(), x_hi.data_ptr(),
        x_lo.data_ptr(), b_hi.data_ptr(), b_lo.data_ptr(), r.data_ptr(), n,
        K, _stream()), "ell_ff_residual")
    LAUNCHES["ff_residual_ell"] += 1
    return r


# ---------------------------------------------------------------------------
# the matrix
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CudaELL:
    """A sparse matrix in the kernels' slot-major ELL layout on a device
    (the counterpart of ``PallasELL``)."""

    colsT: torch.Tensor  # (K, n) int32 absolute column ids
    valsT: torch.Tensor  # (K, n) f32
    shape: Tuple[int, int]
    nnz: int
    # pair mode: f64(vals) - f32(vals), same layout (for residual_ff)
    valsT_lo: Optional[torch.Tensor] = None

    @staticmethod
    def build(csr: HostCSR, dtype=torch.float32, pair: bool = False,
              device="cuda") -> "CudaELL":
        """Lay ``csr`` out for the kernels (host NumPy, then one copy to
        ``device``).  ``pair=True`` adds the low words for
        :meth:`residual_ff`."""
        n, m = csr.shape
        lengths = csr.row_lengths
        k = int(lengths.max()) if n else 0
        starts = csr.indptr[:-1]
        # padding slots read the row's first column (a column the row
        # touches anyway); empty rows read column 0
        first = np.zeros(n, dtype=np.int64)
        full = lengths > 0
        first[full] = csr.indices[starts[full]]
        colsT = np.empty((k, n), dtype=np.int32)
        valsT = np.zeros((k, n), dtype=np.float64)
        last = max(csr.nnz - 1, 0)
        for s in range(k):  # slot-major directly: one pass per slot
            has = lengths > s
            at = np.minimum(starts + s, last)
            colsT[s] = np.where(has, csr.indices[at], first)
            valsT[s] = np.where(has, csr.data[at], 0.0)
        lo = None
        if pair:
            lo = to_device(valsT - valsT.astype(np.float32).astype(np.float64),
                           torch.float32, device)
        return CudaELL(colsT=to_device(colsT, torch.int32, device),
                       valsT=to_device(valsT, dtype, device),
                       shape=(n, m), nnz=csr.nnz, valsT_lo=lo)

    @property
    def k(self) -> int:
        return self.colsT.shape[0]

    @property
    def nnz_dense(self) -> int:
        """Stored slots including padding (the streamed footprint)."""
        return self.colsT.numel()

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        """``y = A x`` for the logical (m,) vector ``x``."""
        if x.shape != (self.shape[1],):
            raise ValueError(f"x has shape {tuple(x.shape)}, the matrix "
                             f"{self.shape}")
        return ell_local_spmv(self.colsT, self.valsT, x)

    def residual(self, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``b - A x`` in one launch."""
        if x.shape != (self.shape[1],):
            raise ValueError(f"x has shape {tuple(x.shape)}, the matrix "
                             f"{self.shape}")
        return ell_spmv_axpy(self.colsT, self.valsT, x, b, True)

    def spmv_add(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """``z + A x`` in one launch."""
        if x.shape != (self.shape[1],):
            raise ValueError(f"x has shape {tuple(x.shape)}, the matrix "
                             f"{self.shape}")
        return ell_spmv_axpy(self.colsT, self.valsT, x, z, False)

    def cheb_step(self, x, b, d, p, c1: float, c2: float, first: bool):
        """One step of ``amg.chebyshev_smooth`` on this (square) matrix in
        one launch: ``(p, x_out)`` (:func:`ell_cheb_step`)."""
        if self.shape[0] != self.shape[1]:
            raise ValueError(f"cheb_step needs a square matrix, got "
                             f"{self.shape}")
        return ell_cheb_step(self.colsT, self.valsT, x, b, d, p, c1, c2,
                             first)

    def spmm(self, X: torch.Tensor) -> torch.Tensor:
        """Block product ``Y = A X`` for ``X`` of shape ``(m, nvec)``: A
        streams once per launch of up to ``MAX_SPMM_VECTORS`` vectors."""
        if X.ndim != 2 or X.shape[0] != self.shape[1]:
            raise ValueError(f"X has shape {tuple(X.shape)}, the matrix "
                             f"{self.shape}")
        return ell_spmm(self.colsT, self.valsT, X)

    def residual_ff(self, b_hi, b_lo, x_hi, x_lo) -> torch.Tensor:
        """``r = b - A x`` with ``A``, ``b`` and ``x`` as f32 pairs (needs
        ``build(pair=True)`` and a square matrix); returns f32 ``r``."""
        if self.valsT_lo is None:
            raise ValueError("residual_ff needs build(pair=True)")
        if self.shape[0] != self.shape[1]:
            raise ValueError(f"residual_ff needs a square matrix, got "
                             f"{self.shape}")
        for v in (b_hi, b_lo, x_hi, x_lo):
            if v.shape != (self.shape[0],):
                raise ValueError(f"a vector has shape {tuple(v.shape)}, "
                                 f"the matrix {self.shape}")
        return ell_ff_residual(self.colsT, self.valsT, self.valsT_lo, b_hi,
                               b_lo, x_hi, x_lo)
