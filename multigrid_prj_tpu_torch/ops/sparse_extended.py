"""Float-float ("ff32") extended precision for the sparse (ELL) path (port
of ``multigrid_prj_tpu/ops/sparse_extended.py``).

A plain-f32 AMG V-cycle stalls at a relative residual ``~eps_f32 *
kappa(A)``.  The residual ``r = b - A x`` is therefore evaluated with
error-free transformations: Dekker's ``two_prod`` with Veltkamp splitting
for each product and a cascaded Knuth ``two_sum`` over the K ELL slots,
with the matrix (``vals = hi + lo``), ``b`` and the iterate carried as f32
pairs.  Each line below is a separate torch op, so each result is rounded
on its own and nothing is contracted into an FMA.

``ell_residual_ff`` is the gather form (slot loop over ``ELLPair``'s row
layout) that the AMG solver runs when the kernel path is off; with it on,
``ops/cuda_spmv.CudaELL.residual_ff`` runs the same chain in one kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from multigrid_prj_tpu_torch.ops.extended import fast_two_sum, two_sum
from multigrid_prj_tpu_torch.ops.sparse import HostCSR, _ell_slots, to_device

_SPLIT = 4097.0  # 2^12 + 1: Veltkamp split constant for f32 (24-bit mantissa)


def veltkamp_split(a):
    """Exact split ``a = hi + lo`` with both halves ~12-bit mantissas."""
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Dekker exact product: returns (p, err) with ``a * b == p + err``."""
    p = a * b
    ah, al = veltkamp_split(a)
    bh, bl = veltkamp_split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


@dataclasses.dataclass
class ELLPair:
    """ELL matrix carried as an f32 pair ``vals_hi + vals_lo`` (column ids
    shared; padding slots at column 0 with value 0), re-quantized from the
    f64 host values at setup."""

    cols: torch.Tensor  # (n, K) int32
    vals_hi: torch.Tensor  # (n, K) f32
    vals_lo: torch.Tensor  # (n, K) f32
    shape: Tuple[int, int]

    @staticmethod
    def from_host_csr(csr: HostCSR, device="cuda") -> "ELLPair":
        k = int(csr.row_lengths.max()) if csr.shape[0] else 0
        cols, v64 = _ell_slots(csr, k)
        hi = v64.astype(np.float32)
        lo = (v64 - hi.astype(np.float64)).astype(np.float32)
        return ELLPair(cols=to_device(cols, torch.int32, device),
                       vals_hi=to_device(hi, device=device),
                       vals_lo=to_device(lo, device=device), shape=csr.shape)


def ell_residual_ff(A: ELLPair, b_hi, b_lo, x_hi, x_lo):
    """Extended-precision ``r = b - A x`` for an ELL pair matrix.

    All arrays f32; returns the f32 residual with the cancellation resolved
    in ~2^-48 relative precision instead of 2^-24.
    """
    g_hi = x_hi[A.cols]  # (n, K)
    g_lo = x_lo[A.cols]
    p, e = two_prod(A.vals_hi, g_hi)
    # first-order small terms (their own roundoff is ~eps^2 -- negligible)
    e = e + A.vals_hi * g_lo + A.vals_lo * g_hi
    acc_hi, acc_lo = b_hi, b_lo
    for k in range(p.shape[1]):  # cascaded exact accumulation over ELL slots
        s, err = two_sum(acc_hi, -p[:, k])
        err = err + (acc_lo - e[:, k])
        acc_hi, acc_lo = fast_two_sum(s, err)
    return acc_hi + acc_lo


def ff_pair_from_f64(v, device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """Split an f64 vector (numpy, or a tensor on any device) into an f32
    ``(hi, lo)`` pair on ``device``.  A tensor is split in f64 where it
    lies (``v - hi`` is exact in f64, and each rounding to f32 is correctly
    rounded on every device, so the pair is the host split's to the bit)."""
    if isinstance(v, torch.Tensor):
        v = v.detach().to(torch.float64)
        hi = v.to(torch.float32)
        lo = (v - hi.to(torch.float64)).to(torch.float32)
        return hi.to(device), lo.to(device)
    v = np.asarray(v, dtype=np.float64)
    hi = v.astype(np.float32)
    lo = (v - hi.astype(np.float64)).astype(np.float32)
    return to_device(hi, device=device), to_device(lo, device=device)
