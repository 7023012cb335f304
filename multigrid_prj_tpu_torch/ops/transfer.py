"""Grid-transfer operators (port of ``multigrid_prj_tpu/ops/transfer.py``).

* ``restrict_inject``: the reference's masked read, ``r[::2, ::2]``.
* ``restrict_full_weighting``: [1/4, 1/2, 1/4] per axis, edge nodes injected.
* ``prolong``: axis-by-axis linear refinement (bilinear in 2D);
  ``prolong_add``: ``u + prolong(e, u.shape)``.
* ``restrict_fw_padded`` / ``prolong_padded``: the same operators on the
  padded layout (fine physical ``P`` <-> coarse ``P/2``), which keeps the
  dead zone at zero.

Plain torch on every device.  These functions are the twins of CUDA
kernels: the 2D padded restriction and prolong-and-add
(``restrict_fw_padded``, ``u + prolong_padded(e)``) of
``ops/cuda_stencil.py``, and the 3D exact-layout restriction and
prolong-and-add (``restrict_full_weighting``, :func:`prolong_add`) of
``ops/cuda_stencil_3d.py``.  Every function returns a new tensor.
"""

from __future__ import annotations

import torch

from multigrid_prj_tpu_torch.ops.stencil import shift_fill_zero


def _ax_slice(a: torch.Tensor, axis: int, lo: int, hi: int | None,
              step: int = 1) -> torch.Tensor:
    sl = [slice(None)] * a.ndim
    sl[axis] = slice(lo, hi, step)
    return a[tuple(sl)]


def restrict_inject(r: torch.Tensor) -> torch.Tensor:
    """Injection: every other node per axis.  On even axes the high-side
    coarse edge is a fake boundary and is zeroed (see :func:`_fw_axis`)."""
    out = r[(slice(None, None, 2),) * r.ndim]
    for ax, n in enumerate(r.shape):
        if n % 2 == 0:
            head = _ax_slice(out, ax, None, -1)
            tail = _ax_slice(out, ax, -1, None)
            out = torch.cat([head, torch.zeros_like(tail)], dim=ax)
    return out.contiguous()


def _fw_axis(a: torch.Tensor, axis: int) -> torch.Tensor:
    """Full weighting along one axis.

    Odd ``n``: coarse interior ``2i`` gets ``0.25 a[2i-1] + 0.5 a[2i] +
    0.25 a[2i+1]``; both edges injected.  Even ``n``: the high-side coarse
    edge is a fake boundary and is zeroed (keeps the cycle a contraction).
    """
    n = a.shape[axis]
    first = _ax_slice(a, axis, 0, 1)
    if n % 2 == 0:
        interior = (0.25 * _ax_slice(a, axis, 1, n - 3, 2)
                    + 0.5 * _ax_slice(a, axis, 2, n - 2, 2)
                    + 0.25 * _ax_slice(a, axis, 3, n - 1, 2))
        return torch.cat([first, interior, torch.zeros_like(first)], dim=axis)
    interior = (0.25 * _ax_slice(a, axis, 1, n - 2, 2)
                + 0.5 * _ax_slice(a, axis, 2, n - 1, 2)
                + 0.25 * _ax_slice(a, axis, 3, n, 2))
    last = _ax_slice(a, axis, n - 1, n)
    return torch.cat([first, interior, last], dim=axis)


def restrict_full_weighting(r: torch.Tensor) -> torch.Tensor:
    """Tensor-product full weighting (edge nodes injected)."""
    for ax in range(r.ndim):
        r = _fw_axis(r, ax)
    return r


def _refine_axis(a: torch.Tensor, axis: int, target: int) -> torch.Tensor:
    """Linear refinement along ``axis`` from ``n`` to ``target`` nodes
    (``2n - 1``: even outputs inject, odd outputs average; ``2n``
    additionally repeats the last node)."""
    n = a.shape[axis]
    if target == n:
        return a
    if target not in (2 * n - 1, 2 * n):
        raise ValueError(f"cannot refine axis of size {n} to {target}")
    head = _ax_slice(a, axis, 0, n - 1)
    mid = 0.5 * (head + _ax_slice(a, axis, 1, n))
    new_shape = list(a.shape)
    new_shape[axis] = 2 * (n - 1)
    inter = torch.stack([head, mid], dim=axis + 1).reshape(new_shape)
    last = _ax_slice(a, axis, n - 1, n)
    parts = [inter, last] + ([last] if target == 2 * n else [])
    return torch.cat(parts, dim=axis)


def prolong(e: torch.Tensor, fine_shape) -> torch.Tensor:
    """Bilinear/trilinear prolongation of ``e`` to ``fine_shape``."""
    if len(fine_shape) != e.ndim:
        raise ValueError("rank mismatch")
    for ax, target in enumerate(fine_shape):
        e = _refine_axis(e, ax, int(target))
    return e


def prolong_add(e: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``u + prolong(e, u.shape)``: the coarse correction added to ``u``."""
    return u + prolong(e, u.shape)


# ---------------------------------------------------------------------------
# Padded layout: logical 2^k+1 grids in aligned buffers whose trailing dead
# zone holds zeros.  The coarse buffer is exactly half the fine one per axis.
# ---------------------------------------------------------------------------


def restrict_fw_padded(r: torch.Tensor, logical_shape) -> torch.Tensor:
    """Full weighting, padded layout: fine physical ``P`` -> coarse ``P/2``.

    Per axis: coarse k <- [1/4, 1/2, 1/4] at fine 2k; edge coarse rows
    (k == 0 and k == nc-1) are injected; dead rows (k >= nc) zeroed.
    """
    for ax, n in enumerate(tuple(logical_shape)):
        nc = (int(n) + 1) // 2
        filtered = (0.25 * shift_fill_zero(r, ax, -1) + 0.5 * r
                    + 0.25 * shift_fill_zero(r, ax, +1))
        samp_f = _ax_slice(filtered, ax, None, None, 2)
        samp_i = _ax_slice(r, ax, None, None, 2)
        view = [1] * r.ndim
        view[ax] = samp_f.shape[ax]
        k = torch.arange(samp_f.shape[ax], device=r.device).view(view)
        out = torch.where((k == 0) | (k == nc - 1), samp_i, samp_f)
        r = torch.where(k >= nc, torch.zeros((), dtype=r.dtype,
                                             device=r.device), out)
    return r


def prolong_padded(e: torch.Tensor) -> torch.Tensor:
    """Linear prolongation, padded layout: coarse physical ``P`` -> ``2 P``.

    Fine 2k <- coarse k, fine 2k+1 <- average of coarse k, k+1 (zero
    shifted in past the end)."""
    for ax in range(e.ndim):
        mid = 0.5 * (e + shift_fill_zero(e, ax, +1))
        new_shape = list(e.shape)
        new_shape[ax] = 2 * e.shape[ax]
        e = torch.stack([e, mid], dim=ax + 1).reshape(new_shape)
    return e


def crop_to(a: torch.Tensor, shape) -> torch.Tensor:
    """The leading ``shape`` region of a padded buffer, as a new tensor."""
    return a[tuple(slice(0, int(s)) for s in shape)].contiguous()


def pad_to(a: torch.Tensor, shape) -> torch.Tensor:
    """Zero-pad ``a`` up to physical ``shape``."""
    if any(int(t) < s for s, t in zip(a.shape, shape)):
        raise ValueError(f"cannot pad {tuple(a.shape)} to smaller {tuple(shape)}")
    out = a.new_zeros(tuple(int(t) for t in shape))
    out[tuple(slice(0, s) for s in a.shape)] = a
    return out
