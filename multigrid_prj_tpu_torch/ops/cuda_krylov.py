"""CUDA kernels of the conjugate-gradient step, with their plain twins.

``ops/krylov.cg_arrays`` takes its two vector updates as it takes ``A``
and ``M``; the kernel route (``ops/routes.kernel_route``) hands it these,
so each update is one pass (sources in ``csrc/krylov.cu``):

* :func:`cg_xr_update`: ``x + alpha p`` and ``r - alpha Ap`` and the new
  ``r . r`` (``cg_xr_update_kernel``, 24 B a point, then
  ``cg_rr_sum_kernel``, which sums its per-block partials in a fixed
  order);
* :func:`cg_p_update`: ``z + (rz1 / rz) p`` (``cg_p_update_kernel``, 12 B a
  point).

They replace no TPU kernel: the JAX package leaves CG's vector arithmetic
to XLA, and torch runs each update as a multiply and an add kernel.  The
scalars ``alpha``, ``rz1`` and ``rz`` stay on the device.  The kernels
round as the plain ops do, so ``x``, ``r`` and ``p`` are bit-equal to the
twins; ``r . r`` is summed in another order than ``torch.vdot`` and agrees
with it to f32 round-off, the same from run to run.

A CPU tensor runs the twin, ``ops/krylov``'s plain step (today's
expressions in today's order, new tensors); a CUDA tensor launches the
kernel or raises.  On the card the kernels write in place: ``r`` and ``p``
always, ``x`` when ``x_owned`` (else into a new buffer), and they refuse
outputs that overlap their other operands.  Any contiguous float32 vector
of one shape is taken, 2D, 3D or 1D.  Each launch adds one to its
``cuda_stencil.LAUNCHES`` entry (``cg_xr_update``, ``cg_rr_sum``,
``cg_p_update``).
"""

from __future__ import annotations

import functools

import torch

from multigrid_prj_tpu_torch.ops import krylov as _kr
from multigrid_prj_tpu_torch.ops.cuda_stencil import (
    LAUNCHES,
    _lib,
    _ptr,
    _raise_on,
    _refuse_overlap,
    _stream,
)

_THREADS = 256  # csrc/krylov.cu's kThreads
_BLOCKS_PER_SM = 8  # and kBlocksPerSm: one resident wave

cg_xr_update_plain = _kr.cg_xr_step
cg_p_update_plain = _kr.cg_p_step


@functools.cache
def _max_blocks(index: int) -> int:
    return _BLOCKS_PER_SM * torch.cuda.get_device_properties(
        index).multi_processor_count


def _grid(v: torch.Tensor, vec: bool) -> int:
    """Blocks of the grid-stride loop over ``v``: one thread per 16-byte
    vector (per point when ``vec`` is False), at most one resident wave."""
    n = v.numel()
    items = -(-n // 4) if vec else n
    return max(1, min(-(-items // _THREADS), _max_blocks(v.device.index)))


def _check(name, vectors, scalars):
    """Raise on what the kernels do not take: float32 contiguous vectors of
    one shape and 0-dim (one-element) float32 scalars, all on one CUDA
    device.  Returns whether every vector is 16-byte aligned."""
    dev = vectors[0].device
    for t in (*vectors, *scalars):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{name}: operands must be float32 on one "
                             f"device, got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    for v in vectors:
        if v.shape != vectors[0].shape:
            raise ValueError(f"{name}: vectors differ in shape "
                             f"({tuple(v.shape)}, {tuple(vectors[0].shape)})")
    for s in scalars:
        if s.numel() != 1:
            raise ValueError(f"{name}: a scalar operand has {s.numel()} "
                             "elements")
    return all(v.data_ptr() % 16 == 0 for v in vectors)


def cg_xr_update(x, r, p, Ap, alpha, x_owned=False):
    """One CG step's ``x' = x + alpha p``, ``r' = r - alpha Ap`` and
    ``r' . r'`` (a 0-dim tensor), as :func:`ops.krylov.cg_xr_step`:
    returns ``(x', r', r' . r')``.  On the card ``r'`` is written into
    ``r``, and ``x'`` into ``x`` when ``x_owned`` (else into a new
    buffer)."""
    if x.device.type == "cpu":
        return cg_xr_update_plain(x, r, p, Ap, alpha, x_owned)
    vec = _check("cg_xr_update", (x, r, p, Ap), (alpha,))
    x_out = x if x_owned else torch.empty_like(x)
    _refuse_overlap("cg_xr_update", (x_out, r),
                    (p, Ap, alpha) if x_owned else (x, p, Ap, alpha))
    blocks = _grid(x, vec)
    partials = torch.empty(blocks, dtype=torch.float32, device=x.device)
    rr = torch.empty((), dtype=torch.float32, device=x.device)
    _raise_on(_lib().mg_cg_xr_update(
        _ptr(x), _ptr(x_out), _ptr(r), _ptr(p), _ptr(Ap), _ptr(alpha),
        _ptr(partials), _ptr(rr), x.numel(), blocks, int(vec), _stream()),
        "cg_xr_update")
    LAUNCHES["cg_xr_update"] += 1
    LAUNCHES["cg_rr_sum"] += 1
    return x_out, r, rr


def cg_p_update(z, p, rz1, rz):
    """One CG step's new direction ``z + (rz1 / rz) p``, as
    :func:`ops.krylov.cg_p_step`; on the card written into ``p``."""
    if z.device.type == "cpu":
        return cg_p_update_plain(z, p, rz1, rz)
    vec = _check("cg_p_update", (z, p), (rz1, rz))
    _refuse_overlap("cg_p_update", (p,), (z, rz1, rz))
    blocks = _grid(p, vec)
    _raise_on(_lib().mg_cg_p_update(
        _ptr(z), _ptr(p), _ptr(rz1), _ptr(rz), p.numel(), blocks, int(vec),
        _stream()), "cg_p_update")
    LAUNCHES["cg_p_update"] += 1
    return p
