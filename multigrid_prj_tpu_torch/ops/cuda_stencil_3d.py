"""CUDA kernels of the 3D 7-point GMG path, with their plain twins.

Counterpart of ``multigrid_prj_tpu/ops/pallas_stencil_3d.py`` (sources in
``csrc/stencil3d.cu``):

=============================  ========================  ===============
function                       replaces                  bytes per point
=============================  ========================  ===============
``poisson_apply_3d``           ``_apply3d_kernel``       8
``poisson_residual_3d``        ``_residual3d_kernel``    12
``red_black_gauss_seidel_3d``  ``_rbgs3d_color_kernel``  12 per colour
                                                         pass
``jacobi_3d``                  ``_jacobi3d_kernel``      12 per sweep
=============================  ========================  ===============

Arrays are ``(nz, ny, nx)``; ``logical_shape`` gives the live extents of a
padded buffer.  A CPU tensor runs the plain torch twin (``*_plain``, the
Pallas body's operation order: neighbours summed ``N + S + E + W + Zn +
Zs`` left to right, ``b / c`` as a true division); a CUDA tensor launches
the kernel or raises.  There is no fallback.  The JAX wrappers take the
kernels only for aligned f32 shapes; the kernels here take every 3D f32
shape, so on the card they also run the exact-layout levels, where JAX runs
XLA ops.  SOR (``omega != 1``) runs the XLA-order plain smoother and
launches nothing, as the JAX wrapper does.  Each launch adds one to its
``cuda_stencil.LAUNCHES`` entry.  ``ops/cuda_stencil.py`` sends 3D tensors
here.
"""

from __future__ import annotations

import torch

from multigrid_prj_tpu_torch.ops import smoothers as _sm
from multigrid_prj_tpu_torch.ops.cuda_stencil import (
    LAUNCHES,
    _lib,
    _ptr,
    _raise_on,
    _stream,
)
from multigrid_prj_tpu_torch.ops.stencil import boundary_mask

# (1.0 / 6.0) rounded once to f32, as the Pallas bodies' weakly typed
# constant; the kernels get it as a float argument
_INV6 = 1.0 / 6.0


def _logical3d(shape, logical_shape):
    if logical_shape is None:
        return tuple(shape)
    logical = tuple(int(s) for s in logical_shape)
    if len(logical) != 3 or not all(2 <= lg <= n
                                    for lg, n in zip(logical, shape)):
        raise ValueError(f"logical shape {logical} does not fit "
                         f"{tuple(shape)}")
    return logical


def _check_cuda3d(name, *tensors):
    """Raise on what the 3D kernels do not take: they need contiguous 3D
    f32 tensors of one shape on one CUDA device."""
    t0 = tensors[0]
    if t0.dtype != torch.float32:
        raise NotImplementedError(
            f"{name}: the CUDA kernels take float32, got {t0.dtype} "
            "(ROADMAP.md queue A item 9a)")
    for t in tensors:
        if (t.ndim != 3 or t.device != t0.device or t.dtype != t0.dtype
                or t.shape != t0.shape):
            raise ValueError(f"{name}: operands must be 3D and agree in "
                             f"device, dtype and shape ({t.device}, "
                             f"{t.dtype}, {tuple(t.shape)})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    if t0.shape[0] > 65535:
        raise ValueError(f"{name}: nz = {t0.shape[0]} exceeds the launch "
                         "grid's z limit (65535)")


def _dims(u, logical_shape):
    """(nz, ny, nx, nzl, nyl, nxl) kernel arguments."""
    return (*u.shape, *_logical3d(u.shape, logical_shape))


def _neighbor_sum(x):
    """((((N + S) + E) + W) + Zn) + Zs at (z, y -/+ 1, x), (z, y, x +/- 1),
    (z -/+ 1, y, x); wrapped edge values are only read at boundary
    points."""
    return (torch.roll(x, 1, 1) + torch.roll(x, -1, 1)
            + torch.roll(x, -1, 2) + torch.roll(x, 1, 2)
            + torch.roll(x, 1, 0) + torch.roll(x, -1, 0))


def _b_over_c(b, c):
    """``b / c`` as a true division on every device (a 0-dim tensor
    divisor: torch on CUDA divides by a Python scalar as a multiply by its
    rounded reciprocal)."""
    return b / torch.full((), c, dtype=b.dtype, device=b.device)


# ---------------------------------------------------------------------------
# operator apply and residual
# ---------------------------------------------------------------------------


def poisson_apply_3d_plain(u, alpha, h, logical_shape=None):
    """Twin of the apply kernel: ``where(boundary, u, c * (6u - nb))``."""
    c = alpha / (h * h)
    bnd = boundary_mask(u.shape, logical_shape, u.device)
    return torch.where(bnd, u, c * (6.0 * u - _neighbor_sum(u)))


def poisson_apply_3d(u, alpha, h, logical_shape=None):
    """Fused 7-point ``y = A u`` (identity at Dirichlet rows)."""
    if u.device.type == "cpu":
        return poisson_apply_3d_plain(u, alpha, h, logical_shape)
    _check_cuda3d("poisson_apply_3d", u)
    y = torch.empty_like(u)
    _raise_on(_lib().mg_apply3d(_ptr(u), _ptr(y), *_dims(u, logical_shape),
                                alpha / (h * h), _stream()), "apply3d")
    LAUNCHES["apply3d"] += 1
    return y


def poisson_residual_3d_plain(u, b, alpha, h, logical_shape=None):
    """Twin of the residual kernel: ``b - poisson_apply_3d_plain(u)``."""
    return b - poisson_apply_3d_plain(u, alpha, h, logical_shape)


def poisson_residual_3d(u, b, alpha, h, logical_shape=None):
    """Fused 7-point ``r = b - A u``."""
    if u.device.type == "cpu":
        return poisson_residual_3d_plain(u, b, alpha, h, logical_shape)
    _check_cuda3d("poisson_residual_3d", u, b)
    r = torch.empty_like(u)
    _raise_on(_lib().mg_residual3d(_ptr(u), _ptr(b), _ptr(r),
                                   *_dims(u, logical_shape), alpha / (h * h),
                                   _stream()), "residual3d")
    LAUNCHES["residual3d"] += 1
    return r


# ---------------------------------------------------------------------------
# smoothers
# ---------------------------------------------------------------------------


def red_black_gauss_seidel_3d_plain(u, b, alpha, h, sweeps: int = 1,
                                    logical_shape=None):
    """Twin of the RB-GS kernel, per colour (0 first), out of place as the
    Pallas pass: ``gs = (b / c + nb) * (1/6)``; ``x <- where(parity ==
    colour & ~boundary, gs, x)``; ``x <- where(boundary, b, x)``."""
    c = alpha / (h * h)
    bnd = boundary_mask(u.shape, logical_shape, u.device)
    parity = _sm._parity(u.shape, u.device)
    b_over_c = _b_over_c(b, c)
    x = u
    for _ in range(sweeps):
        for color in (0, 1):
            gs = (b_over_c + _neighbor_sum(x)) * _INV6
            x = torch.where((parity == color) & ~bnd, gs, x)
            x = torch.where(bnd, b, x)
    return x


def red_black_gauss_seidel_3d(u, b, alpha, h, sweeps: int = 1,
                              omega: float = 1.0, logical_shape=None):
    """``sweeps`` RB-GS sweeps (3D parity ``z + y + x``), one launch per
    colour half-sweep.  The kernel is ``omega == 1`` only: SOR runs the
    XLA-order plain smoother on every device and is no launch."""
    if omega != 1.0:
        return _sm.red_black_gauss_seidel(u, b, alpha, h, sweeps=sweeps,
                                          omega=omega,
                                          logical_shape=logical_shape)
    if u.device.type == "cpu":
        return red_black_gauss_seidel_3d_plain(u, b, alpha, h, sweeps,
                                               logical_shape)
    _check_cuda3d("red_black_gauss_seidel_3d", u, b)
    dims = _dims(u, logical_shape)
    c = alpha / (h * h)
    fn = _lib().mg_rbgs3d_color
    # the kernel updates in place: work on a clone so ``u`` is not mutated
    x = u.clone()
    for _ in range(sweeps):
        for color in (0, 1):
            _raise_on(fn(_ptr(x), _ptr(b), *dims, c, _INV6, color,
                         _stream()), "rbgs3d_color")
            LAUNCHES["rbgs3d_color"] += 1
    return x


def jacobi_3d_plain(u, b, alpha, h, omega: float = 1.0, sweeps: int = 1,
                    logical_shape=None):
    """Twin of the Jacobi kernel, per sweep ``jac = (b / c + nb) * (1/6)``;
    if ``omega != 1``, ``jac <- (1 - omega) * x + omega * jac``;
    ``x <- where(boundary, b, jac)`` (not ``ops/smoothers.jacobi``, which
    divides the sum by 6 and sums the neighbours in another order)."""
    c = alpha / (h * h)
    bnd = boundary_mask(u.shape, logical_shape, u.device)
    b_over_c = _b_over_c(b, c)
    x = u
    for _ in range(sweeps):
        jac = (b_over_c + _neighbor_sum(x)) * _INV6
        if omega != 1.0:
            jac = (1.0 - omega) * x + omega * jac
        x = torch.where(bnd, b, jac)
    return x


def jacobi_3d(u, b, alpha, h, omega: float = 1.0, sweeps: int = 1,
              logical_shape=None):
    """``sweeps`` damped-Jacobi sweeps: one out-of-place launch per sweep,
    ping-ponging two scratch buffers (``u`` is only read)."""
    if u.device.type == "cpu":
        return jacobi_3d_plain(u, b, alpha, h, omega, sweeps, logical_shape)
    _check_cuda3d("jacobi_3d", u, b)
    if sweeps < 1:
        return u.clone()
    dims = _dims(u, logical_shape)
    c = alpha / (h * h)
    fn = _lib().mg_jacobi3d
    bufs = [torch.empty_like(u) for _ in range(min(sweeps, 2))]
    x = u
    for s in range(sweeps):
        y = bufs[s % 2]
        _raise_on(fn(_ptr(x), _ptr(b), _ptr(y), *dims, c, _INV6,
                     int(omega != 1.0), 1.0 - omega, omega, _stream()),
                  "jacobi3d")
        LAUNCHES["jacobi3d"] += 1
        x = y
    return x
