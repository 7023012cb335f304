"""CUDA kernels of the 3D 7-point GMG path, with their plain twins.

Counterpart of ``multigrid_prj_tpu/ops/pallas_stencil_3d.py`` (sources in
``csrc/stencil3d.cu``):

=============================  ========================  ===============
function                       replaces                  bytes per point
=============================  ========================  ===============
``poisson_apply_3d``           ``_apply3d_kernel``       8
``poisson_residual_3d``        ``_residual3d_kernel``    12 (a z-chunked
                                                         march)
``red_black_gauss_seidel_3d``  ``_rbgs3d_color_kernel``  12 per group of
                                                         <= 4 sweeps
``jacobi_3d``                  ``_jacobi3d_kernel``      12 per sweep
=============================  ========================  ===============

Arrays are ``(nz, ny, nx)``; ``logical_shape`` gives the live extents of a
padded buffer.  A CPU tensor runs the plain torch twin (``*_plain``, the
Pallas body's operation order: neighbours summed ``N + S + E + W + Zn +
Zs`` left to right, ``b / c`` as a true division); a CUDA tensor launches
the kernel or raises.  There is no fallback.  The JAX wrappers take the
kernels only for aligned f32 shapes; the kernels here take every 3D f32
shape, so on the card they also run the exact-layout levels, where JAX runs
XLA ops.  The smoother (``rbgs3d_fused``) takes one of two launch shapes
by the array's size alone: a z-marching tile (:func:`rbgs3d_tile`), one
launch per group of <= 4 sweeps, or, for arrays of at most
``RESIDENT_MAX_POINTS`` points (the 17^3 bottom of a V-cycle), every sweep
in one launch with the array resident in shared memory.  SOR (``omega !=
1``) runs the XLA-order plain smoother and launches nothing, as the JAX
wrapper does.  Each launch adds one to its ``cuda_stencil.LAUNCHES`` entry.
``ops/cuda_stencil.py`` sends 3D tensors here.
"""

from __future__ import annotations

import torch

from multigrid_prj_tpu_torch.ops import smoothers as _sm
from multigrid_prj_tpu_torch.ops.cuda_stencil import (
    LAUNCHES,
    _groups,
    _lib,
    _pingpong,
    _ptr,
    _raise_on,
    _stream,
)
from multigrid_prj_tpu_torch.ops.stencil import boundary_mask

# (1.0 / 6.0) rounded once to f32, as the Pallas bodies' weakly typed
# constant; the kernels get it as a float argument
_INV6 = 1.0 / 6.0
# the z-marching tile (csrc/stencil3d.cu Zm<P>): rows up to 4 passes and
# above, 32 columns (16 column pairs: one lane each); consecutive passes run
# _RB3_LAG planes apart, and planes are loaded _RB3_AHEAD steps ahead
_RB3_TILE_ROWS = (32, 32)
_RB3_TILE_COLS = 32
_RB3_LAG = 2
_RB3_AHEAD = 3
# arrays of at most this many points smooth with u and b resident in one
# block's shared memory (csrc/stencil3d.cu kResidentMaxPoints), every sweep
# in one launch; the C entry point refuses another cap or a larger array
RESIDENT_MAX_POINTS = 16384
# the residual's z-chunked march (csrc/stencil3d.cu kR3*): x-y tiles of 64
# columns by 8 rows, a thread per (y, x) column walking a chunk of at most
# 32 planes, 4 planes in flight; the chunk is chosen so that every level
# launches about 528 blocks (4 per SM of an H100) where it has the planes
_R3_TILE = (64, 8)
_R3_AHEAD = 4
_R3_MAX_CHUNK = 32
_R3_TARGET_BLOCKS = 528


def rbgs3d_tile(passes: int):
    """Geometry of the z-marching tile of ``csrc/stencil3d.cu``
    (``Zm<P>``) for ``passes`` dependent colour passes (2 per sweep):
    ``(row halo, column halo, tile rows, tile columns, u ring planes, b
    ring planes)``.  The x-y halo is one ring per pass on each side.  The
    passes of a step run ``_RB3_LAG`` planes apart in z, over a span of
    ``_RB3_LAG * (passes - 1)`` planes, so the u ring holds the span + 3
    planes they read (the lowest also being stored) and the
    ``_RB3_AHEAD`` planes in flight; the b ring each pass's plane, the
    plane that landed and those in flight.  The C entry point refuses a
    geometry other than the one compiled."""
    if not 0 < passes <= 8 or passes % 2:
        raise ValueError(f"the z-marching tile takes 2, 4, 6 or 8 passes, "
                         f"got {passes}")
    rows = _RB3_TILE_ROWS[passes > 4]
    span = _RB3_LAG * (passes - 1)
    return (passes, passes, rows, _RB3_TILE_COLS, span + 3 + _RB3_AHEAD,
            span + 2 + _RB3_AHEAD)


def residual3d_tile(shape):
    """Geometry of the residual's z-chunked march of ``csrc/stencil3d.cu``
    (``residual3d_march_kernel``) for an ``(nz, ny, nx)`` array: ``(tile
    columns, tile rows, planes per chunk, planes in flight)``.  A block
    walks one x-y tile through one chunk of planes; the chunk is
    ``ceil(nz * tiles / 528)`` clamped to 1 .. 32, so that small levels
    still launch several blocks per SM.  The C entry point refuses any
    other geometry."""
    nz, ny, nx = (int(s) for s in shape)
    tx, ty = _R3_TILE
    tiles = -(-nx // tx) * -(-ny // ty)
    zc = min(max(-(-nz * tiles // _R3_TARGET_BLOCKS), 1), _R3_MAX_CHUNK)
    return tx, ty, zc, _R3_AHEAD


def _geometry3d(passes):
    import ctypes

    return (ctypes.c_int * 6)(*rbgs3d_tile(passes))


def rbgs3d_route(shape) -> str:
    """The smoother's launch shape for an array of ``shape``: ``"resident"``
    (the whole array in one block's shared memory, every sweep in one
    launch) up to ``RESIDENT_MAX_POINTS`` points, else ``"zmarch"`` (the
    z-marching tile, one launch per group of <= 4 sweeps)."""
    npts = int(shape[0]) * int(shape[1]) * int(shape[2])
    return "resident" if npts <= RESIDENT_MAX_POINTS else "zmarch"


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
    # the one-thread-per-point kernels launch a block row per plane; the
    # residual's march (a block per chunk) would take 32x more, but one
    # limit for every 3D kernel keeps a solve from failing half-way
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
    """Fused 7-point ``r = b - A u``: one launch of the z-chunked march
    (:func:`residual3d_tile`)."""
    if u.device.type == "cpu":
        return poisson_residual_3d_plain(u, b, alpha, h, logical_shape)
    return _residual3d_launch(u, b, alpha, h, logical_shape, "residual3d")


def _residual3d_launch(u, b, alpha, h, logical_shape, kernel):
    """One launch of ``kernel``: ``residual3d`` (the z-chunked march) or
    ``residual3d_point`` (the one-thread-per-point kernel it replaced, which
    only ``chip_smoke.py`` calls, to hold the march to it and time the
    two)."""
    import ctypes

    _check_cuda3d("poisson_residual_3d", u, b)
    r = torch.empty_like(u)
    geom = ([(ctypes.c_int * 4)(*residual3d_tile(u.shape))]
            if kernel == "residual3d" else [])
    _raise_on(getattr(_lib(), f"mg_{kernel}")(
        _ptr(u), _ptr(b), _ptr(r), *_dims(u, logical_shape), alpha / (h * h),
        *geom, _stream()), kernel)
    LAUNCHES[kernel] += 1
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
    """``sweeps`` RB-GS sweeps (3D parity ``z + y + x``), out of place
    (``u`` is only read, never cloned; ``sweeps == 0`` returns a copy), on
    the launch shape :func:`rbgs3d_route` picks: every sweep in one launch
    with the array resident in shared memory, or one z-marching launch per
    group of at most 4 sweeps, the groups ping-ponging two scratch tensors.
    The kernels are ``omega == 1`` only: SOR runs the XLA-order plain
    smoother on every device and is no launch."""
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
    if rbgs3d_route(u.shape) == "resident":
        fn = _lib().mg_rbgs3d_resident

        def launch(x, y, s):
            _raise_on(fn(_ptr(x), _ptr(b), _ptr(y), *dims, c, _INV6, s,
                         RESIDENT_MAX_POINTS, _stream()), "rbgs3d_fused")
            LAUNCHES["rbgs3d_fused"] += 1

        return _pingpong(u, [sweeps] if sweeps > 0 else [], launch)
    fn = _lib().mg_rbgs3d_fused

    def launch(x, y, s):
        _raise_on(fn(_ptr(x), _ptr(b), _ptr(y), *dims, c, _INV6, s,
                     _geometry3d(2 * s), _stream()), "rbgs3d_fused")
        LAUNCHES["rbgs3d_fused"] += 1

    return _pingpong(u, _groups(sweeps), launch)


def _rbgs3d_per_colour(u, b, alpha, h, sweeps: int = 1, logical_shape=None):
    """The per-colour oracle of the fused 3D smoother on CUDA float32
    tensors: ``2 * sweeps`` in-place launches of ``rbgs3d_color_kernel`` on
    a clone of ``u`` (the path before the fused kernel).  On no solver
    path: the card's checks hold ``rbgs3d_fused`` to it, and
    ``chip_smoke.py`` times it as the path the fused kernel replaced."""
    _check_cuda3d("_rbgs3d_per_colour", u, b)
    if u.device.type != "cuda":
        raise ValueError("_rbgs3d_per_colour launches CUDA kernels only")
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
