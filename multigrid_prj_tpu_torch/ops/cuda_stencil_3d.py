"""CUDA kernels of the 3D 7-point GMG path, with their plain twins.

Counterpart of ``multigrid_prj_tpu/ops/pallas_stencil_3d.py`` (sources in
``csrc/stencil3d.cu``):

=============================  ========================  ===============
function                       replaces                  bytes per point
=============================  ========================  ===============
``poisson_apply_3d``           ``_apply3d_kernel``       8 (the residual's
                                                         march)
``poisson_residual_3d``        ``_residual3d_kernel``    12 (a z-chunked
                                                         march)
``red_black_gauss_seidel_3d``  ``_rbgs3d_color_kernel``  12 per group of
                                                         <= 4 sweeps
``jacobi_3d``                  ``_jacobi3d_kernel``      12 per group of
                                                         <= 4 sweeps
``ff_poisson_residual_3d``     none (XLA fused it)       24 (a z-chunked
                                                         march)
``ff_update_residual_3d``      none (XLA fused it)       36 (the same
                                                         march)
``restrict_fw3d``              none (XLA fused            4.5 per fine
                               ``restrict_full_           point (a march
                               weighting``)               over coarse
                                                         planes)
``prolong_add3d``              none (XLA fused            8.5 per fine
                               ``u + prolong(e)``)        point (the
                                                         mirror march)
=============================  ========================  ===============

Arrays are ``(nz, ny, nx)``; ``logical_shape`` gives the live extents of a
padded buffer.  A CPU tensor runs the plain torch twin (``*_plain``, the
Pallas body's operation order: neighbours summed ``N + S + E + W + Zn +
Zs`` left to right, ``b / c`` as a true division); a CUDA tensor launches
the kernel or raises.  There is no fallback.  The JAX wrappers take the
kernels only for aligned f32 shapes; the kernels here take every 3D f32
shape, so on the card they also run the exact-layout levels, where JAX runs
XLA ops.  The smoothers (``rbgs3d_fused``, ``jacobi3d``) take one of two
launch shapes by the array's size alone: a z-marching tile
(:func:`rbgs3d_tile`) or a z-chunked march (:func:`jacobi3d_tile`), one
launch per group of <= 4 sweeps, or, for arrays of at most
``RESIDENT_MAX_POINTS`` points (the 17^3 bottom of a V-cycle), every sweep
in one launch with the array resident in shared memory.  The residual and
the apply run one z-chunked march (:func:`residual3d_tile`), the
float-float residual of the refined solve (``ops/extended.
ff_poisson_residual``, its twin) another with the pair in two rings
(:func:`ff_residual3d_tile`), and the same march with the correction ``e``
in a third ring fuses the pair update into it (``ff_update_residual_3d``).
The grid transfers of the exact layout (``ops/transfer.
restrict_full_weighting`` and ``u + prolong(e, u.shape)``, their twins)
march over coarse planes (:func:`restrict3d_tile`,
:func:`prolong3d_tile`); the padded layout's 3D transfers have no kernel.
SOR (``omega != 1``) of the red-black smoother runs the XLA-order plain
smoother and launches nothing, as the JAX wrapper does.  Each launch adds
one to its ``cuda_stencil.LAUNCHES`` entry; the kernels the redesigns
replaced stay on no path as oracles (``*_point``, ``_*_per_*``).
``ops/cuda_stencil.py`` sends 3D tensors here.
"""

from __future__ import annotations

import functools

import torch

from multigrid_prj_tpu_torch.ops import extended as _ext
from multigrid_prj_tpu_torch.ops import smoothers as _sm
from multigrid_prj_tpu_torch.ops import transfer as _tr
from multigrid_prj_tpu_torch.ops.cuda_stencil import (
    LAUNCHES,
    _groups,
    _lib,
    _pingpong,
    _ptr,
    _raise_on,
    _refuse_overlap,
    _stream,
)
from multigrid_prj_tpu_torch.ops.stencil import boundary_mask

# (1.0 / 6.0) rounded once to f32, as the Pallas bodies' weakly typed
# constant; the kernels get it as a float argument
_INV6 = 1.0 / 6.0
# the z-marching tile (csrc/stencil3d.cu Zm<P>): rows up to 4 passes and
# above, 32 columns (16 column pairs: one lane each); consecutive passes run
# _RB3_LAG planes apart, and planes are loaded _RB3_AHEAD steps ahead; each
# tile's march is cut into as many z-chunks as one wave of
# _RB3_TARGET_BLOCKS blocks (one per SM of an H100) holds, of at least
# _RB3_MIN_CHUNK planes
_RB3_TILE_ROWS = (32, 32)
_RB3_TILE_COLS = 32
_RB3_LAG = 2
_RB3_AHEAD = 3
_RB3_TARGET_BLOCKS = 132
_RB3_MIN_CHUNK = 1
# arrays of at most this many points smooth with u and b resident in one
# block's shared memory (csrc/stencil3d.cu kResidentMaxPoints), every sweep
# in one launch; the C entry point refuses another cap or a larger array
RESIDENT_MAX_POINTS = 16384
# the residual's and the apply's z-chunked march (csrc/stencil3d.cu kR3*):
# x-y tiles of 64 columns by 8 rows, a thread per (y, x) column walking a
# chunk of at most 32 planes, 4 planes in flight; the chunk is chosen so
# that every level launches about 528 blocks (4 per SM of an H100) where it
# has the planes
_R3_TILE = (64, 8)
_R3_AHEAD = 4
_R3_MAX_CHUNK = 32
_R3_TARGET_BLOCKS = 528
# the float-float residual's z-chunked march (csrc/stencil3d.cu kF3*): the
# residual's tiles and chunk rule, 2 planes of the pair, d and b in flight
_F3_AHEAD = 2
# the Jacobi smoother's z-chunked march (csrc/stencil3d.cu kJ3*): x-y tiles
# of 64 columns by 24 rows with a halo of one cell per sweep, a chunk of 4
# .. 32 output planes (the residual's rule), 3 planes in flight, up to 4
# sweeps per launch
_J3_TILE = (64, 24)
_J3_AHEAD = 3
_J3_MIN_CHUNK = 4
_J3_MAX_CHUNK = 32
_J3_TARGET_BLOCKS = 528
_MAX_FUSED_JACOBI3D = 4
# the exact-layout transfers' marches over coarse planes (csrc/stencil3d.cu
# kT3*, kP3*): the restriction's tiles of 32 coarse columns by 8 coarse
# rows, the prolong-add's of 64 fine columns by 8 fine rows with 3 coarse
# planes in flight; chunks of at most 8 coarse planes, chosen so that every
# level launches about 528 blocks where it has the planes
_T3_TILE = (32, 8)
_P3_TILE = (64, 8)
_P3_AHEAD = 3
_X3_MAX_CHUNK = 8
_X3_TARGET_BLOCKS = 528


def rbgs3d_tile(passes: int, shape):
    """Geometry of the z-marching tile of ``csrc/stencil3d.cu``
    (``Zm<P>``, ``rbgs3d_chunk``) for ``passes`` dependent colour passes (2
    per sweep) on an ``(nz, ny, nx)`` array: ``(row halo, column halo, tile
    rows, tile columns, u ring planes, b ring planes, planes per chunk)``.
    The x-y halo is one ring per pass on each side.  The passes of a step
    run ``_RB3_LAG`` planes apart in z, over a span of ``_RB3_LAG * (passes
    - 1)`` planes, so the u ring holds the span + 3 planes they read (the
    lowest also being stored) and the ``_RB3_AHEAD`` planes in flight; the
    b ring each pass's plane, the plane that landed and those in flight.  A
    block marches one x-y tile through one chunk of output planes and reads
    ``passes`` planes beyond each end; the chunk is ``ceil(nz /
    max(_RB3_TARGET_BLOCKS // tiles, 1))``, at least ``_RB3_MIN_CHUNK``:
    each tile's march takes as many chunks as one wave of blocks holds.
    The C entry point refuses a geometry other than the one compiled and
    the rule's chunk."""
    if not 0 < passes <= 8 or passes % 2:
        raise ValueError(f"the z-marching tile takes 2, 4, 6 or 8 passes, "
                         f"got {passes}")
    nz, ny, nx = (int(s) for s in shape)
    rows = _RB3_TILE_ROWS[passes > 4]
    span = _RB3_LAG * (passes - 1)
    tiles = (-(-nx // (_RB3_TILE_COLS - 2 * passes))
             * -(-ny // (rows - 2 * passes)))
    chunks = max(_RB3_TARGET_BLOCKS // tiles, 1)
    return (passes, passes, rows, _RB3_TILE_COLS, span + 3 + _RB3_AHEAD,
            span + 2 + _RB3_AHEAD, max(-(-nz // chunks), _RB3_MIN_CHUNK))


def residual3d_tile(shape):
    """Geometry of the residual's z-chunked march of ``csrc/stencil3d.cu``
    (``stencil3d_march_kernel``) for an ``(nz, ny, nx)`` array: ``(tile
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


def ff_residual3d_tile(shape):
    """Geometry of the float-float residual's z-chunked march of
    ``csrc/stencil3d.cu`` (``ff_residual3d_march_kernel``, and
    ``ff_update_residual3d_march_kernel`` with it) for an ``(nz,
    ny, nx)`` array: ``(tile columns, tile rows, planes per chunk, planes in
    flight)``: the residual's tile and chunk (:func:`residual3d_tile`), its
    own depth in flight.  The C entry point refuses any other geometry."""
    return (*residual3d_tile(shape)[:3], _F3_AHEAD)


def _transfer3d_chunk(ncz, tiles):
    return min(max(-(-ncz * tiles // _X3_TARGET_BLOCKS), 1), _X3_MAX_CHUNK)


def restrict3d_tile(shape):
    """Geometry of the restriction's march of ``csrc/stencil3d.cu``
    (``restrict_fw3d_kernel``) for a fine ``(nz, ny, nx)`` array: ``(coarse
    tile columns, coarse tile rows, coarse planes per chunk)``.  A block
    walks one tile of coarse (y, x) points through one chunk of coarse
    planes, reading the tile's fine window (``2 * rows + 1`` by ``2 *
    columns + 1``, from fine row and column ``2 * y0 - 1`` and ``2 * x0 -
    1``) at fine planes ``2 * k0 - 1 .. 2 * k1 - 1``; the chunk is
    ``ceil(ncz * tiles / 528)`` clamped to 1 .. 8.  The C entry point
    refuses any other geometry."""
    ncz, ncy, ncx = ((int(s) + 1) // 2 for s in shape)
    tx, ty = _T3_TILE
    return tx, ty, _transfer3d_chunk(ncz, -(-ncx // tx) * -(-ncy // ty))


def prolong3d_tile(shape):
    """Geometry of the prolong-add's march of ``csrc/stencil3d.cu``
    (``prolong_add3d_kernel``) for a fine ``(nz, ny, nx)`` array: ``(fine
    tile columns, fine tile rows, coarse planes per chunk, coarse planes in
    flight)``.  A block walks one tile of fine (y, x) columns through one
    chunk of coarse planes i0 .. i1 - 1, emitting fine planes 2i and 2i + 1
    from e's planes i and i + 1 (the plane after the chunk included) over
    the tile's coarse window (``rows / 2 + 1`` by ``columns / 2 + 1``);
    the chunk follows :func:`restrict3d_tile`'s rule.  The C entry point
    refuses any other geometry."""
    nz, ny, nx = (int(s) for s in shape)
    tx, ty = _P3_TILE
    chunk = _transfer3d_chunk((nz + 1) // 2, -(-nx // tx) * -(-ny // ty))
    return tx, ty, chunk, _P3_AHEAD


def jacobi3d_tile(shape, sweeps: int):
    """Geometry of the Jacobi smoother's z-chunked march of
    ``csrc/stencil3d.cu`` (``jacobi3d_march_kernel<S>``) for ``sweeps``
    sweeps per launch on an ``(nz, ny, nx)`` array: ``(tile columns, tile
    rows, halo, planes per chunk, planes in flight)``.  The tile carries a
    halo of one cell per sweep, so its core is ``columns - 2 * sweeps`` by
    ``rows - 2 * sweeps``; a block walks one tile through its chunk of
    output planes and reads ``sweeps`` planes beyond each end.  The chunk is
    ``ceil(nz * tiles / 528)`` clamped to 4 .. 32.  The C entry point
    refuses any other geometry."""
    if not 0 < sweeps <= _MAX_FUSED_JACOBI3D:
        raise ValueError(f"the Jacobi march takes 1 .. {_MAX_FUSED_JACOBI3D} "
                         f"sweeps, got {sweeps}")
    nz, ny, nx = (int(s) for s in shape)
    tx, ty = _J3_TILE
    tiles = -(-nx // (tx - 2 * sweeps)) * -(-ny // (ty - 2 * sweeps))
    zc = min(max(-(-nz * tiles // _J3_TARGET_BLOCKS), _J3_MIN_CHUNK),
             _J3_MAX_CHUNK)
    return tx, ty, sweeps, zc, _J3_AHEAD


def jacobi3d_route(shape) -> str:
    """The Jacobi smoother's launch shape for an array of ``shape``:
    ``"resident"`` (the whole array in one block's shared memory, every
    sweep in one launch) up to ``RESIDENT_MAX_POINTS`` points, else
    ``"march"`` (the z-chunked march, one launch per group of <= 4
    sweeps)."""
    return "resident" if _fits_resident(shape) else "march"


@functools.lru_cache(maxsize=None)
def _geometry3d(passes, shape):
    """:func:`rbgs3d_tile` as the C entry point takes it, built once per
    pass count and shape: the smoother runs at a few shapes, and where its
    launches are a few microseconds long the host sets their pace."""
    import ctypes

    return (ctypes.c_int * 7)(*rbgs3d_tile(passes, shape))


def rbgs3d_route(shape) -> str:
    """The smoother's launch shape for an array of ``shape``: ``"resident"``
    (the whole array in one block's shared memory, every sweep in one
    launch) up to ``RESIDENT_MAX_POINTS`` points, else ``"zmarch"`` (the
    z-chunked march of the z-marching tile, one launch per group of <= 4
    sweeps)."""
    return "resident" if _fits_resident(shape) else "zmarch"


def _fits_resident(shape) -> bool:
    return int(shape[0]) * int(shape[1]) * int(shape[2]) \
        <= RESIDENT_MAX_POINTS


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
    """Fused 7-point ``y = A u`` (identity at Dirichlet rows): one launch of
    the residual's z-chunked march without ``b`` (:func:`residual3d_tile`)."""
    if u.device.type == "cpu":
        return poisson_apply_3d_plain(u, alpha, h, logical_shape)
    return _apply3d_launch(u, alpha, h, logical_shape, "apply3d")


def _apply3d_launch(u, alpha, h, logical_shape, kernel):
    """One launch of ``kernel``: ``apply3d`` (the z-chunked march) or
    ``apply3d_point`` (the one-thread-per-point kernel it replaced, on no
    path: the card's checks hold the march to it and ``chip_smoke.py``
    times the two)."""
    import ctypes

    _check_cuda3d("poisson_apply_3d", u)
    if u.device.type != "cuda":
        raise ValueError(f"{kernel} launches CUDA kernels only")
    y = torch.empty_like(u)
    geom = ([(ctypes.c_int * 4)(*residual3d_tile(u.shape))]
            if kernel == "apply3d" else [])
    _raise_on(getattr(_lib(), f"mg_{kernel}")(
        _ptr(u), _ptr(y), *_dims(u, logical_shape), alpha / (h * h), *geom,
        _stream()), kernel)
    LAUNCHES[kernel] += 1
    return y


def poisson_residual_3d_plain(u, b, alpha, h, logical_shape=None):
    """Twin of the residual kernel: ``b - poisson_apply_3d_plain(u)``."""
    return b - poisson_apply_3d_plain(u, alpha, h, logical_shape)


def poisson_residual_3d(u, b, alpha, h, logical_shape=None):
    """Fused 7-point ``r = b - A u``: one launch of the z-chunked march
    (:func:`residual3d_tile`)."""
    if u.device.type == "cpu":
        return poisson_residual_3d_plain(u, b, alpha, h, logical_shape)
    import ctypes

    _check_cuda3d("poisson_residual_3d", u, b)
    r = torch.empty_like(u)
    geom = (ctypes.c_int * 4)(*residual3d_tile(u.shape))
    _raise_on(_lib().mg_residual3d(
        _ptr(u), _ptr(b), _ptr(r), *_dims(u, logical_shape), alpha / (h * h),
        geom, _stream()), "residual3d")
    LAUNCHES["residual3d"] += 1
    return r


# The kernel runs ``ops/extended.ff_poisson_residual``'s chain op for op on a
# 3-D array (neighbour pairs at z + 1, z - 1, y + 1, y - 1, x + 1, x - 1,
# then ``t = d - acc``; interior ``c*t_hi + c*t_lo``, boundary ``(b - u_hi) -
# u_lo``), so that function is its twin.
ff_poisson_residual_3d_plain = _ext.ff_poisson_residual


def ff_poisson_residual_3d(u_hi, u_lo, d_hi, d_lo, b, alpha, h,
                           logical_shape=None):
    """Fused extended-precision 7-point ``r = b - A u`` with ``u`` carried
    as the pair ``(u_hi, u_lo)`` and ``b / c`` as ``(d_hi, d_lo)``: one
    launch of its z-chunked march (:func:`ff_residual3d_tile`)."""
    import ctypes

    if u_hi.device.type == "cpu":
        return ff_poisson_residual_3d_plain(u_hi, u_lo, d_hi, d_lo, b, alpha,
                                            h, logical_shape)
    _check_cuda3d("ff_poisson_residual_3d", u_hi, u_lo, d_hi, d_lo, b)
    r = torch.empty_like(u_hi)
    geom = (ctypes.c_int * 4)(*ff_residual3d_tile(u_hi.shape))
    _raise_on(_lib().mg_ff_residual3d(
        _ptr(u_hi), _ptr(u_lo), _ptr(d_hi), _ptr(d_lo), _ptr(b), _ptr(r),
        *_dims(u_hi, logical_shape), alpha / (h * h), geom, _stream()),
        "ff_residual3d")
    LAUNCHES["ff_residual3d"] += 1
    return r


# The fused kernel runs ``ops/extended.ff_accumulate`` at every point and then
# the chain above on the updated pair, op for op, so
# ``ops/extended.ff_update_residual`` is its twin.
def ff_update_residual_3d(u_hi, u_lo, e, d_hi, d_lo, b, alpha, h,
                          logical_shape=None, out=None):
    """The refined solve's pair update ``(u_hi, u_lo) += e`` and the 7-point
    extended-precision residual of the updated pair: one launch of the
    float-float residual's march (:func:`ff_residual3d_tile`) with ``e`` in
    a third ring.  Returns ``(u_hi', u_lo', r)``; ``out`` as
    ``cuda_stencil.ff_update_residual``'s, a pair of buffers that must not
    overlap the inputs."""
    import ctypes

    if out is not None:
        _refuse_overlap("ff_update_residual_3d", out,
                        (u_hi, u_lo, e, d_hi, d_lo, b))
    if u_hi.device.type == "cpu":
        return _ext.ff_update_residual(u_hi, u_lo, e, d_hi, d_lo, b, alpha,
                                       h, logical_shape)
    hi2, lo2 = out if out is not None else (torch.empty_like(u_hi),
                                            torch.empty_like(u_hi))
    _check_cuda3d("ff_update_residual_3d", u_hi, u_lo, e, d_hi, d_lo, b, hi2,
                  lo2)
    r = torch.empty_like(u_hi)
    geom = (ctypes.c_int * 4)(*ff_residual3d_tile(u_hi.shape))
    _raise_on(_lib().mg_ff_update_residual3d(
        _ptr(u_hi), _ptr(u_lo), _ptr(e), _ptr(d_hi), _ptr(d_lo), _ptr(b),
        _ptr(hi2), _ptr(lo2), _ptr(r), *_dims(u_hi, logical_shape),
        alpha / (h * h), geom, _stream()), "ff_update_residual3d")
    LAUNCHES["ff_update_residual3d"] += 1
    return hi2, lo2, r


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
                     _geometry3d(2 * s, u.shape), _stream()),
                  "rbgs3d_fused")
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
    """``sweeps`` damped-Jacobi sweeps, out of place (``u`` is only read;
    ``sweeps == 0`` returns a copy), on the launch shape
    :func:`jacobi3d_route` picks: every sweep in one launch with the array
    resident in shared memory, or one launch of the z-chunked march per
    group of at most 4 sweeps (:func:`jacobi3d_tile`), the groups
    ping-ponging two scratch tensors."""
    if u.device.type == "cpu":
        return jacobi_3d_plain(u, b, alpha, h, omega, sweeps, logical_shape)
    _check_cuda3d("jacobi_3d", u, b)
    args = (*_dims(u, logical_shape), alpha / (h * h), _INV6,
            int(omega != 1.0), 1.0 - omega, omega)
    if jacobi3d_route(u.shape) == "resident":
        fn = _lib().mg_jacobi3d_resident

        def launch(x, y, s):
            _raise_on(fn(_ptr(x), _ptr(b), _ptr(y), *args, s,
                         RESIDENT_MAX_POINTS, _stream()), "jacobi3d")
            LAUNCHES["jacobi3d"] += 1

        return _pingpong(u, [sweeps] if sweeps > 0 else [], launch)
    import ctypes

    fn = _lib().mg_jacobi3d

    def launch(x, y, s):
        geom = (ctypes.c_int * 5)(*jacobi3d_tile(u.shape, s))
        _raise_on(fn(_ptr(x), _ptr(b), _ptr(y), *args, s, geom, _stream()),
                  "jacobi3d")
        LAUNCHES["jacobi3d"] += 1

    return _pingpong(u, _groups(sweeps, _MAX_FUSED_JACOBI3D), launch)


def _jacobi3d_per_sweep(u, b, alpha, h, omega: float = 1.0, sweeps: int = 1,
                        logical_shape=None):
    """The per-sweep oracle of the fused 3D Jacobi smoother on CUDA float32
    tensors: one out-of-place launch of ``jacobi3d_kernel`` per sweep,
    ping-ponging two scratch tensors (the path before the march).  On no
    solver path: the card's checks hold ``jacobi3d`` to it, and
    ``chip_smoke.py`` times it as the path the march replaced."""
    _check_cuda3d("_jacobi3d_per_sweep", u, b)
    if u.device.type != "cuda":
        raise ValueError("_jacobi3d_per_sweep launches CUDA kernels only")
    args = (*_dims(u, logical_shape), alpha / (h * h), _INV6,
            int(omega != 1.0), 1.0 - omega, omega)
    fn = _lib().mg_jacobi3d_sweep

    def launch(x, y, _s):
        _raise_on(fn(_ptr(x), _ptr(b), _ptr(y), *args, _stream()),
                  "jacobi3d_sweep")
        LAUNCHES["jacobi3d_sweep"] += 1

    return _pingpong(u, [1] * sweeps, launch)


# ---------------------------------------------------------------------------
# grid transfers of the exact layout
# ---------------------------------------------------------------------------


# The kernels run ``transfer.restrict_full_weighting`` (z, then y, then x)
# and ``transfer.prolong_add`` (``u + prolong(e, u.shape)``) op for op, so
# those functions are their twins.
restrict_fw3d_plain = _tr.restrict_full_weighting
prolong_add3d_plain = _tr.prolong_add


def _check_transfer3d(name, *tensors):
    """Raise on what the transfer kernels do not take: contiguous 3D f32
    tensors on one CUDA device, and a fine grid (the last tensor) of at
    least 3 points an axis, at most 65535 planes (the other 3D kernels'
    limit) and fewer than 2^31 points a plane."""
    for t in tensors:
        if t.dtype != torch.float32:
            raise NotImplementedError(
                f"{name}: the CUDA kernels take float32, got {t.dtype}")
        if t.ndim != 3 or t.device != tensors[0].device:
            raise ValueError(f"{name}: operands must be 3D on one device "
                             f"({t.device}, {tuple(t.shape)})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    fine = tensors[-1].shape
    if min(fine) < 3 or fine[0] > 65535 or fine[1] * fine[2] >= 2**31:
        raise ValueError(f"{name}: a fine grid of {tuple(fine)} points is "
                         "out of the kernel's range (each axis >= 3, nz <= "
                         "65535, a plane < 2^31 points)")


def restrict_fw3d(r):
    """Full-weighting restriction of the exact layout, fine ``(nz, ny,
    nx)`` -> coarse ``((nz + 1) // 2, ...)``, equal to
    ``transfer.restrict_full_weighting``: one launch of the march of
    :func:`restrict3d_tile`."""
    if r.device.type == "cpu":
        return restrict_fw3d_plain(r)
    import ctypes

    _check_transfer3d("restrict_fw3d", r)
    rc = torch.empty(tuple((n + 1) // 2 for n in r.shape), dtype=r.dtype,
                     device=r.device)
    _raise_on(_lib().mg_restrict_fw3d(
        _ptr(r), _ptr(rc), *r.shape,
        (ctypes.c_int * 3)(*restrict3d_tile(r.shape)), _stream()),
        "restrict_fw3d")
    LAUNCHES["restrict_fw3d"] += 1
    return rc


def prolong_add3d(e, u):
    """``u + transfer.prolong(e, u.shape)`` of the exact layout, out of
    place (each fine extent ``2 nc - 1`` or ``2 nc`` of ``e``'s ``nc``):
    one launch of the march of :func:`prolong3d_tile`."""
    if u.device.type == "cpu":
        return prolong_add3d_plain(e, u)
    import ctypes

    _check_transfer3d("prolong_add3d", e, u)
    if not all(nc >= 2 and n in (2 * nc - 1, 2 * nc)
               for nc, n in zip(e.shape, u.shape)):
        raise ValueError(f"prolong_add3d: u {tuple(u.shape)} is no "
                         f"refinement of e {tuple(e.shape)}")
    out = torch.empty_like(u)
    _raise_on(_lib().mg_prolong_add3d(
        _ptr(e), _ptr(u), _ptr(out), *e.shape, *u.shape,
        (ctypes.c_int * 4)(*prolong3d_tile(u.shape)), _stream()),
        "prolong_add3d")
    LAUNCHES["prolong_add3d"] += 1
    return out
