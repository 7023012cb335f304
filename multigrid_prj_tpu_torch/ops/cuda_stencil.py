"""CUDA stencil and transfer kernels of the 2D GMG paths, with their plain
twins.

Counterpart of ``multigrid_prj_tpu/ops/pallas_stencil.py`` for the kernels
the padded 2D V-cycle, its ``inner_cg`` variant, the fused down-leg, the
Jacobi smoother and the public apply-chain and colour-sweep ops reach
(sources in ``csrc/stencil2d.cu``):

============================  =============================  ===============
function                      replaces (pallas_stencil.py)   bytes per point
============================  =============================  ===============
``red_black_gauss_seidel``    ``_rbgs_fused_kernel`` /       12 per group of
                              ``_rbgs_fused2d_kernel``       <= 4 sweeps
``poisson_residual``          ``_residual_kernel``           12
``ff_poisson_residual``       ``_ff_residual_kernel``        24
``ff_update_residual``        ``_ff_residual_kernel`` and    36
                              the pair update (XLA there)
``poisson_apply``             ``_apply_kernel`` /            8
                              ``_apply_carry_kernel``
``jacobi``                    ``_jacobi_fused_kernel`` /     12 per group of
                              ``_jacobi_fused2d_kernel``     <= 8 sweeps
``restrict_fw_padded_fast``   ``_fw_filter2d_kernel`` + its  ~5 per fine
                              wrapper's edge fix-up          point
``prolong_add_padded_fast``   ``_prolong_add_kernel``        ~9 per fine
                                                             point
``rbgs_residual_restrict``    ``_rbgs_resfilter_kernel`` +   ~13 per fine
                              ``fw_decimate_padded``         point
``poisson_apply_chain``       ``_apply_fused_kernel`` /      8 per group of
                              ``_apply_fused2d_kernel``      <= 8 applies
``rbgs_color_sweep``          ``_rbgs_color_kernel``         12
``rbgs_fused_extended``       ``_rbgs_fused_offset_kernel``  12 per extended
                                                             point per group
                                                             of <= 4 sweeps
============================  =============================  ===============

Each public function keeps the JAX signature.  As in the JAX wrappers, a 3D
tensor goes to ``ops/cuda_stencil_3d.py`` (the smoothers, residual and
apply; the padded transfers have no 3D kernel, and the 3D path runs them as
plain ops; the 3D float-float residual and fused update, and the 3D
exact-layout transfers, have only their ``cuda_stencil_3d`` wrappers).  A
solver reaches these functions through its route (``ops/routes.py``),
which takes each from the module of its dimension.  Otherwise each
function dispatches on the device of its tensors: a CPU tensor runs the
plain torch twin (``*_plain``, the kernel's operation order, which matches
the JAX Pallas function in interpret mode); a CUDA tensor launches the
kernel or raises ``NotImplementedError``.  There is no fallback.  All
kernels are memory-bound.  The red-black smoother, the down-leg and the sharded
solver's extended-slab smoother fuse their passes on the colour-split
shared-memory tile whose geometry :func:`rbgs_tile` gives; the apply chain
its applies on the row-walking tile of :func:`apply_tile`, the Jacobi
smoother its sweeps on the same tile (:func:`jacobi_tile`); the
prolong-add streams row strips (:func:`prolong_tile`); the rest make one
pass per launch.  ``LAUNCHES`` counts each kernel launch.
"""

from __future__ import annotations

import torch

from multigrid_prj_tpu_torch.ops import extended as _ext
from multigrid_prj_tpu_torch.ops import smoothers as _sm
from multigrid_prj_tpu_torch.ops import transfer as _tr
from multigrid_prj_tpu_torch.ops.stencil import boundary_mask

# kernel name -> number of launches since the last reset_launch_counts()
# (the ELL kernels of ops/cuda_spmv.py, the CG step's of ops/cuda_krylov.py
# and the design probes of benchmarks/ count here too)
LAUNCHES = {"rbgs_fused": 0, "rbgs_color": 0, "residual": 0,
            "ff_residual": 0, "ff_update_residual": 0, "apply": 0,
            "jacobi": 0, "jacobi_sweep": 0, "restrict_fw": 0,
            "prolong_add": 0, "prolong_add_point": 0,
            "apply3d": 0, "apply3d_point": 0, "residual3d": 0,
            "ff_residual3d": 0,
            "ff_update_residual3d": 0, "restrict_fw3d": 0,
            "prolong_add3d": 0, "rbgs3d_fused": 0,
            "rbgs3d_color": 0, "jacobi3d": 0, "jacobi3d_sweep": 0,
            "spmv": 0, "spmv_axpy": 0, "cheb_step": 0,
            "ff_residual_ell": 0, "rbgs_resfilter": 0,
            "apply_chain": 0, "rbgs_color_sweep": 0, "ell_spmm": 0,
            "rbgs_fused_ext": 0,
            "cg_xr_update": 0, "cg_rr_sum": 0, "cg_p_update": 0,
            "probe_copy": 0, "probe_rolls": 0, "probe_shifts": 0,
            "probe_halo": 0, "probe_full": 0, "probe_carry": 0,
            "probe_stream": 0, "probe_staticwin": 0, "probe_noshuffle": 0}

# passes one fused launch holds: each colour pass, residual, filter or
# apply loses one ring of its tile
_MAX_FUSED_SWEEPS = 4  # the smoother's tile: a halo of 2 * sweeps <= 8
_MAX_DOWNLEG_SWEEPS = 3  # the down-leg's: 2 * sweeps + 2 <= 8
_MAX_FUSED_APPLIES = 8  # the apply chain's: TPU's _MAX_FUSED_APPLIES
_MAX_FUSED_JACOBI = 8  # the Jacobi tile's: TPU's _MAX_FUSED_JACOBI
_EXT_HALO = 8  # halo rows on each side of rbgs_fused_extended's slab
_RB_TILE_ROWS = 64  # the colour-split tile: 64 rows of 64 column pairs,
_RB_TILE_COLS = 128  # one pair per lane
_AP_TILE_ROWS = 64  # the apply chain's row-walking tile: rows of 32 column
_AP_TILE_COLS = 128  # quads, one quad per lane
_PA_STRIP = 2  # the prolong-add stream: coarse rows a warp walks,
_PA_QUADS = 32  # coarse column quads per block (one warp across)


def rbgs_tile(passes: int):
    """Geometry of the colour-split tile of ``csrc/stencil2d.cu``
    (``RbTile<P>``) for ``passes`` dependent passes (2 per sweep, plus 2
    for the down-leg's residual and filter): ``(row halo, column halo,
    tile rows, tile columns)``.  The halo is one ring per pass, the column
    halo rounded up to 4 cells; tiles are 128 columns by 64 rows, cores
    ``64 - 2 * row halo`` by ``128 - 2 * column halo``.  The C entry points
    refuse a geometry other than the one compiled."""
    if not 0 < passes <= 8:
        raise ValueError(f"the fused RB-GS tiles take 1 .. 8 passes, got "
                         f"{passes}")
    return passes, -(-passes // 4) * 4, _RB_TILE_ROWS, _RB_TILE_COLS


def apply_tile(applies: int):
    """Geometry of the apply chain's row-walking tile of
    ``csrc/stencil2d.cu`` (``ApTile<A>``) for ``applies`` applies per
    launch: ``(row halo, column halo, tile rows, tile columns)``.  The halo
    is one ring per apply, the column halo rounded up to 4 cells (so core
    columns stay 16-byte aligned); tiles are 128 columns by 64 rows, cores
    ``64 - 2 * applies`` by ``128 - 2 * column halo``.  The C entry point
    refuses a geometry other than the one compiled."""
    if not 0 < applies <= _MAX_FUSED_APPLIES:
        raise ValueError(f"the apply chain's tile takes 1 .. "
                         f"{_MAX_FUSED_APPLIES} applies, got {applies}")
    return applies, -(-applies // 4) * 4, _AP_TILE_ROWS, _AP_TILE_COLS


def jacobi_tile(sweeps: int):
    """Geometry of the Jacobi smoother's tile of ``csrc/stencil2d.cu`` for
    ``sweeps`` sweeps per launch: the apply chain's row-walking tile
    (``ApTile<S>``, :func:`apply_tile`), one ring of halo per sweep.  The C
    entry point refuses a geometry other than the one compiled."""
    if not 0 < sweeps <= _MAX_FUSED_JACOBI:
        raise ValueError(f"the Jacobi tile takes 1 .. {_MAX_FUSED_JACOBI} "
                         f"sweeps, got {sweeps}")
    return apply_tile(sweeps)


def prolong_tile():
    """Geometry of the prolong-add stream of ``csrc/stencil2d.cu``
    (``prolong_add_stream_kernel``): ``(strip rows, quads per block)``.  A
    lane owns a coarse column quad (fine columns 2q .. 2q+7) and a warp
    walks a strip of that many coarse rows; a block is that many quads
    across and 8 strips down.  The C entry point refuses another."""
    return _PA_STRIP, _PA_QUADS


def _geometry(passes, tile=None):
    import ctypes

    return (ctypes.c_int * 4)(*(tile or rbgs_tile)(passes))


def _groups(sweeps, max_fused=_MAX_FUSED_SWEEPS):
    """``sweeps`` as fused groups of at most ``max_fused``, as the JAX
    wrappers' ``_pingpong_groups`` runs them (9 -> 4, 4, 1; none for
    ``sweeps <= 0``)."""
    full, rem = divmod(max(sweeps, 0), max_fused)
    return [max_fused] * full + ([rem] if rem else [])


def _pingpong(u, groups, launch):
    """``launch(x, y, s)`` for each group size ``s`` in turn, out of place,
    ping-ponging two scratch tensors, as the JAX wrappers'
    ``_pingpong_groups``: ``u`` is only read, and no group gives a copy."""
    if not groups:
        return u.clone()
    bufs = [torch.empty_like(u) for _ in range(min(len(groups), 2))]
    x = u
    for g, s in enumerate(groups):
        y = bufs[g % 2]
        launch(x, y, s)
        x = y
    return x


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _logical(shape, logical_shape):
    n, m = shape
    if logical_shape is None:
        return n, m
    nl, ml = int(logical_shape[0]), int(logical_shape[1])
    if not (2 <= nl <= n and 2 <= ml <= m):
        raise ValueError(f"logical shape {(nl, ml)} does not fit {(n, m)}")
    return nl, ml


def _check_cuda(name, *tensors, same_shape=True):
    """Raise on what the kernels do not take (they need 2D contiguous f32
    tensors on one CUDA device, of one shape unless ``same_shape`` is
    False)."""
    t0 = tensors[0]
    if t0.ndim != 2:
        raise NotImplementedError(
            f"{name}: this CUDA kernel is 2D; the JAX package has no 3D "
            "kernel for it either, and the 3D path runs the plain ops")
    if t0.dtype != torch.float32:
        raise NotImplementedError(
            f"{name}: the CUDA kernels take float32, got {t0.dtype}; "
            "GMGSolver runs other dtypes on the plain ops, as the JAX "
            "package runs them on XLA (ROADMAP.md queue A item 9a)")
    for t in tensors:
        if (t.device != t0.device or t.dtype != t0.dtype or t.ndim != 2
                or (same_shape and t.shape != t0.shape)):
            raise ValueError(f"{name}: operands differ in device, dtype or "
                             f"shape ({t.device}, {t.dtype}, {tuple(t.shape)})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def _refuse_overlap(name, outs, ins):
    """Raise if an output buffer shares memory with an input or with the
    other outputs (the fused kernels write out of place)."""
    def extent(t):
        start = t.data_ptr()
        return start, start + t.numel() * t.element_size()

    for k, o in enumerate(outs):
        lo, hi = extent(o)
        for t in (*ins, *outs[k + 1:]):
            t_lo, t_hi = extent(t)
            if t.device == o.device and lo < t_hi and t_lo < hi:
                raise ValueError(f"{name}: an output buffer overlaps an "
                                 "input or the other output")


def _stream():
    import ctypes

    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _ptr(t: torch.Tensor):
    import ctypes

    return ctypes.c_void_p(t.data_ptr())


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def _lib():
    from multigrid_prj_tpu_torch.kernels._build import library

    return library()


def _cs3d():
    from multigrid_prj_tpu_torch.ops import cuda_stencil_3d

    return cuda_stencil_3d


def _neighbors(x):
    """(north, south, east, west) = values at (i-1, j), (i+1, j), (i, j+1),
    (i, j-1); the wrapped edge values are only read at boundary points."""
    return (torch.roll(x, 1, 0), torch.roll(x, -1, 0),
            torch.roll(x, -1, 1), torch.roll(x, 1, 1))


# ---------------------------------------------------------------------------
# red-black Gauss-Seidel
# ---------------------------------------------------------------------------


def red_black_gauss_seidel_plain(u, b, alpha, h, sweeps: int = 1,
                                 logical_shape=None):
    """Twin of the RB-GS kernel: per colour (0 first),
    ``x <- where(boundary, b, where(parity == colour, gs, x))`` with
    ``gs = (b * (1/c) + N + S + E + W) * 0.25`` summed left to right
    (``pallas_stencil._fused_rbgs_passes``)."""
    c = alpha / (h * h)
    bnd = boundary_mask(u.shape, logical_shape, u.device)
    parity = _sm._parity(u.shape, u.device)
    b_over_c = b * (1.0 / c)
    x = u
    for _ in range(sweeps):
        for color in (0, 1):
            north, south, east, west = _neighbors(x)
            gs = (b_over_c + north + south + east + west) * 0.25
            x = torch.where(bnd, b, torch.where(parity == color, gs, x))
    return x


def red_black_gauss_seidel(u, b, alpha, h, sweeps: int = 1,
                           omega: float = 1.0, logical_shape=None):
    """``sweeps`` RB-GS sweeps: one launch of ``rbgs_fused_kernel`` per
    group of at most 4 sweeps, out of place, the groups ping-ponging two
    scratch tensors (``u`` is only read, never cloned; ``sweeps == 0``
    returns a copy).  The kernel is ``omega == 1`` only: SOR runs the
    XLA-order plain smoother on every device, as the JAX kernel wrapper does
    (``pallas_stencil.red_black_gauss_seidel``), and is no launch."""
    if u.ndim == 3:
        return _cs3d().red_black_gauss_seidel_3d(
            u, b, alpha, h, sweeps=sweeps, omega=omega,
            logical_shape=logical_shape)
    if omega != 1.0:
        return _sm.red_black_gauss_seidel(u, b, alpha, h, sweeps=sweeps,
                                          omega=omega,
                                          logical_shape=logical_shape)
    if u.device.type == "cpu":
        return red_black_gauss_seidel_plain(u, b, alpha, h, sweeps,
                                            logical_shape)
    _check_cuda("red_black_gauss_seidel", u, b)
    n, m = u.shape
    nl, ml = _logical(u.shape, logical_shape)
    c = alpha / (h * h)
    fn = _lib().mg_rbgs_fused

    def launch(x, y, s):
        _raise_on(fn(_ptr(x), _ptr(b), _ptr(y), n, m, nl, ml, 1.0 / c, s,
                     _geometry(2 * s), _stream()), "rbgs_fused")
        LAUNCHES["rbgs_fused"] += 1

    return _pingpong(u, _groups(sweeps), launch)


def _rbgs_per_colour(u, b, alpha, h, sweeps: int = 1, logical_shape=None):
    """The per-colour oracle of the fused smoother on CUDA float32 tensors:
    ``2 * sweeps`` in-place launches of ``rbgs_color_kernel`` on a clone of
    ``u``.  On no solver path: the card's checks hold the fused kernels to
    it, and ``chip_smoke.py`` times it as the path they replace."""
    _check_cuda("_rbgs_per_colour", u, b)
    if u.device.type != "cuda":
        raise ValueError("_rbgs_per_colour launches CUDA kernels only")
    n, m = u.shape
    nl, ml = _logical(u.shape, logical_shape)
    c = alpha / (h * h)
    fn = _lib().mg_rbgs_color
    x = u.clone()
    for _ in range(sweeps):
        for color in (0, 1):
            _raise_on(fn(_ptr(x), _ptr(b), n, m, nl, ml, 1.0 / c, color,
                         _stream()), "rbgs_color")
            LAUNCHES["rbgs_color"] += 1
    return x


# ---------------------------------------------------------------------------
# residual
# ---------------------------------------------------------------------------


def poisson_residual_plain(u, b, alpha, h, logical_shape=None):
    """Twin of the residual kernel: ``b - poisson_apply_plain(u)``."""
    return b - poisson_apply_plain(u, alpha, h, logical_shape)


def poisson_residual(u, b, alpha, h, logical_shape=None):
    """Fused ``r = b - A u``."""
    if u.ndim == 3:
        return _cs3d().poisson_residual_3d(u, b, alpha, h, logical_shape)
    if u.device.type == "cpu":
        return poisson_residual_plain(u, b, alpha, h, logical_shape)
    _check_cuda("poisson_residual", u, b)
    n, m = u.shape
    nl, ml = _logical(u.shape, logical_shape)
    c = alpha / (h * h)
    r = torch.empty_like(u)
    _raise_on(_lib().mg_residual(_ptr(u), _ptr(b), _ptr(r), n, m, nl, ml, c,
                                 _stream()), "residual")
    LAUNCHES["residual"] += 1
    return r


# ---------------------------------------------------------------------------
# float-float residual
# ---------------------------------------------------------------------------


# The kernel runs ``ops/extended.ff_poisson_residual``'s chain op for op
# (neighbour pairs in S, N, E, W order, then ``t = d - acc``; interior
# ``c*t_hi + c*t_lo``, boundary ``(b - u_hi) - u_lo``), so that function is
# its twin.
ff_poisson_residual_plain = _ext.ff_poisson_residual


def ff_poisson_residual(u_hi, u_lo, d_hi, d_lo, b, alpha, h,
                        logical_shape=None):
    """Fused extended-precision ``r = b - A u`` (pair-carried ``u``)."""
    if u_hi.device.type == "cpu":
        return ff_poisson_residual_plain(u_hi, u_lo, d_hi, d_lo, b, alpha, h,
                                         logical_shape)
    _check_cuda("ff_poisson_residual", u_hi, u_lo, d_hi, d_lo, b)
    n, m = u_hi.shape
    nl, ml = _logical(u_hi.shape, logical_shape)
    c = alpha / (h * h)
    r = torch.empty_like(u_hi)
    _raise_on(_lib().mg_ff_residual(_ptr(u_hi), _ptr(u_lo), _ptr(d_hi),
                                    _ptr(d_lo), _ptr(b), _ptr(r), n, m, nl,
                                    ml, c, _stream()), "ff_residual")
    LAUNCHES["ff_residual"] += 1
    return r


# The fused kernel runs ``ops/extended.ff_accumulate`` at every point and then
# ``ff_poisson_residual``'s chain on the updated pair, op for op, so
# ``ops/extended.ff_update_residual`` is its twin.
def ff_update_residual(u_hi, u_lo, e, d_hi, d_lo, b, alpha, h,
                       logical_shape=None, out=None):
    """The refined solve's pair update ``(u_hi, u_lo) += e`` and the
    extended-precision residual of the updated pair in one launch; returns
    ``(u_hi', u_lo', r)``.  ``out``: a pair of buffers the kernel writes
    ``(u_hi', u_lo')`` into (new ones when None).  They must not overlap
    the inputs, since neighbouring threads read the old pair.  On the CPU
    the twin runs and returns its own tensors."""
    if out is not None:
        _refuse_overlap("ff_update_residual", out,
                        (u_hi, u_lo, e, d_hi, d_lo, b))
    if u_hi.device.type == "cpu":
        return _ext.ff_update_residual(u_hi, u_lo, e, d_hi, d_lo, b, alpha,
                                       h, logical_shape)
    hi2, lo2 = out if out is not None else (torch.empty_like(u_hi),
                                            torch.empty_like(u_hi))
    _check_cuda("ff_update_residual", u_hi, u_lo, e, d_hi, d_lo, b, hi2, lo2)
    n, m = u_hi.shape
    nl, ml = _logical(u_hi.shape, logical_shape)
    c = alpha / (h * h)
    r = torch.empty_like(u_hi)
    _raise_on(_lib().mg_ff_update_residual(
        _ptr(u_hi), _ptr(u_lo), _ptr(e), _ptr(d_hi), _ptr(d_lo), _ptr(b),
        _ptr(hi2), _ptr(lo2), _ptr(r), n, m, nl, ml, c, _stream()),
        "ff_update_residual")
    LAUNCHES["ff_update_residual"] += 1
    return hi2, lo2, r


# ---------------------------------------------------------------------------
# operator apply
# ---------------------------------------------------------------------------


def poisson_apply_plain(u, alpha, h, logical_shape=None):
    """Twin of the apply kernel:
    ``where(boundary, u, c * ((((4u - N) - S) - E) - W))`` (not
    ``ops/stencil.poisson_apply``, whose neighbour sum runs in another
    order)."""
    c = alpha / (h * h)
    north, south, east, west = _neighbors(u)
    stencil = c * (4.0 * u - north - south - east - west)
    bnd = boundary_mask(u.shape, logical_shape, u.device)
    return torch.where(bnd, u, stencil)


def poisson_apply(u, alpha, h, logical_shape=None):
    """Fused ``y = A u`` (identity at Dirichlet rows).  The Pallas
    version's ``dst`` (a buffer to alias for its ping-pong chains) has no
    counterpart here: the output is always a new tensor."""
    if u.ndim == 3:
        return _cs3d().poisson_apply_3d(u, alpha, h, logical_shape)
    if u.device.type == "cpu":
        return poisson_apply_plain(u, alpha, h, logical_shape)
    _check_cuda("poisson_apply", u)
    n, m = u.shape
    nl, ml = _logical(u.shape, logical_shape)
    c = alpha / (h * h)
    y = torch.empty_like(u)
    _raise_on(_lib().mg_apply(_ptr(u), _ptr(y), n, m, nl, ml, c, _stream()),
              "apply")
    LAUNCHES["apply"] += 1
    return y


# ---------------------------------------------------------------------------
# damped Jacobi
# ---------------------------------------------------------------------------


def jacobi_plain(u, b, alpha, h, omega: float = 1.0, sweeps: int = 1,
                 logical_shape=None):
    """Twin of the Jacobi kernel, per sweep
    ``x <- where(boundary, b, jac)`` with ``jac = (b * (1/c) + N + S + E +
    W) * 0.25`` summed left to right and, if ``omega != 1``,
    ``jac <- (1 - omega) * x + omega * jac``
    (``pallas_stencil._fused_jacobi_passes``; not ``ops/smoothers.jacobi``,
    which divides ``b / c`` and sums the neighbours in another order)."""
    c = alpha / (h * h)
    bnd = boundary_mask(u.shape, logical_shape, u.device)
    b_over_c = b * (1.0 / c)
    x = u
    for _ in range(sweeps):
        north, south, east, west = _neighbors(x)
        jac = (b_over_c + north + south + east + west) * 0.25
        if omega != 1.0:
            jac = (1.0 - omega) * x + omega * jac
        x = torch.where(bnd, b, jac)
    return x


def jacobi(u, b, alpha, h, omega: float = 1.0, sweeps: int = 1,
           logical_shape=None):
    """``sweeps`` damped-Jacobi sweeps: one launch of
    ``jacobi_fused_kernel<S>`` per group of at most 8 sweeps on the tile of
    :func:`jacobi_tile`, out of place, the groups ping-ponging two scratch
    tensors (``u`` is only read; ``sweeps == 0`` returns a copy)."""
    if u.ndim == 3:
        return _cs3d().jacobi_3d(u, b, alpha, h, omega=omega, sweeps=sweeps,
                                 logical_shape=logical_shape)
    if u.device.type == "cpu":
        return jacobi_plain(u, b, alpha, h, omega, sweeps, logical_shape)
    _check_cuda("jacobi", u, b)
    n, m = u.shape
    nl, ml = _logical(u.shape, logical_shape)
    c = alpha / (h * h)
    fn = _lib().mg_jacobi_fused

    def launch(x, y, s):
        _raise_on(fn(_ptr(x), _ptr(b), _ptr(y), n, m, nl, ml, 1.0 / c, s,
                     int(omega != 1.0), 1.0 - omega, omega,
                     _geometry(s, jacobi_tile), _stream()), "jacobi")
        LAUNCHES["jacobi"] += 1

    return _pingpong(u, _groups(sweeps, _MAX_FUSED_JACOBI), launch)


def _jacobi_per_sweep(u, b, alpha, h, omega: float = 1.0, sweeps: int = 1,
                      logical_shape=None):
    """The per-sweep oracle of the fused Jacobi smoother on CUDA float32
    tensors: one out-of-place launch of ``jacobi_kernel`` per sweep,
    ping-ponging two scratch tensors.  On no solver path: the card's checks
    hold the fused kernel to it, and ``chip_smoke.py`` times it as the path
    it replaces."""
    _check_cuda("_jacobi_per_sweep", u, b)
    if u.device.type != "cuda":
        raise ValueError("_jacobi_per_sweep launches CUDA kernels only")
    n, m = u.shape
    nl, ml = _logical(u.shape, logical_shape)
    c = alpha / (h * h)
    fn = _lib().mg_jacobi

    def launch(x, y, _s):
        _raise_on(fn(_ptr(x), _ptr(b), _ptr(y), n, m, nl, ml, 1.0 / c,
                     int(omega != 1.0), 1.0 - omega, omega, _stream()),
                  "jacobi_sweep")
        LAUNCHES["jacobi_sweep"] += 1

    return _pingpong(u, [1] * sweeps, launch)


# ---------------------------------------------------------------------------
# grid transfers of the padded layout
# ---------------------------------------------------------------------------


# The restriction kernel computes ``transfer.restrict_fw_padded`` op for op
# (axis 0, then axis 1 on its result), so that function is its twin, as the
# Pallas version is held to it (tests/test_pallas_stencil.py).
restrict_fw_padded_fast_plain = _tr.restrict_fw_padded


def restrict_fw_padded_fast(r, logical_shape):
    """Full-weighting restriction, padded layout: fine ``(n, m)`` ->
    coarse ``(n/2, m/2)``, equal to ``transfer.restrict_fw_padded``."""
    if r.device.type == "cpu":
        return restrict_fw_padded_fast_plain(r, logical_shape)
    _check_cuda("restrict_fw_padded_fast", r)
    n, m = r.shape
    if n % 2 or m % 2:
        raise ValueError(f"restrict_fw_padded_fast: fine shape {(n, m)} "
                         "must be even on both axes")
    nl, ml = _logical(r.shape, logical_shape)
    out = torch.empty((n // 2, m // 2), dtype=r.dtype, device=r.device)
    _raise_on(_lib().mg_restrict_fw(_ptr(r), _ptr(out), n, m, (nl + 1) // 2,
                                    (ml + 1) // 2, _stream()), "restrict_fw")
    LAUNCHES["restrict_fw"] += 1
    return out


def prolong_add_padded_fast_plain(e, u):
    """Twin of the prolong-add kernel: ``u + transfer.prolong_padded(e)``."""
    return u + _tr.prolong_padded(e)


def prolong_add_padded_fast(e, u):
    """``u + prolong_padded(e)`` for coarse ``e`` of half ``u``'s shape: one
    launch of ``prolong_add_stream_kernel`` (the geometry of
    :func:`prolong_tile`)."""
    if u.device.type == "cpu":
        return prolong_add_padded_fast_plain(e, u)
    import ctypes

    out = _prolong_add_out(e, u)
    _raise_on(_lib().mg_prolong_add(
        _ptr(e), _ptr(u), _ptr(out), e.shape[0], e.shape[1],
        (ctypes.c_int * 2)(*prolong_tile()), _stream()), "prolong_add")
    LAUNCHES["prolong_add"] += 1
    return out


def _prolong_add_point(e, u):
    """The oracle of the prolong-add stream on CUDA float32 tensors: one
    launch of the one-thread-per-point ``prolong_add_kernel``.  On no solver
    path: the card's checks hold the stream to it, and ``chip_smoke.py``
    times it as the kernel the stream replaces."""
    if u.device.type != "cuda":
        raise ValueError("_prolong_add_point launches CUDA kernels only")
    out = _prolong_add_out(e, u)
    _raise_on(_lib().mg_prolong_add_point(
        _ptr(e), _ptr(u), _ptr(out), e.shape[0], e.shape[1], _stream()),
        "prolong_add_point")
    LAUNCHES["prolong_add_point"] += 1
    return out


def _prolong_add_out(e, u):
    """Check a prolong-add's operands; the output to fill."""
    _check_cuda("prolong_add_padded_fast", u, e, same_shape=False)
    n, m = u.shape
    if (2 * e.shape[0], 2 * e.shape[1]) != (n, m):
        raise ValueError(f"prolong_add_padded_fast: u {(n, m)} is not twice "
                         f"e {tuple(e.shape)}")
    return torch.empty_like(u)


# ---------------------------------------------------------------------------
# fused down-leg: smoother + residual + restriction
# ---------------------------------------------------------------------------


def rbgs_residual_restrict_plain(u, b, alpha, h, sweeps, logical_shape):
    """Twin of the down-leg kernel: the composition it fuses,
    ``red_black_gauss_seidel_plain`` -> ``poisson_residual_plain`` ->
    ``transfer.restrict_fw_padded``."""
    u2 = red_black_gauss_seidel_plain(u, b, alpha, h, sweeps, logical_shape)
    r = poisson_residual_plain(u2, b, alpha, h, logical_shape)
    return u2, _tr.restrict_fw_padded(r, logical_shape)


def rbgs_residual_restrict(u, b, alpha, h, sweeps, logical_shape):
    """Fused V-cycle down-leg on the padded layout: ``sweeps`` RB-GS sweeps,
    the residual and the full-weighting restriction in one pass.  Returns
    ``(u_smoothed, r_coarse)``, ``r_coarse`` of shape ``(n//2, m//2)``,
    equal to the composition of the three kernels.  ``sweeps > 3`` runs
    that composition (as the JAX wrapper does), with no fused launch."""
    if logical_shape is None:
        raise ValueError("rbgs_residual_restrict needs a logical_shape")
    if u.ndim != 2:
        raise NotImplementedError("rbgs_residual_restrict is 2D, as the "
                                  "JAX kernel is")
    if u.device.type == "cpu":
        return rbgs_residual_restrict_plain(u, b, alpha, h, sweeps,
                                            logical_shape)
    if sweeps > _MAX_DOWNLEG_SWEEPS:
        u2 = red_black_gauss_seidel(u, b, alpha, h, sweeps=sweeps,
                                    logical_shape=logical_shape)
        r = poisson_residual(u2, b, alpha, h, logical_shape)
        return u2, restrict_fw_padded_fast(r, logical_shape)
    _check_cuda("rbgs_residual_restrict", u, b)
    n, m = u.shape
    if n % 2 or m % 2:
        raise ValueError(f"rbgs_residual_restrict: fine shape {(n, m)} must "
                         "be even on both axes")
    nl, ml = _logical(u.shape, logical_shape)
    c = alpha / (h * h)
    u2 = torch.empty_like(u)
    rc = torch.empty((n // 2, m // 2), dtype=u.dtype, device=u.device)
    _raise_on(_lib().mg_rbgs_resfilter(
        _ptr(u), _ptr(b), _ptr(u2), _ptr(rc), n, m, nl, ml, 1.0 / c, c,
        int(sweeps), _geometry(2 * int(sweeps) + 2), _stream()),
        "rbgs_resfilter")
    LAUNCHES["rbgs_resfilter"] += 1
    return u2, rc


# ---------------------------------------------------------------------------
# apply chain
# ---------------------------------------------------------------------------


def poisson_apply_chain_plain(u, alpha, h, applies, logical_shape=None):
    """Twin of the apply-chain kernel: ``applies`` calls of
    ``poisson_apply_plain``."""
    x = u
    for _ in range(applies):
        x = poisson_apply_plain(x, alpha, h, logical_shape)
    return x if applies else u.clone()


def poisson_apply_chain(u, alpha, h, applies: int, logical_shape=None):
    """``A^applies u``, up to 8 applies per launch of
    ``apply_chain_kernel<A>`` on the tile of :func:`apply_tile` (longer
    chains in groups of at most 8, ping-ponging two tensors), equal to
    ``applies`` calls of :func:`poisson_apply`.  A 3D tensor chains the 3D
    apply kernel, as the JAX wrapper does.  The Pallas version's ``dst`` has
    no counterpart (see :func:`poisson_apply`)."""
    if u.ndim == 3:
        x = u
        for _ in range(applies):
            x = poisson_apply(x, alpha, h, logical_shape)
        return x if applies else u.clone()
    if u.device.type == "cpu":
        return poisson_apply_chain_plain(u, alpha, h, applies, logical_shape)
    _check_cuda("poisson_apply_chain", u)
    n, m = u.shape
    nl, ml = _logical(u.shape, logical_shape)
    c = alpha / (h * h)
    fn = _lib().mg_apply_chain

    def launch(x, y, s):
        _raise_on(fn(_ptr(x), _ptr(y), n, m, nl, ml, c, s,
                     _geometry(s, apply_tile), _stream()), "apply_chain")
        LAUNCHES["apply_chain"] += 1

    return _pingpong(u, _groups(applies, _MAX_FUSED_APPLIES), launch)


# ---------------------------------------------------------------------------
# one colour sweep
# ---------------------------------------------------------------------------


def rbgs_color_sweep_plain(u, b, alpha, h, color: int, logical_shape=None):
    """Twin of the colour-sweep kernel (``_rbgs_color_kernel``):
    ``where(boundary, b, where(parity == color, gs, u))`` with ``gs = (b / c
    + N + S + E + W) * 0.25`` summed left to right, ``b / c`` a true
    division (a 0-dim tensor divisor; torch on CUDA divides by a Python
    scalar as a multiply by its rounded reciprocal)."""
    c = alpha / (h * h)
    bnd = boundary_mask(u.shape, logical_shape, u.device)
    parity = _sm._parity(u.shape, u.device)
    north, south, east, west = _neighbors(u)
    b_over_c = b / torch.full((), c, dtype=b.dtype, device=b.device)
    gs = (b_over_c + north + south + east + west) * 0.25
    return torch.where(bnd, b, torch.where(parity == color, gs, u))


def rbgs_color_sweep(u, b, alpha, h, color: int, logical_shape=None):
    """One red (``color=0``) or black (``color=1``) half-sweep of
    Gauss-Seidel, out of place, with every boundary point pinned to ``b``.
    Takes every 2D shape (the JAX kernel needs an aligned one); the kernel
    takes float32."""
    if u.ndim != 2:
        raise ValueError(f"rbgs_color_sweep is 2D, got shape "
                         f"{tuple(u.shape)}")
    if color not in (0, 1):
        raise ValueError(f"color must be 0 or 1, got {color}")
    if u.device.type == "cpu":
        return rbgs_color_sweep_plain(u, b, alpha, h, color, logical_shape)
    _check_cuda("rbgs_color_sweep", u, b)
    n, m = u.shape
    nl, ml = _logical(u.shape, logical_shape)
    out = torch.empty_like(u)
    _raise_on(_lib().mg_rbgs_color_sweep(_ptr(u), _ptr(b), _ptr(out), n, m,
                                         nl, ml, alpha / (h * h), int(color),
                                         _stream()), "rbgs_color_sweep")
    LAUNCHES["rbgs_color_sweep"] += 1
    return out


# ---------------------------------------------------------------------------
# fused RB-GS on a shard's halo-extended slab
# ---------------------------------------------------------------------------


def fused_extended_supported(local_shape, dtype) -> bool:
    """Can :func:`rbgs_fused_extended` run on this shard-local block?  The
    kernel takes every 2D float32 shape; the JAX predicate's other terms
    (``m % 128``, a VMEM block size from ``_pick_block_rows_fused``) are
    Mosaic constraints with no counterpart here.  The caller also needs at
    least 8 local rows, since the 8-row halos come from the nearest
    neighbour shard only."""
    return len(local_shape) == 2 and dtype == torch.float32


def _extended_args(ue, be, logical_shape, sweeps):
    if sweeps > _MAX_FUSED_SWEEPS:
        raise ValueError(f"at most {_MAX_FUSED_SWEEPS} fused sweeps")
    if ue.ndim != 2 or ue.shape != be.shape or ue.shape[0] < 2 * _EXT_HALO:
        raise ValueError(f"rbgs_fused_extended takes 2D slabs of >= "
                         f"{2 * _EXT_HALO} rows of one shape, got "
                         f"{tuple(ue.shape)} and {tuple(be.shape)}")
    nl, ml = int(logical_shape[0]), int(logical_shape[1])
    if nl < 2 or not 2 <= ml <= ue.shape[1]:
        raise ValueError(f"logical shape {(nl, ml)} does not fit slabs of "
                         f"{ue.shape[1]} columns")
    return nl, ml


def rbgs_fused_extended_plain(ue, be, row0, logical_shape, alpha, h,
                              sweeps):
    """Twin of the extended-slab kernel (``_rbgs_fused_offset_kernel``
    through ``_fused_rbgs_passes``): per colour (0 first),
    ``x <- where(boundary, be, where(parity == colour, gs, x))`` on the whole
    slab, with ``gs = (be * (1/c) + N + S + E + W) * 0.25`` summed left to
    right, ``parity = (row0 + i + j) % 2`` (a floor modulo, 0 or 1 for the
    negative rows too) and ``boundary = row <= 0 | row >= nl - 1 | col <= 0
    | col >= ml - 1`` for global row ``row0 + i``.  The slab's first and last
    rows see themselves as N / S neighbours, as in the TPU block; those rows
    are stale and not returned.  Returns the core rows ``8 .. ne - 9``."""
    nl, ml = _extended_args(ue, be, logical_shape, sweeps)
    ne, m = ue.shape
    c = alpha / (h * h)
    row = (torch.arange(ne, device=ue.device) + int(row0))[:, None]
    col = torch.arange(m, device=ue.device)[None, :]
    boundary = (row <= 0) | (row >= nl - 1) | (col <= 0) | (col >= ml - 1)
    parity = (row + col) % 2
    b_over_c = be * (1.0 / c)
    x = ue
    for _ in range(sweeps):
        for color in (0, 1):
            north = torch.cat([x[:1], x[:-1]])
            south = torch.cat([x[1:], x[-1:]])
            east = torch.roll(x, -1, 1)
            west = torch.roll(x, 1, 1)
            gs = (b_over_c + north + south + east + west) * 0.25
            x = torch.where(boundary, be, torch.where(parity == color, gs, x))
    return x[_EXT_HALO:ne - _EXT_HALO].clone()


def rbgs_fused_extended(ue, be, row0, logical_shape, alpha: float, h: float,
                        sweeps: int):
    """``sweeps`` (<= 4) fused RB-GS sweeps on a shard's rows extended by 8
    halo rows above and below (``parallel/sharded_gmg.rbgs_local_pallas``
    delivers them).  ``row0`` is the global row of ``ue[0]`` (the shard's
    first row minus 8; -8 on the first shard), so the colour and the
    Dirichlet pinning are global.  Returns the updated core rows
    ``ue[8:-8]``, equal to ``2 * sweeps`` colour passes on the global grid.
    A CPU tensor runs :func:`rbgs_fused_extended_plain`; a CUDA float32 one
    launches ``rbgs_fused_ext_kernel<sweeps>`` on the colour-split tile of
    :func:`rbgs_tile` (one launch per call; no sweeps, or no core row, is a
    copy of the core and no launch)."""
    nl, ml = _extended_args(ue, be, logical_shape, sweeps)
    if ue.device.type == "cpu":
        return rbgs_fused_extended_plain(ue, be, row0, logical_shape, alpha,
                                         h, sweeps)
    if sweeps < 1 or ue.shape[0] == 2 * _EXT_HALO:
        _check_cuda("rbgs_fused_extended", ue, be)
        return ue[_EXT_HALO:ue.shape[0] - _EXT_HALO].clone()
    _check_cuda("rbgs_fused_extended", ue, be)
    ne, m = ue.shape
    c = alpha / (h * h)
    out = torch.empty((ne - 2 * _EXT_HALO, m), dtype=ue.dtype,
                      device=ue.device)
    _raise_on(_lib().mg_rbgs_fused_ext(
        _ptr(ue), _ptr(be), _ptr(out), ne, m, int(row0), nl, ml, 1.0 / c,
        int(sweeps), _geometry(2 * int(sweeps)), _stream()), "rbgs_fused_ext")
    LAUNCHES["rbgs_fused_ext"] += 1
    return out
