"""CUDA stencil kernels of the GMG main path, with their plain twins.

Counterpart of ``multigrid_prj_tpu/ops/pallas_stencil.py`` for the three
kernels the padded 2D V-cycle reaches (sources in ``csrc/stencil2d.cu``):

==========================  =============================  ================
function                    replaces (pallas_stencil.py)   bytes per point
==========================  =============================  ================
``red_black_gauss_seidel``  ``_rbgs_fused_kernel`` /       12 per colour
                            ``_rbgs_fused2d_kernel``       pass
``poisson_residual``        ``_residual_kernel``           12
``ff_poisson_residual``     ``_ff_residual_kernel``        24
==========================  =============================  ================

Each public function keeps the JAX signature and dispatches on the device of
its tensors: a CPU tensor runs the plain torch twin (``*_plain``, the
kernel's operation order, which matches the JAX Pallas function in
interpret mode); a CUDA tensor launches the kernel or raises
``NotImplementedError``.  There is no fallback.  All three kernels are
memory-bound simple first versions (one launch per colour, no temporal
fusion); ``LAUNCHES`` counts each kernel launch.
"""

from __future__ import annotations

import torch

from multigrid_prj_tpu_torch.ops import extended as _ext
from multigrid_prj_tpu_torch.ops import smoothers as _sm
from multigrid_prj_tpu_torch.ops.stencil import boundary_mask

# kernel name -> number of launches since the last reset_launch_counts()
LAUNCHES = {"rbgs_color": 0, "residual": 0, "ff_residual": 0}


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


def _check_cuda(name, *tensors):
    """Raise on what the kernels do not take (they need 2D contiguous f32
    tensors of one shape on one CUDA device)."""
    t0 = tensors[0]
    if t0.ndim != 2:
        raise NotImplementedError(
            f"{name}: the CUDA kernels are 2D; 3D is ROADMAP.md queue A "
            "item 12 (3D GMG) with queue B items 8-11 (3D kernels)")
    if t0.dtype != torch.float32:
        raise NotImplementedError(
            f"{name}: the CUDA kernels take float32, got {t0.dtype} "
            "(ROADMAP.md queue A item 9a)")
    for t in tensors:
        if (t.device != t0.device or t.dtype != t0.dtype
                or t.shape != t0.shape):
            raise ValueError(f"{name}: operands differ in device, dtype or "
                             f"shape ({t.device}, {t.dtype}, {tuple(t.shape)})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


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
    """``sweeps`` RB-GS sweeps (``omega == 1`` only on CUDA)."""
    if u.device.type == "cpu":
        if omega != 1.0:
            # the JAX kernel wrapper runs SOR through the XLA smoother too
            return _sm.red_black_gauss_seidel(u, b, alpha, h, sweeps=sweeps,
                                              omega=omega,
                                              logical_shape=logical_shape)
        return red_black_gauss_seidel_plain(u, b, alpha, h, sweeps,
                                            logical_shape)
    if omega != 1.0:
        raise NotImplementedError(
            "RB-GS with omega != 1 (SOR) has no CUDA kernel "
            "(ROADMAP.md queue A item 9a)")
    _check_cuda("red_black_gauss_seidel", u, b)
    n, m = u.shape
    nl, ml = _logical(u.shape, logical_shape)
    c = alpha / (h * h)
    fn = _lib().mg_rbgs_color
    # the kernel updates in place: work on a clone so ``u`` is not mutated
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
    """Twin of the residual kernel:
    ``b - where(boundary, u, c * ((((4u - N) - S) - E) - W))``."""
    c = alpha / (h * h)
    north, south, east, west = _neighbors(u)
    stencil = c * (4.0 * u - north - south - east - west)
    bnd = boundary_mask(u.shape, logical_shape, u.device)
    return b - torch.where(bnd, u, stencil)


def poisson_residual(u, b, alpha, h, logical_shape=None):
    """Fused ``r = b - A u``."""
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
