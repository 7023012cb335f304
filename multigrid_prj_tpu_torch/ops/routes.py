"""The stencil functions a ``GMGSolver`` solve calls, chosen once.

A :class:`Route` holds one function per operation of a solve.  There are
two, and this module is the only one that knows which operation has a
kernel in which dimension:

* :func:`plain_route`: the XLA-order plain ops (``ops/stencil``,
  ``ops/smoothers``, ``ops/transfer``, ``ops/extended``), on every device
  and in every dtype, launching nothing;
* :func:`kernel_route`: the hand-written kernels' wrappers,
  ``ops/cuda_stencil`` in 2D and ``ops/cuda_stencil_3d`` in 3D (each runs
  its plain twin on a CPU tensor).  The grid transfers have kernels for
  the padded layout in 2D, as in the JAX package, and for the exact
  layout in 3D, where the JAX package leaves them to XLA's fusion; the
  other transfers (2D exact, 3D padded) and, in 3D, the down-leg run
  plain.

The JAX kernel wrappers take float32 only and send every other dtype to XLA
ops, so a solver takes the kernel route for float32 work with
``use_pallas`` and the plain route for everything else.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

from multigrid_prj_tpu_torch.ops import cuda_stencil as _cs
from multigrid_prj_tpu_torch.ops import cuda_stencil_3d as _c3
from multigrid_prj_tpu_torch.ops import extended as _ext
from multigrid_prj_tpu_torch.ops import stencil as _st
from multigrid_prj_tpu_torch.ops import transfer as _tr
from multigrid_prj_tpu_torch.ops.smoothers import make_smoother


class Route(NamedTuple):
    """One solve's stencil functions (the cycles' hook signatures)."""
    smooth: Callable  # (u, b, alpha, h, sweeps, logical_shape=None) -> u
    residual: Callable  # (u, b, alpha, h, logical_shape) -> r
    apply: Callable  # (u, alpha, h, logical_shape) -> A u
    padded_restrict: Callable  # (r, logical_shape) -> coarse r
    prolong_add: Callable | None  # (e, u) -> u + prolong; None: separate
    exact_restrict: Callable  # r -> coarse r (exact layout)
    exact_prolong_add: Callable  # (e, u) -> u + prolong (exact layout)
    downleg: Callable | None  # (u, b, lev, nxt, nu1) -> (u, r_coarse)
    ff_residual: Callable  # (u_hi, u_lo, d_hi, d_lo, b, alpha, h, logical)
    # (u_hi, u_lo, e, d_hi, d_lo, b, alpha, h, logical, out=None)
    #   -> (u_hi', u_lo', r)
    ff_update_residual: Callable


def plain_route(smoother: str, omega: float) -> Route:
    """The XLA-order plain ops.  Its ``ff_update_residual`` ignores ``out``
    and returns new tensors."""
    return Route(smooth=make_smoother(smoother, omega=omega),
                 residual=_st.poisson_residual, apply=_st.poisson_apply,
                 padded_restrict=_tr.restrict_fw_padded, prolong_add=None,
                 exact_restrict=_tr.restrict_full_weighting,
                 exact_prolong_add=_tr.prolong_add,
                 downleg=None, ff_residual=_ext.ff_poisson_residual,
                 ff_update_residual=_ext.ff_update_residual)


def _kernel_smoother(ndim: int, smoother: str, omega: float):
    """The RB-GS or Jacobi kernel with ``omega`` bound; any other name runs
    the plain smoother."""
    if smoother == "gs":
        fn = (_cs.red_black_gauss_seidel if ndim == 2
              else _c3.red_black_gauss_seidel_3d)

        def smooth(u, b, alpha, h, sweeps=1, logical_shape=None):
            return fn(u, b, alpha, h, sweeps=sweeps, omega=omega,
                      logical_shape=logical_shape)

        return smooth
    if smoother == "jacobi":
        fn = _cs.jacobi if ndim == 2 else _c3.jacobi_3d

        def smooth(u, b, alpha, h, sweeps=1, logical_shape=None):
            return fn(u, b, alpha, h, omega=omega, sweeps=sweeps,
                      logical_shape=logical_shape)

        return smooth
    return make_smoother(smoother, omega=omega)


def kernel_route(ndim: int, smoother: str, omega: float, fuse_downleg: bool,
                 alpha: float) -> Route:
    """The kernels of an ``ndim``-dimensional solve.  The 2D route runs the
    padded transfer kernels at every padded level (bit-equal to the plain
    transfers, one launch for the plain transfer's many; the JAX package
    gates them at >= 4M fine points, a TPU measurement that does not carry
    over) and, with ``fuse_downleg``, ``smoother="gs"`` and ``omega == 1``,
    the fused down-leg ``rbgs_residual_restrict`` (``alpha`` is the
    solver's).  In 3D the JAX package leaves the float-float residual and
    the exact-layout transfers to XLA's fusion, which torch does not make:
    they have kernels here too, bit-equal to the plain ops."""
    smooth = _kernel_smoother(ndim, smoother, omega)
    if ndim != 2:
        return Route(smooth=smooth, residual=_c3.poisson_residual_3d,
                     apply=_c3.poisson_apply_3d,
                     padded_restrict=_tr.restrict_fw_padded,
                     prolong_add=None, exact_restrict=_c3.restrict_fw3d,
                     exact_prolong_add=_c3.prolong_add3d, downleg=None,
                     ff_residual=_c3.ff_poisson_residual_3d,
                     ff_update_residual=_c3.ff_update_residual_3d)
    downleg = None
    if fuse_downleg and smoother == "gs" and omega == 1.0:
        def downleg(u, b, lev, nxt, nu1):
            u2, rc = _cs.rbgs_residual_restrict(u, b, alpha, lev.h, nu1,
                                                lev.shape)
            if nxt.padded_shape is None:
                rc = _tr.crop_to(rc, nxt.shape)
            return u2, rc

    return Route(smooth=smooth, residual=_cs.poisson_residual,
                 apply=_cs.poisson_apply,
                 padded_restrict=_cs.restrict_fw_padded_fast,
                 prolong_add=_cs.prolong_add_padded_fast,
                 exact_restrict=_tr.restrict_full_weighting,
                 exact_prolong_add=_tr.prolong_add, downleg=downleg,
                 ff_residual=_cs.ff_poisson_residual,
                 ff_update_residual=_cs.ff_update_residual)
