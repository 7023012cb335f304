"""Compute ops of the port: plain torch stencil, smoother, transfer,
residual and float-float ops (the JAX package's XLA-order versions), the
Krylov solvers, the sparse containers (``sparse``, ``sparse_extended``),
and ``cuda_stencil`` / ``cuda_stencil_3d`` / ``cuda_spmv`` with the
hand-written CUDA kernels and their twins.  The exports are the JAX
``ops`` package's, plus the Krylov solvers."""

from multigrid_prj_tpu_torch.ops.krylov import (
    KrylovResult,
    bicgstab,
    cg,
    cg_arrays,
)
from multigrid_prj_tpu_torch.ops.residual import norm2, rel_residual_norm
from multigrid_prj_tpu_torch.ops.smoothers import jacobi, red_black_gauss_seidel
from multigrid_prj_tpu_torch.ops.stencil import (
    boundary_mask,
    interior_mask,
    neighbor_sum,
    poisson_apply,
    poisson_diag,
    poisson_residual,
)
from multigrid_prj_tpu_torch.ops.transfer import (
    prolong,
    restrict_full_weighting,
    restrict_inject,
)

__all__ = [
    "boundary_mask",
    "interior_mask",
    "neighbor_sum",
    "poisson_apply",
    "poisson_diag",
    "poisson_residual",
    "jacobi",
    "red_black_gauss_seidel",
    "prolong",
    "restrict_full_weighting",
    "restrict_inject",
    "norm2",
    "rel_residual_norm",
    "KrylovResult",
    "bicgstab",
    "cg",
    "cg_arrays",
]
