"""Compute ops of the port: plain torch stencil, smoother, transfer,
residual and float-float ops (the JAX package's XLA-order versions), the
Krylov solvers, the sparse containers (``sparse``, ``sparse_extended``),
and ``cuda_stencil`` / ``cuda_stencil_3d`` / ``cuda_spmv`` with the
hand-written CUDA kernels and their twins."""

from multigrid_prj_tpu_torch.ops.krylov import (
    KrylovResult,
    bicgstab,
    cg,
    cg_arrays,
)

__all__ = ["KrylovResult", "bicgstab", "cg", "cg_arrays"]
