"""multigrid_prj_tpu_torch -- the PyTorch and CUDA port of multigrid_prj_tpu.

The JAX package ``multigrid_prj_tpu`` is the reference; this package carries
its 2D geometric multigrid on the padded Poisson layout
(``GMGSolver(cycle="v", pad_align=256)`` with ``solve`` and
``solve_refined``, also with ``inner_cg`` and at 8193^2), its 3D 7-point
geometric multigrid (BASELINE config 4 at 257^3, and 513^3), the
``smoother_dtype`` defect correction, the RB-GS and Jacobi smoothers, the
Krylov solvers and the ``gmg_main`` CLI, and its algebraic multigrid
(``amg.AMGSolver``: host setup, V-cycle / PCG / float-float refined solves,
the ``amg_main`` CLI, FEM assembly and MatrixMarket I/O), and its sharded
geometric multigrid on ``torch.distributed``
(``parallel.ShardedGMGSolver``), on an NVIDIA H100.  The smoothers,
residuals, operator apply and 2D padded grid transfers, the sharded
smoother on a halo-extended slab, and the AMG's ELL SpMV and float-float
residual, run as hand-written CUDA kernels (``csrc/stencil2d.cu``, ``csrc/stencil3d.cu``,
``csrc/spmv.cu``, built with nvcc at first use); every other op is plain
torch.  Nothing here imports jax or the JAX package.
"""

__version__ = "0.1.0"

from multigrid_prj_tpu_torch.grids import GridLevel, build_hierarchy
from multigrid_prj_tpu_torch.gmg import GMGSolver, sawtooth_cycle, v_cycle

__all__ = [
    "GridLevel",
    "build_hierarchy",
    "GMGSolver",
    "sawtooth_cycle",
    "v_cycle",
    "__version__",
]
