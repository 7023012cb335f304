"""multigrid_prj_tpu_torch -- the PyTorch and CUDA port of multigrid_prj_tpu.

The JAX package ``multigrid_prj_tpu`` is the reference; this package does
everything it does, on an NVIDIA H100:

* 2D geometric multigrid on the padded Poisson layout
  (``GMGSolver(cycle="v", pad_align=256)`` with ``solve`` and
  ``solve_refined``, also with ``inner_cg`` and at 8193^2), the 3D 7-point
  geometric multigrid (BASELINE config 4 at 257^3, and 513^3), the
  ``smoother_dtype`` defect correction, the RB-GS and Jacobi smoothers and
  the Krylov solvers;
* algebraic multigrid (``amg.AMGSolver``: host setup, V-cycle / PCG /
  float-float refined solves, FEM assembly and MatrixMarket I/O);
* the sharded solvers on ``torch.distributed``
  (``parallel.ShardedGMGSolver``, ``parallel.ShardedAMGSolver``);
* the command lines ``cli.gmg_main``, ``cli.amg_main``, the AMG debug
  harness ``cli.amg_debug`` and the plotting CLI ``cli.viz_main``
  (``viz.plots``), and the web front-end ``web.server``;
* the utilities: checkpoint / resume (``utils.checkpoint``), NaN/Inf guards
  (``utils.guards``), metrics, timers and profiler traces
  (``utils.metrics``), and the reference's file formats (``utils.io``).

The smoothers, residuals, operator apply and 2D padded grid transfers, the
sharded smoother on a halo-extended slab, and the AMG's ELL SpMV and
float-float residual, run as hand-written CUDA kernels
(``csrc/stencil2d.cu``, ``csrc/stencil3d.cu``, ``csrc/spmv.cu``, built with
nvcc at first use); every other op is plain torch.  Nothing here imports
jax or the JAX package.
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
