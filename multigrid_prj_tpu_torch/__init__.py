"""multigrid_prj_tpu_torch -- the PyTorch and CUDA port of multigrid_prj_tpu.

The JAX package ``multigrid_prj_tpu`` is the reference; this package carries
its main path, the 2D geometric-multigrid V-cycle on the padded Poisson
layout (``GMGSolver(cycle="v", smoother="gs", pad_align=256)`` with
``solve`` and ``solve_refined``), on an NVIDIA H100.  The smoother, residual
and float-float residual run as hand-written CUDA kernels
(``csrc/stencil2d.cu``, built with nvcc at first use); every other op is
plain torch.  Nothing here imports jax or the JAX package.
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
