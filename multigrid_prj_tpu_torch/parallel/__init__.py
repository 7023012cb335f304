"""Multi-rank distribution on ``torch.distributed``: the rank mesh, the
sharded geometric and algebraic multigrid solvers and their halo-exchange
collectives (port of ``multigrid_prj_tpu/parallel``)."""

from multigrid_prj_tpu_torch.parallel.distributed import (
    make_mesh,
    maybe_initialize_distributed,
)
from multigrid_prj_tpu_torch.parallel.sharded_amg import ShardedAMGSolver
from multigrid_prj_tpu_torch.parallel.sharded_gmg import ShardedGMGSolver

__all__ = [
    "ShardedAMGSolver",
    "ShardedGMGSolver",
    "make_mesh",
    "maybe_initialize_distributed",
]
