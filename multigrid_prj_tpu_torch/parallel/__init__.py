"""Multi-rank distribution on ``torch.distributed``: the rank mesh, the
sharded geometric multigrid solver and its halo-exchange collectives (port
of ``multigrid_prj_tpu/parallel``).  The JAX package's ``ShardedAMGSolver``
is not ported yet (ROADMAP.md queue A item 19b)."""

from multigrid_prj_tpu_torch.parallel.distributed import (
    make_mesh,
    maybe_initialize_distributed,
)
from multigrid_prj_tpu_torch.parallel.sharded_gmg import ShardedGMGSolver

__all__ = [
    "ShardedGMGSolver",
    "make_mesh",
    "maybe_initialize_distributed",
]
