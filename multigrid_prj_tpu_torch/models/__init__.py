"""Problem definitions: the 2D/3D Poisson model problems and the P1 FEM
front-end for imported gmsh meshes."""

from multigrid_prj_tpu_torch.models.poisson import (
    TEST_FUNCTIONS,
    assemble_rhs,
    get_test_functions,
    grid_coords,
)

__all__ = ["TEST_FUNCTIONS", "assemble_rhs", "get_test_functions", "grid_coords"]
