"""The P1 system of ``models/fem`` for many right-hand sides, and the
vectorised structured mesh (CPU):

* ``structured_unit_square_mesh`` equals the double loop it replaced (kept
  here as the oracle), node for node, triangle for triangle;
* ``P1System.A`` is ``assemble_p1``'s matrix, and ``load`` of the nodal
  ``f`` and ``g`` is ``assemble_p1``'s right-hand side to rounding, on a
  structured mesh and on one read back from a gmsh file;
* ``field`` puts ``g`` on the boundary and the solution inside;
* ``AMGSolver.solve_p1`` agrees with the benchmark's plain reference
  (``portbench/reference/p1_square.py``) at 65^2 nodes on seeded random
  nodal data, and with ``solve_refined`` on the loaded right-hand side.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from multigrid_prj_tpu_torch.amg import AMGSolver
from multigrid_prj_tpu_torch.models import fem
from portbench import registry
from tests.torch_msh import write_msh

torch.set_num_threads(1)


def _loop_mesh(n):
    """The structured mesh as the double loop built it."""
    xs = np.linspace(0.0, 1.0, n)
    X, Y = np.meshgrid(xs, xs, indexing="xy")
    nodes = np.stack([X.ravel(), Y.ravel()], axis=1)
    tris = []
    for r in range(n - 1):
        for c in range(n - 1):
            a = r * n + c
            b, d, e = a + 1, a + n, a + n + 1
            tris.append(sorted((a, b, d)))
            tris.append(sorted((b, e, d)))
    on_b = ((nodes[:, 0] == 0) | (nodes[:, 0] == 1)
            | (nodes[:, 1] == 0) | (nodes[:, 1] == 1))
    return nodes, np.asarray(tris, dtype=np.int64), on_b


@pytest.mark.parametrize("n", [2, 3, 5, 33, 64])
def test_the_vectorised_mesh_equals_the_loop(n):
    mesh = fem.structured_unit_square_mesh(n)
    nodes, tris, on_b = _loop_mesh(n)
    assert np.array_equal(mesh.nodes, nodes)
    assert mesh.triangles.dtype == tris.dtype
    assert np.array_equal(mesh.triangles, tris)
    assert np.array_equal(mesh.on_boundary, on_b)


def _meshes(tmp_path):
    square = fem.structured_unit_square_mesh(33)
    path = str(tmp_path / "square.msh")
    write_msh(path, fem.structured_unit_square_mesh(17))
    return {"structured-33": square,
            "msh-17": fem.parse_msh(path, use_native=False)}


@pytest.mark.parametrize("which", ["structured-33", "msh-17"])
def test_load_is_assemble_p1s_rhs(tmp_path, which):
    mesh = _meshes(tmp_path)[which]
    A, rhs = fem.assemble_p1(mesh)
    system = fem.P1System(mesh)
    assert np.array_equal(system.A.indptr, A.indptr)
    assert np.array_equal(system.A.indices, A.indices)
    assert np.array_equal(system.A.data, A.data)
    x, y = mesh.nodes[:, 0], mesh.nodes[:, 1]
    f = torch.as_tensor(fem.default_forcing_term(x, y))
    g = torch.as_tensor(fem.default_boundary_function(x, y))
    got = system.load(f, g).numpy()
    # the same products summed in another order: float64 rounding of the
    # largest term, ~|f| w (~7e3 h^2 near the origin) or |A_IB g| (~1)
    np.testing.assert_allclose(got, rhs, rtol=0,
                               atol=1e-14 * np.abs(rhs).max())
    # one array may carry both: f read inside, g on the boundary only
    both = torch.where(torch.as_tensor(mesh.on_boundary), g, f)
    assert torch.equal(system.load(both, both), system.load(f, g))


def test_the_interior_blocks_and_weights():
    mesh = fem.structured_unit_square_mesh(9)
    system = fem.P1System(mesh)
    h = 1.0 / 8
    inner = ~mesh.on_boundary
    assert np.array_equal(system.interior, np.flatnonzero(inner))
    assert np.array_equal(system.boundary, np.flatnonzero(~inner))
    # six triangles of area h^2 / 2 meet at an interior node
    np.testing.assert_allclose(system.weights[inner], h * h, rtol=1e-14)
    assert system.A_IB.shape == (inner.sum(), (~inner).sum())
    # the 5-point stencil: of the 7 x 7 interior nodes, the 20 next to one
    # edge have one boundary neighbour and the 4 next to a corner two, each
    # of weight -1
    lengths = system.A_IB.row_lengths
    assert [int((lengths == k).sum()) for k in range(3)] == [25, 20, 4]
    np.testing.assert_allclose(system.A_IB.data, -1.0, rtol=1e-14)


def test_field_puts_g_on_the_boundary():
    mesh = fem.structured_unit_square_mesh(9)
    system = fem.P1System(mesh)
    g = torch.arange(mesh.n_nodes, dtype=torch.float32)
    x = -torch.arange(system.interior.size, dtype=torch.float64) - 1.0
    u = system.field(x, g)
    assert u.dtype == torch.float64
    assert torch.equal(u[system.boundary], g[system.boundary].double())
    assert torch.equal(u[system.interior], x)
    assert torch.equal(g, torch.arange(mesh.n_nodes, dtype=torch.float32))


def _grid_data(n, seed):
    """Random nodal data on the harness's grid (f inside, g on the
    boundary), as the benchmark hands it over, and the same data in mesh
    node order."""
    gen = torch.Generator().manual_seed(seed)
    b = torch.randn((n, n), generator=gen, dtype=torch.float64)
    b[1:-1, 1:-1] *= 100.0
    return b, b.flip(0).reshape(-1)


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 3])
def test_solve_p1_agrees_with_the_plain_reference(seed):
    n = 65
    reference = registry.load_module("reference", "p1_square")
    system = fem.P1System(fem.structured_unit_square_mesh(n))
    solver = AMGSolver(system.A, num_levels=3, smoother="chebyshev",
                       dtype=torch.float32, device="cpu")
    b, nodal = _grid_data(n, seed)
    res = solver.solve_p1(system, nodal, nodal, tol=1e-10, maxit=100)
    u = res.x.view(n, n).flip(0)
    exact = reference.solve(b, 1.0, 1.0)
    err = float(torch.linalg.vector_norm(u - exact)
                / torch.linalg.vector_norm(exact))
    # the answer satisfies ||b - A u|| <= 1e-10 ||b||; with kappa(A) ~ 1.7e3
    # at 65^2 the error bound is ~2e-7, and the float-float residual keeps
    # it near 1e-10 (measured 1e-10 on the benchmark's own data)
    assert res.rel_residual <= 1e-10 and res.iterations < 20
    assert err < 1e-8, err
    assert torch.equal(u[0], b[0]) and torch.equal(u[:, -1], b[:, -1])


def test_solve_p1_is_solve_refined_on_the_load():
    n = 33
    system = fem.P1System(fem.structured_unit_square_mesh(n))
    solver = AMGSolver(system.A, num_levels=3, smoother="chebyshev",
                       dtype=torch.float32, device="cpu")
    _, nodal = _grid_data(n, 5)
    res = solver.solve_p1(system, nodal, nodal, tol=1e-9, maxit=50)
    ref = solver.solve_refined(system.load(nodal, nodal), tol=1e-9,
                               maxit=50)
    dev = solver.solve_refined(system.load(nodal, nodal), tol=1e-9,
                               maxit=50, on_device=True)
    assert isinstance(ref.x, np.ndarray) and isinstance(dev.x, torch.Tensor)
    assert np.array_equal(dev.x.numpy(), ref.x)
    assert torch.equal(res.x, system.field(dev.x, nodal))
    assert res.iterations == ref.iterations
    assert np.array_equal(res.history, ref.history)


def test_a_non_finite_load_is_refused():
    system = fem.P1System(fem.structured_unit_square_mesh(17))
    solver = AMGSolver(system.A, num_levels=2, smoother="chebyshev",
                       dtype=torch.float32, device="cpu")
    f = torch.ones(system.n_nodes, dtype=torch.float64)
    f[int(system.interior[3])] = float("nan")
    with pytest.raises(ValueError, match="non-finite"):
        solver.solve_p1(system, f, f)
    with pytest.raises(ValueError, match="non-finite"):
        solver.solve(system.load(f, f))
