"""The port's FEM host code (``multigrid_prj_tpu_torch/models/fem.py``) vs the
JAX package's on the CPU: P1/P2/P3 assembly bit-equal, ``parse_msh`` (native
and Python paths) on a gmsh 4.1 file the test writes, and the VTU
exporters writing the same files."""

import numpy as np
import pytest
import torch

from multigrid_prj_tpu.models import fem as jfem
from multigrid_prj_tpu_torch import native as tnative
from multigrid_prj_tpu_torch.models import fem as tfem
from torch_native_parity import native_parity  # noqa: F401

torch.set_num_threads(1)
pytestmark = pytest.mark.usefixtures("native_parity")


def _same_csr(a, b):
    assert tuple(a.shape) == tuple(b.shape)
    for f in ("indptr", "indices", "data"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


def _write_msh(path, mesh):
    """``mesh`` as a gmsh 4.1 ASCII file: one node block (tags from 1), one
    block of boundary lines (type 1) and one of triangles (type 2)."""
    n = mesh.n_nodes
    tris = mesh.triangles + 1
    edges = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [0, 2]]])
    bnd = mesh.on_boundary
    # an edge with both ends on the boundary and used by one triangle only
    key, count = np.unique(np.sort(edges, axis=1), axis=0, return_counts=True)
    lines = key[(count == 1) & bnd[key[:, 0] - 1] & bnd[key[:, 1] - 1]]
    with open(path, "w") as fh:
        fh.write("$MeshFormat\n4.1 0 8\n$EndMeshFormat\n")
        fh.write(f"$Nodes\n1 {n} 1 {n}\n2 1 0 {n}\n")
        fh.write("".join(f"{t}\n" for t in range(1, n + 1)))
        fh.write("".join(f"{float(x)!r} {float(y)!r} 0\n"
                         for x, y in mesh.nodes))
        fh.write("$EndNodes\n")
        m, nl = len(tris), len(lines)
        fh.write(f"$Elements\n2 {nl + m} 1 {nl + m}\n1 1 1 {nl}\n")
        fh.write("".join(f"{k + 1} {a} {b}\n" for k, (a, b) in enumerate(lines)))
        fh.write(f"2 1 2 {m}\n")
        # node order within a triangle as gmsh may give it (unsorted)
        fh.write("".join(f"{nl + k + 1} {c} {a} {b}\n"
                         for k, (a, b, c) in enumerate(tris)))
        fh.write("$EndElements\n")


@pytest.mark.parametrize("use_native", [True, False])
def test_parse_msh_matches_jax(tmp_path, use_native):
    ref = tfem.structured_unit_square_mesh(7)
    path = str(tmp_path / "square.msh")
    _write_msh(path, ref)
    mt = tfem.parse_msh(path, use_native=use_native)
    mj = jfem.parse_msh(path, use_native=use_native)
    for f in ("nodes", "triangles", "on_boundary"):
        assert np.array_equal(getattr(mt, f), getattr(mj, f)), f
        assert np.array_equal(getattr(mt, f), getattr(ref, f)), f
    if use_native:
        assert tnative.available()  # the native loader took the file
    bad = tmp_path / "old.msh"
    bad.write_text("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n")
    with pytest.raises(ValueError):
        tfem.parse_msh(str(bad), use_native=False)


@pytest.mark.parametrize("order,n", [(1, 12), (2, 9), (3, 7)])
def test_assembly_matches_jax(order, n):
    mt = tfem.structured_unit_square_mesh(n)
    mj = jfem.structured_unit_square_mesh(n)
    assert np.array_equal(mt.nodes, mj.nodes)
    if order == 1:
        (At, bt), (Aj, bj) = tfem.assemble_p1(mt), jfem.assemble_p1(mj)
    elif order == 2:
        ht, hj = tfem.p2_mesh(mt), jfem.p2_mesh(mj)
        assert ht.n_dofs == hj.n_dofs
        (At, bt), (Aj, bj) = tfem.assemble_p2(ht), jfem.assemble_p2(hj)
    else:
        ht, hj = tfem.p3_mesh(mt), jfem.p3_mesh(mj)
        assert ht.n_dofs == hj.n_dofs
        (At, bt), (Aj, bj) = tfem.assemble_p3(ht), jfem.assemble_p3(hj)
    _same_csr(At, Aj)
    assert np.array_equal(bt, bj)
    # symmetric positive definite interior operator
    D = At.to_dense()
    assert np.allclose(D, D.T, rtol=0, atol=1e-12)
    assert np.linalg.eigvalsh(D).min() > 0


@pytest.mark.parametrize("order", [1, 2, 3])
def test_vtu_export_matches_jax(tmp_path, order):
    mt = tfem.structured_unit_square_mesh(6)
    mj = jfem.structured_unit_square_mesh(6)
    if order == 1:
        args_t, args_j = (mt,), (mj,)
        n_int = int((~mt.on_boundary).sum())
        exp_t, exp_j = tfem.export_vtu, jfem.export_vtu
    elif order == 2:
        args_t, args_j = (tfem.p2_mesh(mt),), (jfem.p2_mesh(mj),)
        n_int = tfem.assemble_p2(args_t[0])[0].shape[0]
        exp_t, exp_j = tfem.export_vtu_p2, jfem.export_vtu_p2
    else:
        args_t, args_j = (tfem.p3_mesh(mt),), (jfem.p3_mesh(mj),)
        n_int = tfem.assemble_p3(args_t[0])[0].shape[0]
        exp_t, exp_j = tfem.export_vtu_p3, jfem.export_vtu_p3
    sol = np.random.default_rng(order).standard_normal(n_int)
    exp_t(str(tmp_path / "t.vtu"), *args_t, sol)
    exp_j(str(tmp_path / "j.vtu"), *args_j, sol)
    text = (tmp_path / "t.vtu").read_text()
    assert text == (tmp_path / "j.vtu").read_text()
    assert text.startswith('<?xml version="1.0"?>') and "</VTKFile>" in text
