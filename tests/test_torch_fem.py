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
from torch_msh import write_msh
from torch_native_parity import native_parity  # noqa: F401

torch.set_num_threads(1)
pytestmark = pytest.mark.usefixtures("native_parity")


def _same_csr(a, b):
    assert tuple(a.shape) == tuple(b.shape)
    for f in ("indptr", "indices", "data"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("use_native", [True, False])
def test_parse_msh_matches_jax(tmp_path, use_native):
    ref = tfem.structured_unit_square_mesh(7)
    path = str(tmp_path / "square.msh")
    write_msh(path, ref)
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
