"""The port's sparse layer vs the JAX package on the CPU: the host CSR
(construction, transpose, SpGEMM, RAP, RCM, permutation) bit-equal, the
gather ``ELLMatrix`` and ``coo_spmv`` to f64 round-off, ``poisson_fd_csr``
equal, and both packages on the same native-library path."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multigrid_prj_tpu import amg as jamg
from multigrid_prj_tpu import native as jnative
from multigrid_prj_tpu.models import fem as jfem
from multigrid_prj_tpu.models import poisson as jpoisson
from multigrid_prj_tpu.ops import sparse as jsparse
from multigrid_prj_tpu_torch import native as tnative
from multigrid_prj_tpu_torch.models import fem as tfem
from multigrid_prj_tpu_torch.models import poisson as tpoisson
from multigrid_prj_tpu_torch.ops import sparse as tsparse
from torch_native_parity import native_parity  # noqa: F401

torch.set_num_threads(1)
pytestmark = pytest.mark.usefixtures("native_parity")


def _systems(name):
    """(JAX HostCSR, port HostCSR) of one test system, each built by its
    own package."""
    if name == "fd32":
        return jpoisson.poisson_fd_csr(32), tpoisson.poisson_fd_csr(32)
    mesh = 12
    return (jfem.assemble_p1(jfem.structured_unit_square_mesh(mesh))[0],
            tfem.assemble_p1(tfem.structured_unit_square_mesh(mesh))[0])


def _same(a, b):
    """Two HostCSRs (either package) identical to the bit."""
    assert tuple(a.shape) == tuple(b.shape)
    for f in ("indptr", "indices", "data"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


def _port(M):
    return tsparse.HostCSR(indptr=M.indptr.copy(), indices=M.indices.copy(),
                           data=M.data.copy(), shape=M.shape)


def test_native_available_matches_jax():
    # hierarchy parity depends on which path runs (the native transpose
    # keeps explicit zeros that the NumPy fallback drops)
    assert tnative.available() == jnative.available()
    assert tnative._SO == jnative._SO


def test_native_loader_recovers_from_a_truncated_library(tmp_path,
                                                         monkeypatch):
    """A half-written library (what a loader meets in the build race) does
    not leave the port's loader on the fallback, nor kill the process
    (``dlopen`` of a file cut short can fault instead of raising): the
    loader sees the file is incomplete, rebuilds it under the lock, loads
    it, and later loads in the process get the library."""
    assert tnative.ensure_built()
    whole = open(tnative._SO, "rb").read()
    so = tmp_path / "libmgtpu.so"
    for cut in (len(whole) // 3, len(whole) - 1, 0):
        so.write_bytes(whole[:cut])
        assert not tnative._complete(str(so))
    so.write_bytes(whole[: len(whole) // 3])
    monkeypatch.setattr(tnative, "_SO", str(so))
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", False)
    lib = tnative._load()
    assert lib is not None and not tnative._tried
    assert so.stat().st_size == len(whole)
    assert tnative.available() and tnative._load() is lib
    indptr, indices, data = tnative.coo_to_csr([0, 1, 1], [1, 0, 1],
                                               [2.0, 3.0, 4.0], 2)
    assert indptr.tolist() == [0, 1, 3] and data.tolist() == [2.0, 3.0, 4.0]


@pytest.mark.parametrize("name", ["fd32", "p1_mesh12"])
def test_host_csr_ops_match_jax(name):
    Aj, At = _systems(name)
    _same(Aj, At)
    _same(Aj.transpose(), At.transpose())
    perm_j, perm_t = Aj.rcm_permutation(), At.rcm_permutation()
    assert np.array_equal(perm_j, perm_t)
    _same(Aj.permute(perm_j), At.permute(perm_t))
    # a Galerkin product with the JAX setup's prolongation
    Pj = jamg.build_prolongation(Aj, jamg.coarsen_pmis(Aj, 0.2, seed=1))
    _same(jsparse.rap(Pj, Aj), tsparse.rap(_port(Pj), At))
    _same(Aj.matmul(Pj), At.matmul(_port(Pj)))
    x = np.random.default_rng(0).standard_normal(Aj.shape[0])
    assert np.array_equal(Aj.spmv(x), At.spmv(x))
    X = np.random.default_rng(1).standard_normal((Aj.shape[0], 3))
    assert np.array_equal(Aj.spmm(X), At.spmm(X))
    assert np.array_equal(Aj.diagonal(), At.diagonal())
    assert np.array_equal(Aj.to_dense(), At.to_dense())


def test_from_coo_and_fallback_paths_match_jax(monkeypatch):
    rng = np.random.default_rng(2)
    rows, cols = rng.integers(0, 40, 300), rng.integers(0, 30, 300)
    vals = rng.standard_normal(300)
    vals[::9] = 0.0
    _same(jsparse.HostCSR.from_coo(rows, cols, vals, (40, 30)),
          tsparse.HostCSR.from_coo(rows, cols, vals, (40, 30)))
    # the NumPy fallbacks, with the native library switched off on both
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)
    Aj = jsparse.HostCSR.from_coo(rows, cols, vals, (40, 30))
    At = tsparse.HostCSR.from_coo(rows, cols, vals, (40, 30))
    _same(Aj, At)
    _same(Aj.transpose(), At.transpose())
    Sj, St = jpoisson.poisson_fd_csr(9), tpoisson.poisson_fd_csr(9)
    assert np.array_equal(Sj.rcm_permutation(), St.rcm_permutation())
    _same(Sj.matmul(Sj), St.matmul(St))


@pytest.mark.parametrize("nx,ny", [(1, 1), (2, 5), (7, 3), (32, 32)])
def test_poisson_fd_csr_matches_jax(nx, ny):
    _same(jpoisson.poisson_fd_csr(nx, ny), tpoisson.poisson_fd_csr(nx, ny))


@pytest.mark.parametrize("name,k_extra", [("fd32", 0), ("p1_mesh12", 0),
                                          ("p1_mesh12", 3)])
def test_ell_spmv_spmm_match_jax(name, k_extra):
    Aj, At = _systems(name)
    k = int(At.row_lengths.max()) + k_extra
    Ej = jsparse.ELLMatrix.from_host_csr(Aj, k=k, dtype=jnp.float64)
    Et = tsparse.ELLMatrix.from_host_csr(At, k=k, dtype=torch.float64,
                                         device="cpu")
    assert Et.cols.dtype == torch.int32 and Et.k == k
    assert np.array_equal(np.asarray(Ej.cols), Et.cols.numpy())
    assert np.array_equal(np.asarray(Ej.vals), Et.vals.numpy())
    rng = np.random.default_rng(3)
    x = rng.standard_normal(At.shape[1])
    want = np.asarray(Ej.spmv(jnp.asarray(x)))
    got = Et.spmv(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)
    X = rng.standard_normal((At.shape[1], 4))
    np.testing.assert_allclose(Et.spmm(torch.from_numpy(X)).numpy(),
                               np.asarray(Ej.spmm(jnp.asarray(X))), rtol=0,
                               atol=1e-13)
    _same(Ej.to_host_csr(), Et.to_host_csr())


def test_coo_spmv_matches_jax():
    A = tpoisson.poisson_fd_csr(12)
    rows, cols, vals = A.to_coo()
    x = np.random.default_rng(4).standard_normal(A.shape[0])
    want = np.asarray(jsparse.coo_spmv(jnp.asarray(rows, jnp.int32),
                                       jnp.asarray(cols, jnp.int32),
                                       jnp.asarray(vals), jnp.asarray(x),
                                       A.shape[0]))
    got = tsparse.coo_spmv(torch.from_numpy(rows), torch.from_numpy(cols),
                           torch.from_numpy(vals), torch.from_numpy(x),
                           A.shape[0]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)


def test_to_device_casts():
    t = tsparse.to_device(np.arange(4), torch.float32, device="cpu")
    assert t.dtype == torch.float32 and t.device.type == "cpu"
    assert tsparse.to_device(np.ones(3), device="cpu").dtype == torch.float64
