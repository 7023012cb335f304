"""Twin of the CUDA ELL SpMM (``ops/cuda_spmv.ell_spmm`` / ``CudaELL.spmm``)
vs the JAX ``PallasELL.spmm`` in interpret mode and vs the f64 host oracle
``HostCSR.spmm``, on the CPU; and the port's copy of the benchmarks' banded
matrix.  The kernel is held to this twin on the card in
tests/test_torch_cuda.py.

Bounds as the SpMV's (tests/test_torch_spmv.py): the twin sums its slots in
order, the Pallas kernel with a vector reduction, so both are held to 4 ulp
(f32) of ``sum_k |a_ik| |x_kj|`` per entry.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from benchmarks.spmv_bench import banded_csr as jbanded_csr
from multigrid_prj_tpu.amg import build_prolongation, coarsen_pmis
from multigrid_prj_tpu.models.fem import assemble_p1, structured_unit_square_mesh
from multigrid_prj_tpu.models.poisson import poisson_fd_csr
from multigrid_prj_tpu.ops.pallas_spmv import PallasELL
from multigrid_prj_tpu_torch.models.poisson import banded_csr
from multigrid_prj_tpu_torch.ops import cuda_spmv as cv
from multigrid_prj_tpu_torch.ops import cuda_stencil as cs
from multigrid_prj_tpu_torch.ops.sparse import HostCSR

torch.set_num_threads(1)
EPS32 = float(np.finfo(np.float32).eps)


def _port(M):
    return HostCSR(indptr=M.indptr, indices=M.indices, data=M.data,
                   shape=M.shape)


def _matrix(name):
    """The SpMV tests' matrices (RCM'd FD and P1, the rectangular P) and
    the benchmarks' banded matrix."""
    if name == "fd23":
        A = poisson_fd_csr(23)
        return A.permute(A.rcm_permutation())
    if name == "p1_mesh20":
        A, _ = assemble_p1(structured_unit_square_mesh(20))
        return A.permute(A.rcm_permutation())
    if name == "banded":
        return jbanded_csr(2048)
    A = poisson_fd_csr(16)
    Ap = A.permute(A.rcm_permutation())
    return build_prolongation(Ap, coarsen_pmis(Ap, 0.2, seed=1))  # n x nc


@pytest.mark.parametrize("name", ["fd23", "p1_mesh20", "rect_p", "banded"])
@pytest.mark.parametrize("nvec", [1, 4, 9])
def test_ell_spmm_twin_matches_pallas_and_f64(name, nvec):
    """nvec 9 is wider than one launch of the kernel (8): the card chunks
    it, and the twin computes the same columns."""
    A = _matrix(name)
    pA = PallasELL.build(A, dtype=jnp.float32, block_rows=1024)
    E = cv.CudaELL.build(_port(A), device="cpu")
    X = np.random.default_rng(nvec).standard_normal(
        (A.shape[1], nvec)).astype(np.float32)
    Xt = torch.from_numpy(X)
    cs.reset_launch_counts()
    got = E.spmm(Xt)
    assert sum(cs.LAUNCHES.values()) == 0  # the twin on the CPU
    assert got.shape == (A.shape[0], nvec) and got.dtype == torch.float32
    assert torch.equal(got, cv.ell_spmm_plain(E.colsT, E.valsT, Xt))
    for j in range(nvec):  # column by column the SpMV twin, bit for bit
        assert torch.equal(got[:, j], E.spmv(Xt[:, j].contiguous()))
    got = got.numpy()
    want = np.asarray(pA.spmm(jnp.asarray(X), interpret=True))
    bound = 4 * EPS32 * (np.abs(A.to_dense())
                         @ np.abs(X.astype(np.float64)))
    assert np.all(np.abs(got - want) <= bound)
    assert np.all(np.abs(got - A.spmm(X.astype(np.float64))) <= bound)


def test_ell_spmm_refuses_bad_blocks():
    E = cv.CudaELL.build(_port(poisson_fd_csr(5)), device="cpu")
    with pytest.raises(ValueError):
        E.spmm(torch.zeros(25))  # not a block
    with pytest.raises(ValueError):
        E.spmm(torch.zeros(24, 2))  # wrong height
    with pytest.raises(ValueError, match="operands on"):
        cv.ell_spmm(E.colsT, E.valsT, torch.zeros(25, 2, device="meta"))


@pytest.mark.parametrize("n", [1, 60, 4096])
def test_banded_csr_is_the_benchmarks_matrix(n):
    """The port keeps its own copy of ``benchmarks/spmv_bench.banded_csr``
    (the SpMV / SpMM benchmark matrix, K = 6): the same CSR."""
    want, got = jbanded_csr(n), banded_csr(n)
    assert got.shape == want.shape == (n, n)
    for f in ("indptr", "indices", "data"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
