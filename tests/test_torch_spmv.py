"""Twins of the CUDA ELL kernels (``ops/cuda_spmv.py``) vs the JAX Pallas
kernels in interpret mode and vs the f64 host oracle, on the CPU; and the
``CudaELL`` layout and wrappers.

Bounds: the SpMV twin sums its slots in order, the Pallas kernel with a
vector reduction, so they are held to 4 ulp (f32) of ``sum_k |a_ik| |x_k|``
per row.  The float-float residual is held to the f64 residual of the pair
system within one f32 rounding of the result plus ``1e-12`` of
``|b| + |A| |x|``, and to the Pallas kernel within the same bound.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multigrid_prj_tpu.amg import build_prolongation, coarsen_pmis
from multigrid_prj_tpu.models.fem import assemble_p1, structured_unit_square_mesh
from multigrid_prj_tpu.models.poisson import poisson_fd_csr
from multigrid_prj_tpu.ops.pallas_spmv import PallasELL
from multigrid_prj_tpu_torch.ops import cuda_spmv as cv
from multigrid_prj_tpu_torch.ops import cuda_stencil as cs
from multigrid_prj_tpu_torch.ops.sparse import HostCSR
from multigrid_prj_tpu_torch.ops.sparse_extended import (
    ELLPair,
    ell_residual_ff,
    ff_pair_from_f64,
)

torch.set_num_threads(1)
EPS32 = float(np.finfo(np.float32).eps)


def _port(M):
    return HostCSR(indptr=M.indptr, indices=M.indices, data=M.data,
                   shape=M.shape)


def _matrix(name):
    """The JAX kernel tests' matrices (tests/test_pallas_spmv.py), in the
    RCM order the JAX AMG path gives them."""
    if name == "fd23":
        A = poisson_fd_csr(23)
        return A.permute(A.rcm_permutation())
    if name == "p1_mesh20":
        A, _ = assemble_p1(structured_unit_square_mesh(20))
        return A.permute(A.rcm_permutation())
    A = poisson_fd_csr(16)
    Ap = A.permute(A.rcm_permutation())
    return build_prolongation(Ap, coarsen_pmis(Ap, 0.2, seed=1))  # n x nc


def _spmv_bound(A, x):
    return 4 * EPS32 * (np.abs(A.to_dense()) @ np.abs(x.astype(np.float64)))


@pytest.mark.parametrize("name", ["fd23", "p1_mesh20", "rect_p"])
def test_ell_spmv_twin_matches_pallas(name):
    A = _matrix(name)
    pA = PallasELL.build(A, dtype=jnp.float32, block_rows=1024)
    E = cv.CudaELL.build(_port(A), device="cpu")
    x = np.random.default_rng(0).standard_normal(A.shape[1]) \
        .astype(np.float32)
    cs.reset_launch_counts()
    got = E.spmv(torch.from_numpy(x)).numpy()
    assert sum(cs.LAUNCHES.values()) == 0  # the twin on the CPU
    assert np.array_equal(
        got, cv.ell_spmv_plain(E.colsT, E.valsT, torch.from_numpy(x)).numpy())
    want = np.asarray(pA.spmv(jnp.asarray(x), interpret=True))
    bound = _spmv_bound(A, x)
    assert got.shape == (A.shape[0],)
    assert np.all(np.abs(got - want) <= bound)
    assert np.all(np.abs(got - A.spmv(x.astype(np.float64))) <= bound)


def test_ell_spmv_non_banded_matches_oracle():
    """A randomly permuted FD matrix and a scattered random one: the TPU
    build refuses such bands (``PallasELL.build`` returns None); the CUDA
    layout takes them."""
    rng = np.random.default_rng(5)
    A = poisson_fd_csr(30)
    A = A.permute(rng.permutation(A.shape[0]))
    n = 4096
    S = HostCSR.from_coo(np.repeat(np.arange(n), 3), rng.integers(0, n, 3 * n),
                         rng.standard_normal(3 * n), (n, n))
    assert PallasELL.build(S, max_t_win=4) is None
    for M in (_port(A), S):
        E = cv.CudaELL.build(M, device="cpu")
        x = rng.standard_normal(M.shape[1]).astype(np.float32)
        got = E.spmv(torch.from_numpy(x)).numpy()
        assert np.all(np.abs(got - M.spmv(x.astype(np.float64)))
                      <= _spmv_bound(M, x))


def test_cuda_ell_layout():
    # row 0: 2 entries, row 1: empty, row 2: 3 entries; 4 columns
    M = HostCSR.from_coo([0, 0, 2, 2, 2], [3, 1, 0, 2, 3],
                         [1.0, 2.0, 3.0, 4.0, 5.0], (3, 4))
    E = cv.CudaELL.build(M, pair=True, device="cpu")
    assert E.colsT.dtype == torch.int32 and E.valsT.dtype == torch.float32
    assert E.k == 3 and E.nnz == 5 and E.nnz_dense == 9
    # padding slots: value 0 at the row's first column (empty rows: 0)
    assert E.colsT.T.tolist() == [[1, 3, 1], [0, 0, 0], [0, 2, 3]]
    assert E.valsT.T.tolist() == [[2.0, 1.0, 0.0], [0.0, 0.0, 0.0],
                                  [3.0, 4.0, 5.0]]
    assert torch.count_nonzero(E.valsT_lo) == 0
    x = torch.arange(4, dtype=torch.float32)
    assert E.spmv(x).tolist() == [5.0, 0.0, 23.0]
    with pytest.raises(ValueError):
        E.spmv(x[:3])
    with pytest.raises(ValueError):  # rectangular
        E.residual_ff(x, x, x, x)
    with pytest.raises(ValueError):  # no low words
        cv.CudaELL.build(_port(poisson_fd_csr(3)), device="cpu").residual_ff(
            *[torch.zeros(9)] * 4)
    # operands split between the CPU and another device are refused
    with pytest.raises(ValueError, match="operands on"):
        cv.ell_local_spmv(E.colsT, E.valsT, x.to("meta"))
    with pytest.raises(ValueError, match="operands on"):
        cv.ell_ff_residual(E.colsT, E.valsT, E.valsT_lo, *[x[:3]] * 3,
                           x[:3].to("meta"))


def _ff_case(A, seed):
    """Pairs near the solution, where the residual cancels: x from the f64
    solve of a perturbed rhs."""
    rng = np.random.default_rng(seed)
    x64 = rng.standard_normal(A.shape[0])
    b64 = A.spmv(x64) + 1e-6 * rng.standard_normal(A.shape[0])
    return (ff_pair_from_f64(b64, device="cpu")
            + ff_pair_from_f64(x64, device="cpu"))


def _ff_oracle(A, bh, bl, xh, xl):
    """The pair system's residual in f64, and the bound's scale."""
    Ad = A.to_dense()
    vh = Ad.astype(np.float32).astype(np.float64)
    vl = (Ad - vh).astype(np.float32).astype(np.float64)
    xp = xh.numpy().astype(np.float64) + xl.numpy()
    bp = bh.numpy().astype(np.float64) + bl.numpy()
    r64 = bp - (vh + vl) @ xp
    return r64, np.abs(bp) + np.abs(Ad) @ np.abs(xp)


@pytest.mark.parametrize("name", ["fd23", "p1_mesh20"])
def test_ell_ff_residual_twin_matches_pallas_and_f64(name):
    A = _matrix(name)
    pA = PallasELL.build(A, dtype=jnp.float32, block_rows=1024, pair=True)
    E = cv.CudaELL.build(_port(A), pair=True, device="cpu")
    bh, bl, xh, xl = _ff_case(A, 7)
    got = E.residual_ff(bh, bl, xh, xl).numpy()
    assert np.array_equal(got, cv.ell_ff_residual_plain(
        E.colsT, E.valsT, E.valsT_lo, bh, bl, xh, xl).numpy())
    want = np.asarray(pA.residual_ff(*(jnp.asarray(v.numpy())
                                       for v in (bh, bl, xh, xl)),
                                     interpret=True))
    r64, scale = _ff_oracle(A, bh, bl, xh, xl)
    bound = EPS32 * np.abs(r64) + 1e-12 * scale
    assert np.all(np.abs(got - r64) <= bound)
    assert np.all(np.abs(want - r64) <= bound)
    assert np.all(np.abs(got - want) <= 2 * bound)
    # the gather form (the solver's path with the kernels off) agrees too
    gat = ell_residual_ff(ELLPair.from_host_csr(_port(A), device="cpu"), bh,
                          bl, xh, xl)
    assert np.all(np.abs(gat.numpy() - r64) <= bound)
    # and a plain f32 residual cannot: the point of the pair arithmetic
    plain = (bh - E.spmv(xh)).numpy()
    assert np.abs(plain - r64).max() > 100 * np.abs(got - r64).max()


def test_ff_pair_from_tensor_equals_host_split():
    """A tensor is split where it lies; the pair equals the host split of
    the same values to the bit (f64 and f32 inputs)."""
    v = np.random.default_rng(4).standard_normal(1000) * 1e3
    want = ff_pair_from_f64(v, device="cpu")
    for t in (torch.from_numpy(v), torch.from_numpy(v).float()):
        got = ff_pair_from_f64(t, device="cpu")
        ref = ff_pair_from_f64(t.double().numpy(), device="cpu")
        assert all(g.dtype == torch.float32 for g in got)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    got = ff_pair_from_f64(torch.from_numpy(v), device="cpu")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # an f32 vector has no low word
    assert torch.count_nonzero(ff_pair_from_f64(
        torch.from_numpy(v).float(), device="cpu")[1]) == 0
