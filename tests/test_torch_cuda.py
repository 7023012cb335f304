"""CUDA kernels of ``multigrid_prj_tpu_torch.ops.cuda_stencil`` vs their
plain torch twins, on the card (``cuda`` marker; skipped without a CUDA
device).  This file imports no jax, so it also runs where jax is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The kernels use the twins' operation order with no FMA contraction, so they
are held to them bit for bit (``torch.equal``).
"""

import numpy as np
import pytest
import torch

from multigrid_prj_tpu_torch.ops import cuda_stencil as cs
from multigrid_prj_tpu_torch.ops import extended as text

ALPHA = 10.0

# the main path's physical shapes at 1025^2 / pad 256, plus an exact layout
CUDA_SHAPES = [((1280, 1280), (1025, 1025)), ((640, 640), (513, 513)),
               ((320, 320), (257, 257)), ((160, 160), (129, 129)),
               ((80, 80), (65, 65)), ((40, 40), (33, 33)),
               ((385, 385), None)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc there)")
    return torch.device("cuda")


def _cuda_inputs(shape, logical, device):
    rng = np.random.default_rng(1)
    n = (logical or shape)[0]
    h = 10.0 / (n - 1)
    arrays = [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]
    arrays[2] *= np.float32(1e-8)
    u, b, u_lo = (torch.from_numpy(a).to(device) for a in arrays)
    return u, b, u_lo, h


@pytest.mark.cuda
@pytest.mark.parametrize("shape,logical", CUDA_SHAPES)
def test_cuda_kernels_equal_twins(cuda_device, shape, logical):
    u, b, u_lo, h = _cuda_inputs(shape, logical, cuda_device)
    got = cs.red_black_gauss_seidel(u, b, ALPHA, h, sweeps=2,
                                    logical_shape=logical)
    want = cs.red_black_gauss_seidel_plain(u, b, ALPHA, h, 2, logical)
    assert torch.equal(got, want)
    got = cs.poisson_residual(u, b, ALPHA, h, logical)
    assert torch.equal(got, cs.poisson_residual_plain(u, b, ALPHA, h, logical))
    d_hi, d_lo = text.ff_from_div(b, ALPHA / (h * h))
    args = (u, u_lo, d_hi, d_lo, b, ALPHA, h, logical)
    assert torch.equal(cs.ff_poisson_residual(*args),
                       cs.ff_poisson_residual_plain(*args))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_wrappers_count_and_refuse(cuda_device):
    u, b, _, h = _cuda_inputs((160, 160), (129, 129), cuda_device)
    cs.reset_launch_counts()
    cs.red_black_gauss_seidel(u, b, ALPHA, h, sweeps=3)
    cs.poisson_residual(u, b, ALPHA, h)
    assert cs.LAUNCHES == {"rbgs_color": 6, "residual": 1, "ff_residual": 0}
    with pytest.raises(NotImplementedError):
        cs.poisson_residual(u.double(), b.double(), ALPHA, h)
    with pytest.raises(NotImplementedError):
        cs.red_black_gauss_seidel(u, b, ALPHA, h, omega=1.2)


@pytest.mark.cuda
def test_cuda_solve_refined_matches_cpu_twins(cuda_device):
    """129^2 ff32 V(2,2) solve on the card vs the same solve through the
    twins on the CPU: the same iterations; histories differ only through
    the coarse matvec's and the norms' summation order."""
    from multigrid_prj_tpu_torch.gmg import GMGSolver
    from multigrid_prj_tpu_torch.models.poisson import assemble_rhs

    kw = dict(shape=(129, 129), num_levels=4, cycle="v", nu=2, tol=1e-8,
              maxit=60, pad_align=128)
    gpu = GMGSolver(device="cuda", **kw)
    b = assemble_rhs(gpu.levels[0], 10.0, test=1, device="cuda")
    cs.reset_launch_counts()
    got = gpu.solve_refined(b)
    assert all(v > 0 for v in cs.LAUNCHES.values())
    want = GMGSolver(device="cpu", use_pallas=True, **kw).solve_refined(b.cpu())
    assert got.converged and got.iterations == want.iterations
    np.testing.assert_allclose(got.history, want.history, rtol=1e-3)
