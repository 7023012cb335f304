"""``chip_smoke.amg_launches``, the ELL launches an AMG solve on the kernel
path should make, held to the wrapper calls of the same solves through the
kernels' twins on the CPU (each wrapper counted once a call, as
``LAUNCHES`` counts a launch on the card): FD 96^2 with Chebyshev, at the
default ``pallas_min_rows`` (the finest level and its prolongation on the
kernels, the next levels dense) and at 64 (every transfer on the kernels,
the levels of at most ``DENSE_MAX_ROWS`` rows still dense).
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import chip_smoke
from multigrid_prj_tpu_torch.amg import AMGSolver
from multigrid_prj_tpu_torch.models.poisson import poisson_fd_csr
from multigrid_prj_tpu_torch.ops import cuda_spmv as cv

torch.set_num_threads(1)

# wrapper -> its LAUNCHES key
WRAPPERS = {"ell_local_spmv": "spmv", "ell_spmv_axpy": "spmv_axpy",
            "ell_cheb_step": "cheb_step", "ell_ff_residual": "ff_residual_ell"}
SOLVES = (("solve", 1e-5), ("solve_pcg", 1e-5), ("solve_refined", 1e-8))


@functools.cache
def _solver(min_rows):
    return AMGSolver(poisson_fd_csr(96), num_levels=5, min_coarse=50,
                     smoother="chebyshev", dtype=torch.float32,
                     use_pallas=True, pallas_min_rows=min_rows, device="cpu")


@pytest.mark.parametrize("min_rows", [4096, 64])
@pytest.mark.parametrize("method,tol", SOLVES)
def test_the_launch_model_counts_the_wrapper_calls(monkeypatch, min_rows,
                                                   method, tol):
    counts = dict.fromkeys(WRAPPERS.values(), 0)
    for name, key in WRAPPERS.items():
        def counted(*args, _fn=getattr(cv, name), _key=key):
            counts[_key] += 1
            return _fn(*args)
        monkeypatch.setattr(cv, name, counted)
    solver = _solver(min_rows)
    lv = solver.levels
    assert lv[0].A_fast is not None and lv[1].A_dense is not None
    assert (lv[1].P_fast is not None) == (min_rows == 64)
    b = torch.from_numpy(np.random.default_rng(3).standard_normal(
        solver.level_sizes[0]).astype(np.float32))
    res = getattr(solver, method)(b, tol=tol)
    assert 2 < res.iterations < 40
    want = chip_smoke.amg_launches(solver, method, res.iterations)
    assert counts == want
    assert want["cheb_step"] > 0 and want["spmv_axpy"] > 0
