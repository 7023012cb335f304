"""CUDA kernels of ``multigrid_prj_tpu_torch.ops.cuda_stencil`` and
``ops.cuda_stencil_3d`` vs their plain torch twins, and 2D and 3D solves on
the card against the same solves through the twins on the CPU (``cuda``
marker; skipped without a CUDA device).  This file imports no jax, so it
also runs where jax is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The kernels use the twins' operation order with no FMA contraction, so they
are held to them bit for bit (``torch.equal``).
"""

import numpy as np
import pytest
import torch

from multigrid_prj_tpu_torch.ops import cuda_stencil as cs
from multigrid_prj_tpu_torch.ops import cuda_stencil_3d as c3
from multigrid_prj_tpu_torch.ops import extended as text

ALPHA = 10.0

# the main path's physical shapes at 1025^2 / pad 256, plus an exact layout
CUDA_SHAPES = [((1280, 1280), (1025, 1025)), ((640, 640), (513, 513)),
               ((320, 320), (257, 257)), ((160, 160), (129, 129)),
               ((80, 80), (65, 65)), ((40, 40), (33, 33)),
               ((385, 385), None)]
# the finest level of the 8193^2 / pad 256 path
SCALE_SHAPE = ((8448, 8448), (8193, 8193))
# 3D (physical, logical): config 4's exact 257^3 levels, its levels with
# pad_align=(8, 8, 128), the 65^3 padded hierarchy, the 513^3 finest level,
# and a non-cubic shape that catches swapped axes
CUDA_SHAPES_3D = [((257, 257, 257), None), ((129, 129, 129), None),
                  ((65, 65, 65), None), ((33, 33, 33), None),
                  ((17, 17, 17), None), ((264, 264, 384), (257, 257, 257)),
                  ((132, 132, 192), (129, 129, 129)),
                  ((66, 66, 96), (65, 65, 65)), ((72, 72, 128), (65, 65, 65)),
                  ((36, 36, 64), (33, 33, 33)), ((18, 18, 32), (17, 17, 17)),
                  ((9, 9, 9), None), ((20, 24, 136), (17, 21, 129)),
                  ((513, 513, 513), None)]


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
@pytest.mark.parametrize("shape,logical", CUDA_SHAPES + [SCALE_SHAPE])
def test_cuda_apply_jacobi_transfers_equal_twins(cuda_device, shape,
                                                 logical):
    u, b, _, h = _cuda_inputs(shape, logical, cuda_device)
    assert torch.equal(cs.poisson_apply(u, ALPHA, h, logical),
                       cs.poisson_apply_plain(u, ALPHA, h, logical))
    for omega in (1.0, 0.8):
        got = cs.jacobi(u, b, ALPHA, h, omega=omega, sweeps=3,
                        logical_shape=logical)
        want = cs.jacobi_plain(u, b, ALPHA, h, omega, 3, logical)
        assert torch.equal(got, want)
    n, m = shape
    if n % 2 == 0:  # the transfers run on the (even) padded levels
        lg = logical or shape
        assert torch.equal(cs.restrict_fw_padded_fast(u, lg),
                           cs.restrict_fw_padded_fast_plain(u, lg))
        e = b[: n // 2, : m // 2].contiguous()
        assert torch.equal(cs.prolong_add_padded_fast(e, u),
                           cs.prolong_add_padded_fast_plain(e, u))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_wrappers_count_and_refuse(cuda_device):
    u, b, _, h = _cuda_inputs((160, 160), (129, 129), cuda_device)
    u0 = u.clone()
    cs.reset_launch_counts()
    cs.red_black_gauss_seidel(u, b, ALPHA, h, sweeps=3)
    cs.poisson_residual(u, b, ALPHA, h)
    cs.poisson_apply(u, ALPHA, h)
    cs.jacobi(u, b, ALPHA, h, omega=0.8, sweeps=3)
    rc = cs.restrict_fw_padded_fast(u, (129, 129))
    cs.prolong_add_padded_fast(rc, u)
    # SOR is the plain smoother (no launch), as in the JAX kernel wrapper
    cs.red_black_gauss_seidel(u, b, ALPHA, h, omega=1.2)
    # the chain: a launch per group of <= 8 applies
    cs.poisson_apply_chain(u, h * h, h, 11)
    # Jacobi: one fused launch per group of <= 8 sweeps; the oracles count
    # under their own keys
    cs._jacobi_per_sweep(u, b, ALPHA, h, 0.8, 3)
    cs._prolong_add_point(rc, u)
    assert {k: v for k, v in cs.LAUNCHES.items() if v} == {
        "rbgs_fused": 1, "residual": 1, "apply": 1, "jacobi": 1,
        "restrict_fw": 1, "prolong_add": 1, "apply_chain": 2,
        "jacobi_sweep": 3, "prolong_add_point": 1}
    assert torch.equal(u, u0)
    with pytest.raises(NotImplementedError):
        cs.poisson_residual(u.double(), b.double(), ALPHA, h)
    with pytest.raises(ValueError):
        cs.restrict_fw_padded_fast(u[:, :159].contiguous(), (129, 129))
    with pytest.raises(ValueError):
        cs.prolong_add_padded_fast(rc[:, :79].contiguous(), u)


# the fused smoother's shapes: the 1025^2 path's levels (with an exact odd
# layout, whose m % 4 != 0 takes the scalar stores), the 8193^2 finest
# level, and an odd unpadded shape smaller than two tiles across
FUSED_SHAPES = CUDA_SHAPES + [SCALE_SHAPE, ((255, 383), None)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,logical", FUSED_SHAPES)
def test_cuda_fused_rbgs_equals_twin_and_per_colour_oracle(cuda_device,
                                                           shape, logical):
    """The fused smoother at sweeps 0-9 (one launch per group of <= 4:
    9 -> 4 + 4 + 1), bit-equal to its twin and to the per-colour oracle's
    2 x sweeps ``rbgs_color`` launches; ``u`` is never written."""
    u, b, _, h = _cuda_inputs(shape, logical, cuda_device)
    u0 = u.clone()
    for sweeps in range(10):
        cs.reset_launch_counts()
        got = cs.red_black_gauss_seidel(u, b, ALPHA, h, sweeps=sweeps,
                                        logical_shape=logical)
        torch.cuda.synchronize()
        assert cs.LAUNCHES["rbgs_fused"] == -(-sweeps // 4), sweeps
        assert sum(cs.LAUNCHES.values()) == -(-sweeps // 4), sweeps
        assert got.data_ptr() != u.data_ptr()
        want = cs.red_black_gauss_seidel_plain(u, b, ALPHA, h, sweeps,
                                               logical)
        assert torch.equal(got, want), sweeps
        oracle = cs._rbgs_per_colour(u, b, ALPHA, h, sweeps, logical)
        assert cs.LAUNCHES["rbgs_color"] == 2 * sweeps
        assert torch.equal(got, oracle), sweeps
        assert torch.equal(u, u0), sweeps
        del got, want, oracle
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_fused_rbgs_refusals(cuda_device):
    """What the fused kernels do not take is refused, by the wrapper or by
    the C entry point (a group of more than 4 sweeps, a down-leg of more
    than 3, a tile geometry other than the compiled one), before any
    launch."""
    import ctypes

    from multigrid_prj_tpu_torch.kernels._build import library

    u, b, _, h = _cuda_inputs((160, 160), (129, 129), cuda_device)
    out = torch.empty_like(u)
    rc = torch.empty((80, 80), device=cuda_device)
    lib, stream = library(), cs._stream()
    p = cs._ptr
    good = cs._geometry(4)
    assert lib.mg_rbgs_fused(p(u), p(b), p(out), 160, 160, 129, 129, 0.1, 2,
                             good, stream) == 0
    for sweeps, geom in ((5, cs._geometry(8)), (0, good), (1, good),
                         (2, (ctypes.c_int * 4)(4, 4, 96, 128))):
        assert lib.mg_rbgs_fused(p(u), p(b), p(out), 160, 160, 129, 129, 0.1,
                                 sweeps, geom, stream) != 0, sweeps
    for sweeps, geom in ((4, cs._geometry(8)), (2, good)):
        assert lib.mg_rbgs_resfilter(p(u), p(b), p(out), p(rc), 160, 160,
                                     129, 129, 0.1, 10.0, sweeps, geom,
                                     stream) != 0, sweeps
    assert lib.mg_rbgs_resfilter(p(u), p(b), p(out), p(rc), 159, 160, 129,
                                 129, 0.1, 10.0, 2, cs._geometry(6),
                                 stream) != 0
    cs.reset_launch_counts()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        cs.red_black_gauss_seidel(u.double(), b.double(), ALPHA, h)
    with pytest.raises(ValueError):
        cs.red_black_gauss_seidel(u, b[:, :159].contiguous(), ALPHA, h)
    with pytest.raises(ValueError):
        cs.red_black_gauss_seidel(u.t(), b, ALPHA, h)
    with pytest.raises(ValueError):
        cs._rbgs_per_colour(u.cpu(), b.cpu(), ALPHA, h)
    with pytest.raises(ValueError, match="even"):
        cs.rbgs_residual_restrict(u[:159].contiguous(),
                                  b[:159].contiguous(), ALPHA, h, 2,
                                  (129, 129))
    assert sum(cs.LAUNCHES.values()) == 0
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,logical", CUDA_SHAPES_3D)
def test_cuda_3d_kernels_equal_twins(cuda_device, shape, logical):
    u, b, _, h = _cuda_inputs(shape, logical, cuda_device)
    assert torch.equal(c3.poisson_apply_3d(u, ALPHA, h, logical),
                       c3.poisson_apply_3d_plain(u, ALPHA, h, logical))
    assert torch.equal(c3.poisson_residual_3d(u, b, ALPHA, h, logical),
                       c3.poisson_residual_3d_plain(u, b, ALPHA, h, logical))
    got = c3.red_black_gauss_seidel_3d(u, b, ALPHA, h, sweeps=2,
                                       logical_shape=logical)
    want = c3.red_black_gauss_seidel_3d_plain(u, b, ALPHA, h, 2, logical)
    assert torch.equal(got, want)
    for omega in (1.0, 0.8):
        got = c3.jacobi_3d(u, b, ALPHA, h, omega=omega, sweeps=3,
                           logical_shape=logical)
        want = c3.jacobi_3d_plain(u, b, ALPHA, h, omega, 3, logical)
        assert torch.equal(got, want)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_3d_wrappers_count_and_refuse(cuda_device):
    u, b, _, h = _cuda_inputs((36, 36, 64), (33, 33, 33), cuda_device)
    u0 = u.clone()
    cs.reset_launch_counts()
    # through the 2D module's entry points, as the solver calls them
    cs.red_black_gauss_seidel(u, b, ALPHA, h, sweeps=3)
    cs.poisson_residual(u, b, ALPHA, h)
    cs.poisson_apply(u, ALPHA, h)
    cs.jacobi(u, b, ALPHA, h, omega=0.8, sweeps=3)
    # SOR is the plain smoother (no launch), as in the JAX kernel wrapper
    cs.red_black_gauss_seidel(u, b, ALPHA, h, omega=1.2)
    # the oracles of the redesigned kernels count under their own keys
    c3._apply3d_launch(u, ALPHA, h, None, "apply3d_point")
    c3._jacobi3d_per_sweep(u, b, ALPHA, h, 0.8, 3)
    # 3 Jacobi sweeps are one launch of the march, 3 of the per-sweep oracle
    assert {k: v for k, v in cs.LAUNCHES.items() if v} == {
        "apply3d": 1, "residual3d": 1, "rbgs3d_fused": 1, "jacobi3d": 1,
        "apply3d_point": 1, "jacobi3d_sweep": 3}
    assert torch.equal(u, u0)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        cs.poisson_residual(u.double(), b.double(), ALPHA, h)
    with pytest.raises(ValueError):
        c3.poisson_residual_3d(u, b[:, :, :63].contiguous(), ALPHA, h)
    # the 2D module's padded transfers and float-float residual take no 3D
    # tensor (the 3D kernels are cuda_stencil_3d's): refused, no fallback
    # inside the wrapper
    for call in (lambda: cs.restrict_fw_padded_fast(u, (33, 33, 33)),
                 lambda: cs.prolong_add_padded_fast(u[:18, :18, :32]
                                                    .contiguous(), u),
                 lambda: cs.ff_poisson_residual(u, u, u, u, b, ALPHA, h)):
        with pytest.raises(NotImplementedError, match="2D"):
            call()


# the fused 3D smoother's shapes: config 4's levels (the 17^3 bottom on the
# resident route), padded levels, a non-cubic shape, one whose x-y extents
# are no multiple of the tile core, 257^3 (one z-chunk of 257 planes) and
# 129^3 (z-chunks of 26, 43, 65 and 129 planes at 1-4 sweeps)
FUSED3D_SHAPES = [((17, 17, 17), None), ((18, 18, 32), (17, 17, 17)),
                  ((33, 33, 33), None), ((36, 36, 64), (33, 33, 33)),
                  ((65, 65, 65), None), ((20, 24, 136), (17, 21, 129)),
                  ((19, 53, 101), None), ((257, 257, 257), None),
                  ((129, 129, 129), None)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,logical", FUSED3D_SHAPES)
def test_cuda_rbgs3d_fused_equals_twin_and_per_colour_oracle(cuda_device,
                                                             shape, logical):
    """The fused 3D smoother at sweeps 0-9 (z-marching: one launch per
    group of <= 4; resident: one launch), bit-equal to its twin and to the
    per-colour oracle's 2 x sweeps ``rbgs3d_color`` launches; ``u`` is
    never written.  The 17^3 bottom also at its 100 sweeps."""
    u, b, _, h = _cuda_inputs(shape, logical, cuda_device)
    u0 = u.clone()
    resident = c3.rbgs3d_route(shape) == "resident"
    counts = list(range(10)) + ([100] if resident else [])
    for sweeps in counts:
        cs.reset_launch_counts()
        got = c3.red_black_gauss_seidel_3d(u, b, ALPHA, h, sweeps=sweeps,
                                           logical_shape=logical)
        torch.cuda.synchronize()
        n = min(sweeps, 1) if resident else -(-sweeps // 4)
        assert cs.LAUNCHES["rbgs3d_fused"] == n, sweeps
        assert sum(cs.LAUNCHES.values()) == n, sweeps
        assert got.data_ptr() != u.data_ptr()
        want = c3.red_black_gauss_seidel_3d_plain(u, b, ALPHA, h, sweeps,
                                                  logical)
        assert torch.equal(got, want), sweeps
        oracle = c3._rbgs3d_per_colour(u, b, ALPHA, h, sweeps, logical)
        assert cs.LAUNCHES["rbgs3d_color"] == 2 * sweeps
        assert torch.equal(got, oracle), sweeps
        assert torch.equal(u, u0), sweeps
        del got, want, oracle
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_rbgs3d_fused_refusals(cuda_device):
    """What the fused 3D kernels do not take is refused by the C entry
    points before any launch: a z-marching group of more than 4 sweeps or
    none, a tile geometry other than the compiled one, a z-chunk other than
    the rule's for the shape (one plane more or less, or the whole march),
    a resident array above the cap, a cap other than the compiled one."""
    import ctypes

    from multigrid_prj_tpu_torch.kernels._build import library

    lib, stream, p = library(), cs._stream(), cs._ptr
    u, b, _, h = _cuda_inputs((36, 36, 64), (33, 33, 33), cuda_device)
    out = torch.empty_like(u)
    dims = (36, 36, 64, 33, 33, 33, 400.0, 1.0 / 6.0)
    good = c3._geometry3d(4, u.shape)
    assert lib.mg_rbgs3d_fused(p(u), p(b), p(out), *dims, 2, good,
                               stream) == 0
    tile = c3.rbgs3d_tile(4, u.shape)
    assert tile[6] == 2  # 6 tiles: 22 chunks a tile, of 2 planes
    bad_rows = (ctypes.c_int * 7)(*(tile[:2] + (16,) + tile[3:]))
    bad_ring = (ctypes.c_int * 7)(*(tile[:4] + (6, 6) + tile[6:]))
    bad_chunks = [(ctypes.c_int * 7)(*(tile[:6] + (zc,)))
                  for zc in (tile[6] - 1, tile[6] + 1, 36)]  # 36: whole
    for sweeps, geom in ((5, c3._geometry3d(8, u.shape)), (0, good),
                         (1, good), (2, bad_rows), (2, bad_ring),
                         *((2, g) for g in bad_chunks)):
        assert lib.mg_rbgs3d_fused(p(u), p(b), p(out), *dims, sweeps, geom,
                                   stream) != 0, sweeps
    cap = c3.RESIDENT_MAX_POINTS
    small = torch.zeros((17, 17, 17), device=cuda_device)
    sdims = (17, 17, 17, 17, 17, 17, 256.0, 1.0 / 6.0)
    assert lib.mg_rbgs3d_resident(p(small), p(small), p(out), *sdims, 100,
                                  cap, stream) == 0
    assert lib.mg_rbgs3d_resident(p(small), p(small), p(out), *sdims, 1,
                                  cap + 1, stream) != 0
    assert lib.mg_rbgs3d_resident(p(small), p(small), p(out), *sdims, 0,
                                  cap, stream) != 0
    assert lib.mg_rbgs3d_resident(p(u), p(b), p(out), *dims, 1, cap,
                                  stream) != 0  # 82944 points
    cs.reset_launch_counts()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        c3.red_black_gauss_seidel_3d(u.double(), b.double(), ALPHA, h)
    with pytest.raises(ValueError):
        c3._rbgs3d_per_colour(u.cpu(), b.cpu(), ALPHA, h)
    assert sum(cs.LAUNCHES.values()) == 0
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_3d_solve_launch_counts_fused_and_per_colour(cuda_device):
    """33^3 with 2 levels: the 17^3 bottom (4913 points, above the dense
    inverse's 4608) takes the resident route, so an iteration launches 3
    ``rbgs3d_fused`` (pre- and post-smoothing, the bottom's 100 sweeps)
    against 208 ``rbgs3d_color`` on the per-colour path (the smoother
    swapped for the oracle), with the same history and solution bit for
    bit."""
    from multigrid_prj_tpu_torch.gmg import GMGSolver

    assert set(cs.LAUNCHES) >= {"rbgs3d_fused", "rbgs3d_color",
                                "rbgs_fused_ext", "apply_chain"}
    kw = dict(shape=(33, 33, 33), length=1.0, alpha=1.0, num_levels=2,
              cycle="v", nu=2, tol=1e-6, maxit=40)
    runs = {}
    for path in ("fused", "per-colour"):
        s = GMGSolver(device="cuda", **kw)
        assert s._coarse_inv is None
        if path == "per-colour":
            s._f32_route = s._f32_route._replace(
                smooth=lambda u, b, alpha, h, sweeps=1, logical_shape=None:
                c3._rbgs3d_per_colour(u, b, alpha, h, sweeps, logical_shape))
        b = _rhs_3d(s.levels[0], "cuda")
        cs.reset_launch_counts()
        res = s.solve_refined(b)
        torch.cuda.synchronize()
        runs[path] = (res, dict(cs.LAUNCHES))
    (fused, cf), (colour, cc) = runs["fused"], runs["per-colour"]
    assert fused.converged and fused.iterations == colour.iterations
    assert cf["rbgs3d_fused"] == 3 * fused.iterations
    assert cf["rbgs3d_color"] == 0 and cc["rbgs3d_fused"] == 0
    assert cc["rbgs3d_color"] == 208 * colour.iterations
    np.testing.assert_array_equal(fused.history, colour.history)
    assert torch.equal(fused.u, colour.u)


@pytest.mark.cuda
def test_cuda_config4_solve_chunked_march_equals_per_colour(cuda_device):
    """BASELINE config 4 (257^3, 5 levels, V(2,2), ff32 to 1e-8): 11
    iterations and 99 ``rbgs3d_fused`` launches (per iteration 8 calls of
    the z-chunked march at 257^3 .. 33^3 and the 17^3 bottom's resident
    one), with the history and ``u`` bit-equal to the same solve on the
    per-colour path (2552 ``rbgs3d_color``)."""
    from multigrid_prj_tpu_torch.gmg import GMGSolver

    kw = dict(shape=(257, 257, 257), length=1.0, alpha=1.0, num_levels=5,
              cycle="v", nu=2, pre_sweeps=2, tol=1e-8, maxit=60)
    runs = {}
    for path in ("fused", "per-colour"):
        s = GMGSolver(device="cuda", **kw)
        if path == "per-colour":
            s._f32_route = s._f32_route._replace(
                smooth=lambda u, b, alpha, h, sweeps=1, logical_shape=None:
                c3._rbgs3d_per_colour(u, b, alpha, h, sweeps, logical_shape))
        b = _rhs_3d(s.levels[0], "cuda")
        cs.reset_launch_counts()
        res = s.solve_refined(b)
        torch.cuda.synchronize()
        runs[path] = (res, dict(cs.LAUNCHES))
        del s, b
    (fused, cf), (colour, cc) = runs["fused"], runs["per-colour"]
    assert fused.converged and fused.iterations == colour.iterations == 11
    assert cf["rbgs3d_fused"] == 99 and cf["rbgs3d_color"] == 0
    assert cc["rbgs3d_fused"] == 0 and cc["rbgs3d_color"] == 2552
    np.testing.assert_array_equal(fused.history, colour.history)
    assert torch.equal(fused.u, colour.u)


@pytest.mark.cuda
@pytest.mark.parametrize("extra,inner_cg,need,rtol,atol", [
    ({}, 0, (), 1e-3, 0.0), ({}, 2, ("apply",), 1e-2, 1e-12),
    (dict(smoother="jacobi", omega=0.8), 0, ("jacobi",), 1e-3, 0.0)])
def test_cuda_solve_refined_matches_cpu_twins(cuda_device, extra, inner_cg,
                                              need, rtol, atol):
    """129^2 ff32 V(2,2) solves on the card (RB-GS, RB-GS with inner_cg,
    Jacobi) vs the same solves through the twins on the CPU: the same
    iterations; histories differ only through the coarse matvec's and the
    norms' and dot products' summation order.  CG's dot products carry that
    into every correction, and inner_cg's last entry (~9e-12) sits at the
    round-off floor of the extended residual: measured on an H100, 2.8e-13
    apart (3.4 % relative), so that case adds an absolute 1e-12."""
    from multigrid_prj_tpu_torch.gmg import GMGSolver
    from multigrid_prj_tpu_torch.models.poisson import assemble_rhs

    kw = dict(shape=(129, 129), num_levels=4, cycle="v", nu=2, tol=1e-8,
              maxit=60, pad_align=128, **extra)
    gpu = GMGSolver(device="cuda", **kw)
    b = assemble_rhs(gpu.levels[0], 10.0, test=1, device="cuda")
    cs.reset_launch_counts()
    got = gpu.solve_refined(b, inner_cg=inner_cg)
    smoother = "jacobi" if extra else "rbgs_fused"
    for k in (smoother, "residual", "ff_residual", "restrict_fw",
              "prolong_add") + need:
        assert cs.LAUNCHES[k] > 0, k
    assert cs.LAUNCHES["rbgs_color"] == 0  # the oracle is on no path
    # the 2D float-float residual: the first residual on its own kernel,
    # each later one fused with the pair update before it; none of the 3D
    # kernels
    assert cs.LAUNCHES["ff_residual"] == 1
    assert cs.LAUNCHES["ff_update_residual"] == got.iterations
    assert cs.LAUNCHES["ff_residual3d"] == 0
    assert cs.LAUNCHES["ff_update_residual3d"] == 0
    want = GMGSolver(device="cpu", use_pallas=True, **kw).solve_refined(
        b.cpu(), inner_cg=inner_cg)
    assert got.converged and got.iterations == want.iterations
    np.testing.assert_allclose(got.history, want.history, rtol=rtol,
                               atol=atol)


def _rhs_3d(level, device):
    """BASELINE config 4's smooth 3D pair (bench.py's measure_vcycle3d)."""
    from multigrid_prj_tpu_torch.models.poisson import assemble_rhs

    return assemble_rhs(
        level, 1.0, device=device,
        f=lambda x, y, z: torch.sin(3.0 * x) * torch.cos(2.0 * y) + z,
        g=lambda x, y, z: torch.exp(x) * torch.exp(-2.0 * y) * z)


@pytest.mark.cuda
@pytest.mark.parametrize("extra,inner_cg,need", [
    ({}, 0, ("rbgs3d_fused", "residual3d")),
    (dict(pad_align=(8, 8, 128)), 2, ("rbgs3d_fused", "residual3d",
                                      "apply3d")),
    (dict(smoother="jacobi", omega=0.8), 0, ("jacobi3d", "residual3d"))])
def test_cuda_3d_solve_refined_matches_cpu_twins(cuda_device, extra,
                                                 inner_cg, need):
    """33^3 ff32 V(2,2) solves on the card (config 4's shape cut to 3
    levels; RB-GS, padded RB-GS with inner_cg, Jacobi) vs the same solves
    through the twins on the CPU: the same iterations, histories within
    1e-2 relative plus 1e-12 (the coarse matvec, norms and dot products sum
    in another order on the two devices).  The 2D kernels never launch: the
    3D transfers run their kernels at exact levels (2 a cycle) and plain
    ops at padded ones, and the float-float residual launches its 3D kernel
    for the first outer residual and the fused update-and-residual kernel
    for each later one (iterations)."""
    from multigrid_prj_tpu_torch.gmg import GMGSolver

    kw = dict(shape=(33, 33, 33), length=1.0, alpha=1.0, num_levels=3,
              cycle="v", nu=2, tol=1e-8, maxit=40, **extra)
    gpu = GMGSolver(device="cuda", **kw)
    b = _rhs_3d(gpu.levels[0], "cuda")
    cs.reset_launch_counts()
    got = gpu.solve_refined(b, inner_cg=inner_cg)
    torch.cuda.synchronize()
    for k in need:
        assert cs.LAUNCHES[k] > 0, k
    assert cs.LAUNCHES["ff_residual3d"] == 1
    assert cs.LAUNCHES["ff_update_residual3d"] == got.iterations
    exact = 0 if "pad_align" in extra else 2 * got.iterations
    assert cs.LAUNCHES["restrict_fw3d"] == exact
    assert cs.LAUNCHES["prolong_add3d"] == exact
    assert all(cs.LAUNCHES[k] == 0 for k in ("rbgs_fused", "rbgs_color",
                                              "residual", "ff_residual",
                                              "ff_update_residual",
                                              "apply", "jacobi",
                                              "restrict_fw", "prolong_add",
                                              "rbgs3d_color"))
    want = GMGSolver(device="cpu", use_pallas=True, **kw).solve_refined(
        b.cpu(), inner_cg=inner_cg)
    assert got.converged and got.iterations == want.iterations
    assert tuple(got.u.shape) == (33, 33, 33)
    np.testing.assert_allclose(got.history, want.history, rtol=1e-2,
                               atol=1e-12)


@pytest.mark.cuda
def test_cuda_spans_cover_a_solve_and_count_its_syncs(cuda_device):
    """One profiled 65^3 ff32 ``solve_refined`` (config 4's V(2,2) cut to 3
    levels): ``COUNTERS["host_syncs"]`` equals the synchronising runtime
    calls inside ``mg.solve_refined`` (each fetch is one DtoH copy and one
    ``cudaStreamSynchronize``); the device time launched beneath the root
    span, attributed by correlation id (``portbench/spans.py``), covers at
    least 99 % of the busy time inside it, and its idle time splits into
    the outer loop's and the cycle's; no ``mg.*`` range counts as device
    work in the benchmark's busy sum (the spans are host ops, and a range
    drawn on the device's timeline would be a user annotation, which the
    sum leaves out)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from multigrid_prj_tpu_torch.gmg import GMGSolver
    from multigrid_prj_tpu_torch.utils import metrics
    from portbench import spans
    from portbench import trace as tracing

    solver = GMGSolver(device="cuda", shape=(65, 65, 65), length=1.0,
                       alpha=1.0, num_levels=3, cycle="v", nu=2, tol=1e-8,
                       maxit=40)
    b = _rhs_3d(solver.levels[0], "cuda")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):  # starts the profiler up
        solver.solve_refined(b)
        torch.cuda.synchronize()
    before = metrics.COUNTERS["host_syncs"]
    with profile(activities=acts) as prof:
        got = solver.solve_refined(b)
        torch.cuda.synchronize()
    syncs = metrics.COUNTERS["host_syncs"] - before
    events = prof.events()
    root, = [e for e in events if e.name == "mg.solve_refined"
             and e.device_type == DeviceType.CPU]

    def inside(e):
        return root.time_range.start <= e.time_range.start <= \
            root.time_range.end

    assert all(e.is_user_annotation for e in events
               if e.device_type == DeviceType.CUDA and e.name.startswith("mg."))
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation]
    kind = {e.id: e.name for e in device}
    calls = [e for e in events if e.device_type == DeviceType.CPU
             and e.thread == root.thread and inside(e)]
    stream_syncs = [e for e in calls if e.name.endswith("Synchronize")]
    dtoh = [e for e in calls if e.name.startswith("cudaMemcpy")
            and "DtoH" in kind.get(e.id, "")]
    assert syncs == got.iterations + 1 == len(stream_syncs) == len(dtoh)

    split = spans.reduce(events, syncs)
    assert split.solves == 1
    assert all(p.startswith("mg.solve_refined/") for p in split.busy)
    busy_inside = sum(e.time_range.elapsed_us() for e in device
                      if inside(e)) / 1e6
    assert sum(split.busy.values()) >= 0.99 * busy_inside > 0
    idle = sum(split.idle.values())
    assert (split.idle_ms_per_solve(lambda p: spans.layer(p) == "outer")
            + split.idle_ms_per_solve(lambda p: spans.layer(p) == "cycle")
            == pytest.approx(idle * 1e3))
    tr = tracing.summarize(events, 1.0, tracing.port_kernel_names(), 1,
                           [got.iterations])
    assert not any(name.startswith("mg.") for name in tr.by_name)
    assert tr.busy_s == pytest.approx(
        sum(e.time_range.elapsed_us() for e in device) / 1e6)


@pytest.mark.cuda
def test_cuda_inner_cg_spans_and_counters(cuda_device):
    """A profiled 1025^2 ff32 ``solve_refined(b, inner_cg=4)`` (the main
    path's V(2,2), 6 levels, pad 256, to 1e-8): 4 outer iterations;
    ``COUNTERS["host_syncs"]`` advances by ``5 k + 1`` (4 CG stop tests and
    one history fetch a correction, and the first fetch), one for each
    ``mg.fetch`` span and each DtoH copy inside the root span; each
    correction's 5 operator applies launch ``apply_kernel`` inside
    ``mg.cg.apply``; the answer and the history are the same without a
    profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from multigrid_prj_tpu_torch.gmg import GMGSolver
    from multigrid_prj_tpu_torch.models.poisson import assemble_rhs
    from multigrid_prj_tpu_torch.utils import metrics
    from portbench import kernel_split

    solver = GMGSolver(device="cuda", shape=(1025, 1025), length=10.0,
                       alpha=ALPHA, num_levels=6, cycle="v", nu=2,
                       pre_sweeps=2, tol=1e-8, maxit=60, pad_align=256)
    b = assemble_rhs(solver.levels[0], 10.0, test=1, device="cuda")
    plain = solver.solve_refined(b, inner_cg=4)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):  # starts the profiler up
        solver.solve_refined(b, inner_cg=4)
        torch.cuda.synchronize()
    before = dict(metrics.COUNTERS)
    with profile(activities=acts) as prof:
        got = solver.solve_refined(b, inner_cg=4)
        torch.cuda.synchronize()
    counted = {k: metrics.COUNTERS[k] - before[k] for k in before}
    k = got.iterations
    assert k == 4 and got.converged
    assert counted["host_syncs"] == 5 * k + 1
    events = prof.events()
    host = [e for e in events if e.device_type == DeviceType.CPU]
    root, = [e for e in host if e.name == "mg.solve_refined"]
    assert sum(e.name == "mg.fetch" for e in host) == 5 * k + 1
    kind = {e.id: e.name for e in events if e.device_type == DeviceType.CUDA
            and not e.is_user_annotation}
    dtoh = [e for e in host if e.thread == root.thread
            and root.time_range.start <= e.time_range.start
            <= root.time_range.end and e.name.startswith("cudaMemcpy")
            and "DtoH" in kind.get(e.id, "")]
    assert len(dtoh) == 5 * k + 1
    for name, per in (("mg.cg.apply", 5), ("mg.cg.precond", 5),
                      ("mg.cg.mask", 2)):
        assert sum(e.name == name for e in host) == per * k, name
    split = kernel_split.reduce(events, [k])
    applies = {path: launches for (path, kernel), (_, launches)
               in split.kernels.items() if kernel == "apply_kernel"}
    assert applies == {"mg.solve_refined/mg.outer.cycle/mg.cg.apply": 5 * k}
    assert torch.equal(plain.u, got.u)
    assert np.array_equal(plain.history, got.history)


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [2, 3])
def test_cuda_bf16_defect_correction_launches_no_cycle_kernel(cuda_device,
                                                              dims):
    """``.solve`` with ``smoother_dtype=bfloat16`` on the card: the f32
    outer residual runs through the kernel, the bf16 cycle through the plain
    ops (the JAX kernel wrappers' dtype rule), so only the residual kernel
    launches; SOR launches no smoother kernel either."""
    from multigrid_prj_tpu_torch.gmg import GMGSolver
    from multigrid_prj_tpu_torch.models.poisson import assemble_rhs

    if dims == 2:
        kw = dict(shape=(129, 129), num_levels=4, pad_align=128, tol=1e-3)
        res, smooth = "residual", "rbgs_fused"
    else:
        kw = dict(shape=(33, 33, 33), length=1.0, alpha=1.0, num_levels=3,
                  pad_align=(8, 8, 128), tol=2e-3)
        res, smooth = "residual3d", "rbgs3d_fused"
    kw.update(cycle="v", nu=2, maxit=40)
    gpu = GMGSolver(device="cuda", smoother_dtype=torch.bfloat16, **kw)
    b = (assemble_rhs(gpu.levels[0], 10.0, test=1, device="cuda")
         if dims == 2 else _rhs_3d(gpu.levels[0], "cuda"))
    cs.reset_launch_counts()
    out = gpu.solve(b)
    torch.cuda.synchronize()
    assert out.converged and out.u.dtype == torch.float32
    assert cs.LAUNCHES[res] == out.iterations
    assert sum(cs.LAUNCHES.values()) == out.iterations
    cs.reset_launch_counts()
    sor = GMGSolver(device="cuda", omega=1.2, **kw).solve(b)
    torch.cuda.synchronize()
    assert sor.converged and cs.LAUNCHES[smooth] == 0
    assert cs.LAUNCHES["rbgs_color"] == cs.LAUNCHES["rbgs3d_color"] == 0


def _ell_matrices():
    """name -> host CSR (port) of the ELL kernels' test matrices: the RCM'd
    FD 128^2 level of the AMG path, a randomly permuted (non-banded) FD,
    the smoothed P and its transpose, a Galerkin coarse operator (K in the
    tens) and a scattered matrix with empty and long rows."""
    from multigrid_prj_tpu_torch.amg import AMGSolver
    from multigrid_prj_tpu_torch.models.poisson import poisson_fd_csr
    from multigrid_prj_tpu_torch.ops.sparse import HostCSR

    fd = poisson_fd_csr(128)
    s = AMGSolver(fd, num_levels=3, dtype=torch.float32, smoother="chebyshev",
                  reorder="rcm", use_pallas=False)
    rng = np.random.default_rng(11)
    n = 5000
    lengths = rng.integers(0, 40, n)
    lengths[::97] = 0
    rows = np.repeat(np.arange(n), lengths)
    scattered = HostCSR.from_coo(rows, rng.integers(0, n, rows.size),
                                 rng.standard_normal(rows.size), (n, n))
    return {"fd_rcm": s.host_matrices[0],
            "fd_random": fd.permute(rng.permutation(fd.shape[0])),
            "P": s.host_P[0], "Pt": s.host_P[0].transpose(),
            "coarse": s.host_matrices[2], "scattered": scattered}


@pytest.mark.cuda
def test_cuda_ell_kernels_equal_twins(cuda_device):
    """The ELL SpMV on every test matrix and the float-float residual on
    the square ones, bit-equal to their twins on the same CUDA inputs."""
    from multigrid_prj_tpu_torch.ops import cuda_spmv as cv
    from multigrid_prj_tpu_torch.ops.sparse_extended import ff_pair_from_f64

    rng = np.random.default_rng(2)
    for name, M in _ell_matrices().items():
        E = cv.CudaELL.build(M, pair=True, device=cuda_device)
        assert E.colsT.device.type == cuda_device.type
        assert E.k == int(M.row_lengths.max())
        x = torch.from_numpy(rng.standard_normal(M.shape[1])
                             .astype(np.float32)).to(cuda_device)
        got = E.spmv(x)
        assert torch.equal(got, cv.ell_spmv_plain(E.colsT, E.valsT, x)), name
        if M.shape[0] != M.shape[1]:
            continue
        x64 = rng.standard_normal(M.shape[0])
        b64 = M.spmv(x64) + 1e-6 * rng.standard_normal(M.shape[0])
        bh, bl = ff_pair_from_f64(b64, device=cuda_device)
        xh, xl = ff_pair_from_f64(x64, device=cuda_device)
        got = E.residual_ff(bh, bl, xh, xl)
        want = cv.ell_ff_residual_plain(E.colsT, E.valsT, E.valsT_lo, bh, bl,
                                        xh, xl)
        assert torch.equal(got, want), name
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_ell_fused_kernels_equal_twins(cuda_device):
    """The SpMV with the add or subtraction after it (``z + A x``, ``z - A
    x``) on every test matrix, and the Chebyshev steps (first, from x and
    from zero; a later one) on the square ones, bit-equal to their twins,
    which are the torch ops they replace; each counted once a launch; an x
    of zero refused past the first step."""
    from multigrid_prj_tpu_torch.ops import cuda_spmv as cv

    rng = np.random.default_rng(5)

    def vec(n, lo=None):
        v = rng.standard_normal(n).astype(np.float32)
        if lo is not None:
            v = np.abs(v) + np.float32(lo)
        return torch.from_numpy(v).to(cuda_device)

    cs.reset_launch_counts()
    steps = 0
    for name, M in _ell_matrices().items():
        E = cv.CudaELL.build(M, device=cuda_device)
        n, m = M.shape
        x, z = vec(m), vec(n)
        for subtract in (True, False):
            got = cv.ell_spmv_axpy(E.colsT, E.valsT, x, z, subtract)
            want = cv.ell_spmv_axpy_plain(E.colsT, E.valsT, x, z, subtract)
            assert torch.equal(got, want), (name, subtract)
        assert torch.equal(E.spmv_add(x, z), z + E.spmv(x)), name
        if n != m:
            continue
        assert torch.equal(E.residual(x, z), z - E.spmv(x)), name
        b, d = vec(n), vec(n, lo=0.5)
        for x0 in (x, None):
            p, xo = E.cheb_step(x0, b, d, None, 0.0, 1.7, True)
            pw, xw = cv.ell_cheb_step_plain(E.colsT, E.valsT, x0, b, d, None,
                                            0.0, 1.7, True)
            assert torch.equal(p, pw) and torch.equal(xo, xw), (name, x0)
            p2, xo2 = E.cheb_step(xo, b, d, p.clone(), 0.61, 0.37, False)
            pw2, xw2 = cv.ell_cheb_step_plain(E.colsT, E.valsT, xw, b, d, pw,
                                              0.61, 0.37, False)
            assert torch.equal(p2, pw2) and torch.equal(xo2, xw2), name
            steps += 2
        with pytest.raises(ValueError):
            E.cheb_step(None, b, d, p, 0.61, 0.37, False)
    torch.cuda.synchronize()
    assert cs.LAUNCHES["cheb_step"] == steps
    assert cs.LAUNCHES["spmv_axpy"] == 2 * 6 + 6 + 4


@pytest.mark.cuda
def test_cuda_ell_wrappers_count_and_refuse(cuda_device):
    from multigrid_prj_tpu_torch.models.poisson import poisson_fd_csr
    from multigrid_prj_tpu_torch.ops import cuda_spmv as cv

    E = cv.CudaELL.build(poisson_fd_csr(20), pair=True, device=cuda_device)
    x = torch.ones(400, device=cuda_device)
    cs.reset_launch_counts()
    E.spmv(x)
    cv.ell_local_spmv(E.colsT, E.valsT, x)
    E.residual_ff(x, x, x, x)
    torch.cuda.synchronize()
    assert {k: v for k, v in cs.LAUNCHES.items() if v} == {
        "spmv": 2, "ff_residual_ell": 1}
    with pytest.raises(NotImplementedError):
        cv.ell_local_spmv(E.colsT, E.valsT.double(), x.double())
    with pytest.raises(ValueError):
        cv.ell_local_spmv(E.colsT.long(), E.valsT, x)
    with pytest.raises(ValueError):
        cv.ell_local_spmv(E.colsT.t(), E.valsT.t(), x)
    with pytest.raises(ValueError):
        cv.ell_local_spmv(E.colsT, E.valsT, x.cpu())
    assert sum(cs.LAUNCHES.values()) == 3


@pytest.mark.cuda
def test_cuda_amg_solves_match_cpu_twins(cuda_device):
    """FD 96^2 (9216 rows: the finest level and its prolongation on the
    kernels, the next levels dense and bottom) on the card vs the same
    hierarchy through the twins on the CPU: the same iterations for
    ``solve``, ``solve_pcg`` and ``solve_refined``; histories within 1e-2
    relative (the dense matvecs, norms and dot products sum in another
    order on the two devices) plus 1e-12 absolute."""
    from multigrid_prj_tpu_torch.amg import AMGSolver
    from multigrid_prj_tpu_torch.models.poisson import poisson_fd_csr

    A = poisson_fd_csr(96)
    gpu = AMGSolver(A, num_levels=6, min_coarse=500, device=cuda_device)
    assert (gpu.dtype, gpu.smoother_name, gpu._use_pallas) == (
        torch.float32, "chebyshev", True)
    assert gpu.levels[0].A_fast is not None
    cpu = AMGSolver.from_hierarchy(
        gpu.host_matrices, gpu.host_P, perm=gpu._perm,
        lmax=[lv.lmax for lv in gpu.levels], smoother="chebyshev",
        dtype=torch.float32, use_pallas=True, device="cpu")
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    for method, tol in (("solve", 1e-5), ("solve_pcg", 1e-5),
                        ("solve_refined", 1e-8)):
        cs.reset_launch_counts()
        got = getattr(gpu, method)(b, tol=tol)
        torch.cuda.synchronize()
        # the finest level's Chebyshev steps and residual, the prolong-add
        # onto it; the plain SpMV only in PCG's operator (the restriction
        # goes to a coarse level under pallas_min_rows: the gather ELL)
        assert cs.LAUNCHES["cheb_step"] > 0 and cs.LAUNCHES["spmv_axpy"] > 0
        assert (cs.LAUNCHES["spmv"] > 0) == (method == "solve_pcg"), method
        assert (cs.LAUNCHES["ff_residual_ell"] > 0) == (
            method == "solve_refined")
        want = getattr(cpu, method)(b, tol=tol)
        assert got.iterations == want.iterations, method
        assert got.rel_residual <= tol
        np.testing.assert_allclose(got.history, want.history, rtol=1e-2,
                                   atol=1e-12)


@pytest.mark.cuda
def test_cuda_amg_p1_solve_spans_and_syncs(cuda_device):
    """``AMGSolver.solve_p1`` on a 257^2 P1 system (3 levels, the kernels at
    the two above the bottom), profiled: ``COUNTERS["host_syncs"]`` is the
    loop's ``iterations + 1`` stop tests, each a DtoH copy, and one more
    copy brings the history; the device time launched beneath the root
    span covers at least 99 % of the busy time inside it; the nodal answer
    stays on the card, equals ``g`` on the boundary, and agrees with the
    same hierarchy through the twins on the CPU."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from multigrid_prj_tpu_torch.amg import AMGSolver
    from multigrid_prj_tpu_torch.models import fem
    from multigrid_prj_tpu_torch.utils import metrics
    from portbench import spans

    system = fem.P1System(fem.structured_unit_square_mesh(257))
    gpu = AMGSolver(system.A, num_levels=3, device=cuda_device)
    assert gpu._use_pallas and gpu.levels[1].A_fast is not None
    cpu = AMGSolver.from_hierarchy(
        gpu.host_matrices, gpu.host_P, perm=gpu._perm,
        lmax=[lv.lmax for lv in gpu.levels], smoother="chebyshev",
        dtype=torch.float32, use_pallas=True, device="cpu")
    gen = torch.Generator().manual_seed(11)
    nodal = torch.randn(system.n_nodes, generator=gen, dtype=torch.float64)
    nodal_gpu = nodal.to(cuda_device)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):  # starts the profiler up
        gpu.solve_p1(system, nodal_gpu, nodal_gpu)
        torch.cuda.synchronize()
    before = metrics.COUNTERS["host_syncs"]
    with profile(activities=acts) as prof:
        got = gpu.solve_p1(system, nodal_gpu, nodal_gpu)
        torch.cuda.synchronize()
    syncs = metrics.COUNTERS["host_syncs"] - before
    events = prof.events()
    root, = [e for e in events if e.name == "mg.solve_refined"
             and e.device_type == DeviceType.CPU]

    def inside(e):
        return root.time_range.start <= e.time_range.start <= \
            root.time_range.end

    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation]
    kind = {e.id: e.name for e in device}
    dtoh = [e for e in events if e.device_type == DeviceType.CPU
            and e.thread == root.thread and inside(e)
            and e.name.startswith("cudaMemcpy")
            and "DtoH" in kind.get(e.id, "")]
    assert syncs == got.iterations + 1 == len(dtoh) - 1
    split = spans.reduce(events, syncs)
    assert split.solves == 1
    busy_inside = sum(e.time_range.elapsed_us() for e in device
                      if inside(e)) / 1e6
    assert sum(split.busy.values()) >= 0.99 * busy_inside > 0
    assert got.x.device.type == "cuda" and got.x.dtype == torch.float64
    assert torch.equal(got.x.cpu()[system.boundary], nodal[system.boundary])
    want = cpu.solve_p1(system, nodal, nodal)
    assert got.rel_residual <= 1e-10 and want.rel_residual <= 1e-10
    err = torch.linalg.vector_norm(got.x.cpu() - want.x) \
        / torch.linalg.vector_norm(want.x)
    assert float(err) < 1e-8


# the padded levels of the 1025^2 / pad 256 path, the finest level of the
# 8193^2 one, a ragged logical shape in a non-square buffer, and an
# unpadded (even) one whose m % 4 != 0 takes the scalar stores
DOWNLEG_SHAPES = [((1280, 1280), (1025, 1025)), ((640, 640), (513, 513)),
                  ((320, 320), (257, 257)), ((160, 160), (129, 129)),
                  ((80, 80), (65, 65)), ((40, 40), (33, 33)),
                  ((256, 384), (201, 329)), ((8448, 8448), (8193, 8193)),
                  ((386, 258), (386, 258))]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,logical", DOWNLEG_SHAPES)
def test_cuda_downleg_equals_twin_and_composition(cuda_device, shape,
                                                  logical):
    """The fused down-leg kernel, sweeps 0-3, bit-equal to its twin and to
    the three kernels it replaces (the smoother as the per-colour oracle's
    launches and as the fused smoother); sweeps 4 runs the composition and
    makes no fused launch; ``u`` is never written."""
    u, b, _, h = _cuda_inputs(shape, logical, cuda_device)
    u0 = u.clone()
    for sweeps in (0, 1, 2, 3, 4):
        cs.reset_launch_counts()
        u2, rc = cs.rbgs_residual_restrict(u, b, ALPHA, h, sweeps, logical)
        torch.cuda.synchronize()
        assert cs.LAUNCHES["rbgs_resfilter"] == (sweeps <= 3)
        assert cs.LAUNCHES["rbgs_fused"] == (sweeps > 3)
        tu, trc = cs.rbgs_residual_restrict_plain(u, b, ALPHA, h, sweeps,
                                                  logical)
        assert torch.equal(u2, tu) and torch.equal(rc, trc), sweeps
        for smooth in (cs._rbgs_per_colour, lambda *a: (
                cs.red_black_gauss_seidel(*a[:4], sweeps=a[4],
                                          logical_shape=a[5]))):
            cu = smooth(u, b, ALPHA, h, sweeps, logical)
            r = cs.poisson_residual(cu, b, ALPHA, h, logical)
            assert torch.equal(u2, cu), sweeps
            assert torch.equal(rc, cs.restrict_fw_padded_fast(r, logical))
        assert torch.equal(u, u0)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,logical", CUDA_SHAPES + [((2048, 2048),
                                                          None)])
def test_cuda_apply_chain_and_color_sweep_equal_twins(cuda_device, shape,
                                                      logical):
    """The apply chain (1, 3, 8 and 11 applies: one launch per group of 8;
    alpha = h^2 keeps 11 applies finite) and both colours of the colour
    sweep, bit-equal to their twins; the chain also to single applies."""
    u, b, _, h = _cuda_inputs(shape, logical, cuda_device)
    for applies in (1, 3, 8, 11):
        cs.reset_launch_counts()
        got = cs.poisson_apply_chain(u, h * h, h, applies, logical)
        assert cs.LAUNCHES["apply_chain"] == -(-applies // 8)
        assert torch.equal(got, cs.poisson_apply_chain_plain(
            u, h * h, h, applies, logical))
        x = u
        for _ in range(applies):
            x = cs.poisson_apply(x, h * h, h, logical)
        assert torch.equal(got, x) and bool(torch.isfinite(got).all())
    for color in (0, 1):
        got = cs.rbgs_color_sweep(u, b, ALPHA, h, color, logical)
        assert torch.equal(got, cs.rbgs_color_sweep_plain(u, b, ALPHA, h,
                                                          color, logical))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        cs.rbgs_color_sweep(u.double(), b.double(), ALPHA, h, 0)
    torch.cuda.synchronize()


# the apply chain's shapes: the 1025^2 path's finest level, an exact odd
# layout (m % 4 != 0: 4-byte copies and scalar stores), a ragged logical
# shape in a non-square buffer, bench.py's 8192^2 and one smaller than a tile
CHAIN_SHAPES = [((1280, 1280), (1025, 1025)), ((385, 385), None),
                ((256, 384), (201, 329)), ((8192, 8192), None),
                ((40, 40), (33, 33))]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,logical", CHAIN_SHAPES)
def test_cuda_apply_chain_equals_twin_and_singles(cuda_device, shape,
                                                  logical):
    """The row-walking apply chain at 0-11 applies (11: launches of 8 + 3)
    bit-equal to its twin and to ``applies`` single apply launches; one
    launch per group; ``u`` is never written."""
    u, _, _, h = _cuda_inputs(shape, logical, cuda_device)
    u0 = u.clone()
    for applies in range(12):
        cs.reset_launch_counts()
        got = cs.poisson_apply_chain(u, h * h, h, applies, logical)
        torch.cuda.synchronize()
        assert cs.LAUNCHES["apply_chain"] == -(-applies // 8), applies
        assert sum(cs.LAUNCHES.values()) == -(-applies // 8), applies
        assert got.data_ptr() != u.data_ptr()
        assert torch.equal(got, cs.poisson_apply_chain_plain(
            u, h * h, h, applies, logical)), applies
        x = u
        for _ in range(applies):
            x = cs.poisson_apply(x, h * h, h, logical)
        assert torch.equal(got, x), applies
        assert torch.equal(u, u0) and bool(torch.isfinite(got).all())
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_apply_chain_refusals(cuda_device):
    """The C entry point refuses, before any launch, a tile geometry other
    than the compiled one and an apply count outside 1 .. 8."""
    import ctypes

    from multigrid_prj_tpu_torch.kernels._build import library

    lib, stream, p = library(), cs._stream(), cs._ptr
    u, _, _, h = _cuda_inputs((160, 160), (129, 129), cuda_device)
    y = torch.empty_like(u)
    args = (160, 160, 129, 129, 1.0)

    def geom(*g):
        return (ctypes.c_int * 4)(*g)

    assert lib.mg_apply_chain(p(u), p(y), *args, 8,
                              cs._geometry(8, cs.apply_tile), stream) == 0
    for applies, g in ((8, geom(8, 8, 96, 128)), (8, geom(8, 8, 64, 64)),
                       (8, geom(7, 8, 64, 128)),
                       (3, cs._geometry(8, cs.apply_tile)),
                       (0, cs._geometry(1, cs.apply_tile)),
                       (9, geom(9, 12, 64, 128))):
        assert lib.mg_apply_chain(p(u), p(y), *args, applies, g,
                                  stream) != 0, (applies, list(g))
    with pytest.raises(ValueError, match="1 .. 8 applies"):
        cs.apply_tile(9)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,logical", CUDA_SHAPES + [SCALE_SHAPE])
def test_cuda_jacobi_fused_equals_twin_and_per_sweep(cuda_device, shape,
                                                     logical):
    """The fused Jacobi tile at 0-11 sweeps (9-11: launches of 8 + 1 .. 3),
    omega 0.8 and 1, equals its twin and the per-sweep kernel bit for bit,
    one launch per group of <= 8 sweeps."""
    u, b, _, h = _cuda_inputs(shape, logical, cuda_device)
    for sweeps in range(12):
        for omega in (0.8, 1.0):
            cs.reset_launch_counts()
            got = cs.jacobi(u, b, ALPHA, h, omega=omega, sweeps=sweeps,
                            logical_shape=logical)
            assert cs.LAUNCHES["jacobi"] == -(-sweeps // 8)
            assert torch.equal(got, cs.jacobi_plain(u, b, ALPHA, h, omega,
                                                    sweeps, logical))
            assert torch.equal(got, cs._jacobi_per_sweep(
                u, b, ALPHA, h, omega, sweeps, logical))
    torch.cuda.synchronize()


# coarse shapes of the prolong-add: every level below the finest of the
# 1025^2 and 8193^2 / pad 256 hierarchies, and pc_c % 4 != 0 with pc_r odd
PROLONG_SHAPES = [(640, 640), (320, 320), (160, 160), (80, 80), (40, 40),
                  (20, 20), (4224, 4224), (2112, 2112), (1056, 1056),
                  (528, 528), (264, 264), (132, 132), (66, 66), (33, 33),
                  (65, 190)]


@pytest.mark.cuda
@pytest.mark.parametrize("pc", PROLONG_SHAPES)
def test_cuda_prolong_add_equals_twin_and_point(cuda_device, pc):
    rng = np.random.default_rng(2)
    e, u = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(cuda_device) for s in (pc, (2 * pc[0], 2 * pc[1])))
    cs.reset_launch_counts()
    got = cs.prolong_add_padded_fast(e, u)
    assert cs.LAUNCHES["prolong_add"] == 1
    assert torch.equal(got, cs.prolong_add_padded_fast_plain(e, u))
    assert torch.equal(got, cs._prolong_add_point(e, u))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_jacobi_and_prolong_refusals(cuda_device):
    """The C entry points refuse, before any launch, a tile geometry other
    than the compiled one and a sweep count outside 1 .. 8."""
    import ctypes

    from multigrid_prj_tpu_torch.kernels._build import library

    lib, stream, p = library(), cs._stream(), cs._ptr
    u, b, _, h = _cuda_inputs((160, 160), (129, 129), cuda_device)
    y = torch.empty_like(u)
    args = (160, 160, 129, 129, 1.0)

    def geom(*g):
        return (ctypes.c_int * len(g))(*g)

    def jac(sweeps, g):
        return lib.mg_jacobi_fused(p(u), p(b), p(y), *args, sweeps, 1, 0.2,
                                   0.8, g, stream)

    assert jac(3, cs._geometry(3, cs.jacobi_tile)) == 0
    for sweeps, g in ((3, geom(3, 4, 96, 128)), (3, geom(2, 4, 64, 128)),
                      (3, geom(3, 8, 64, 128)), (3, geom(3, 4, 64, 64)),
                      (2, cs._geometry(3, cs.jacobi_tile)),
                      (0, cs._geometry(1, cs.jacobi_tile)),
                      (9, geom(9, 12, 64, 128))):
        assert jac(sweeps, g) != 0, (sweeps, list(g))
    e = u[:80, :80].contiguous()
    strip, quads = cs.prolong_tile()
    assert lib.mg_prolong_add(p(e), p(u), p(y), 80, 80,
                              geom(strip, quads), stream) == 0
    for g in ((strip + 1, quads), (strip, 2 * quads), (strip, quads - 1)):
        assert lib.mg_prolong_add(p(e), p(u), p(y), 80, 80, geom(*g),
                                  stream) != 0, g
    with pytest.raises(ValueError, match="1 .. 8 sweeps"):
        cs.jacobi_tile(9)
    with pytest.raises(ValueError, match="CUDA kernels only"):
        cs._prolong_add_point(e.cpu(), u.cpu())
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_jacobi_solve_fused_and_per_sweep(cuda_device):
    """The 129^2 Jacobi omega 0.8 solve launches one fused smoother per
    smoother call (2 sweeps, so half the per-sweep launches), and equals the
    same solve with the per-sweep kernel swapped in bit for bit; so does the
    GS solve with the point prolong-add swapped in."""
    from multigrid_prj_tpu_torch.gmg import GMGSolver
    from multigrid_prj_tpu_torch.models.poisson import assemble_rhs

    kw = dict(shape=(129, 129), length=10.0, alpha=10.0, num_levels=4,
              cycle="v", nu=2, pre_sweeps=2, tol=1e-8, maxit=60,
              pad_align=128)
    jac = GMGSolver(**kw, smoother="jacobi", omega=0.8, device="cuda")
    b = assemble_rhs(jac.levels[0], 10.0, test=1, device="cuda")
    cs.reset_launch_counts()
    res = jac.solve_refined(b)
    n_fused = cs.LAUNCHES["jacobi"]
    ref_s = GMGSolver(**kw, smoother="jacobi", omega=0.8, device="cuda")

    def per_sweep(u, b, alpha, h, sweeps=1, logical_shape=None):
        return cs._jacobi_per_sweep(u, b, alpha, h, 0.8, sweeps,
                                    logical_shape)

    ref_s._f32_route = ref_s._f32_route._replace(smooth=per_sweep)
    cs.reset_launch_counts()
    ref = ref_s.solve_refined(b)
    assert res.converged and n_fused > 0 and cs.LAUNCHES["jacobi"] == 0
    assert cs.LAUNCHES["jacobi_sweep"] == 2 * n_fused
    assert np.array_equal(res.history, ref.history)
    assert torch.equal(res.u, ref.u)
    gs = GMGSolver(**kw, device="cuda")
    pt = GMGSolver(**kw, device="cuda")
    pt._f32_route = pt._f32_route._replace(prolong_add=cs._prolong_add_point)
    res, ref = gs.solve_refined(b), pt.solve_refined(b)
    assert np.array_equal(res.history, ref.history)
    assert torch.equal(res.u, ref.u)


# the residual's shapes: exact and padded levels of the 3D paths, a
# non-cubic one, one whose x-y extents are no multiple of the tile, and one
# whose chunk (2) does not divide nz
RESIDUAL3D_SHAPES = [((257, 257, 257), None), ((65, 65, 65), None),
                     ((33, 33, 33), None), ((17, 17, 17), None),
                     ((72, 72, 128), (65, 65, 65)),
                     ((20, 24, 136), (17, 21, 129)), ((19, 53, 101), None),
                     ((71, 45, 77), None)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,logical", RESIDUAL3D_SHAPES)
def test_cuda_residual3d_equals_twin_and_point_apply(cuda_device, shape,
                                                     logical):
    """The z-chunked residual march bit-equal to its twin and to ``b``
    less the one-thread-per-point apply (the point oracle of the march the
    residual and the apply share), one launch each."""
    u, b, _, h = _cuda_inputs(shape, logical, cuda_device)
    cs.reset_launch_counts()
    got = c3.poisson_residual_3d(u, b, ALPHA, h, logical)
    au = c3._apply3d_launch(u, ALPHA, h, logical, "apply3d_point")
    torch.cuda.synchronize()
    assert {k: v for k, v in cs.LAUNCHES.items() if v} == {
        "residual3d": 1, "apply3d_point": 1}
    assert torch.equal(got, c3.poisson_residual_3d_plain(u, b, ALPHA, h,
                                                         logical))
    assert torch.equal(got, b - au)


@pytest.mark.cuda
def test_cuda_residual3d_refusals(cuda_device):
    """The C entry point refuses a tile, a depth of planes in flight or a
    chunk other than the compiled ones and the chunk rule's."""
    import ctypes

    from multigrid_prj_tpu_torch.kernels._build import library

    lib, stream, p = library(), cs._stream(), cs._ptr
    u, b, _, h = _cuda_inputs((65, 65, 65), None, cuda_device)
    r = torch.empty_like(u)
    dims = (65, 65, 65, 65, 65, 65, 4096.0)
    tx, ty, zc, ahead = c3.residual3d_tile(u.shape)
    assert lib.mg_residual3d(p(u), p(b), p(r), *dims, (ctypes.c_int * 4)(
        tx, ty, zc, ahead), stream) == 0
    for g in ((tx, ty, zc + 1, ahead), (tx, ty, 32, ahead),
              (16, ty, zc, ahead), (tx, 16, zc, ahead),
              (tx, ty, zc, ahead + 1)):
        assert lib.mg_residual3d(p(u), p(b), p(r), *dims, (ctypes.c_int * 4)(
            *g), stream) != 0, g
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,logical", RESIDUAL3D_SHAPES)
def test_cuda_ff_residual3d_equals_twin(cuda_device, shape, logical):
    """The 3D float-float residual's march bit-equal to its twin
    (``ops/extended.ff_poisson_residual``), one launch."""
    u, b, u_lo, h = _cuda_inputs(shape, logical, cuda_device)
    d_hi, d_lo = text.ff_from_div(b, ALPHA / (h * h))
    args = (u, u_lo, d_hi, d_lo, b, ALPHA, h, logical)
    cs.reset_launch_counts()
    got = c3.ff_poisson_residual_3d(*args)
    torch.cuda.synchronize()
    assert {k: v for k, v in cs.LAUNCHES.items() if v} == {"ff_residual3d": 1}
    assert torch.equal(got, text.ff_poisson_residual(*args))


@pytest.mark.cuda
def test_cuda_ff_residual3d_refusals(cuda_device):
    """The C entry point refuses a tile, a depth of planes in flight or a
    chunk other than the compiled ones and the chunk rule's; the wrapper a
    CPU or non-contiguous operand and float64, with no fallback."""
    import ctypes

    from multigrid_prj_tpu_torch.kernels._build import library

    lib, stream, p = library(), cs._stream(), cs._ptr
    u, b, u_lo, h = _cuda_inputs((65, 65, 65), None, cuda_device)
    d_hi, d_lo = text.ff_from_div(b, ALPHA / (h * h))
    r = torch.empty_like(u)
    ptrs = (p(u), p(u_lo), p(d_hi), p(d_lo), p(b), p(r))
    dims = (65, 65, 65, 65, 65, 65, ALPHA / (h * h))
    tx, ty, zc, ahead = c3.ff_residual3d_tile(u.shape)
    assert lib.mg_ff_residual3d(*ptrs, *dims, (ctypes.c_int * 4)(
        tx, ty, zc, ahead), stream) == 0
    for g in ((tx, ty, zc + 1, ahead), (tx, ty, 32, ahead),
              (32, ty, zc, ahead), (tx, 16, zc, ahead),
              (tx, ty, zc, ahead + 1)):
        assert lib.mg_ff_residual3d(*ptrs, *dims, (ctypes.c_int * 4)(*g),
                                    stream) != 0, g
    torch.cuda.synchronize()
    cs.reset_launch_counts()
    with pytest.raises(ValueError, match="agree"):
        c3.ff_poisson_residual_3d(u, u_lo, d_hi, d_lo, b.cpu(), ALPHA, h)
    with pytest.raises(ValueError, match="contiguous"):
        c3.ff_poisson_residual_3d(u, u_lo.transpose(0, 2), d_hi, d_lo, b,
                                  ALPHA, h)
    with pytest.raises(NotImplementedError):
        c3.ff_poisson_residual_3d(*(t.double() for t in (u, u_lo, d_hi,
                                                         d_lo, b)), ALPHA, h)
    assert cs.LAUNCHES["ff_residual3d"] == 0


# the fused update-and-residual kernels: 2D at the main path's levels, an
# exact odd layout, the 8193^2 finest level, a ragged non-square and an odd
# unpadded shape; 3D at the residual march's shapes (odd, padded,
# non-cubic, chunks that do not divide nz, the 17^3 bottom)
FUSED_FF_SHAPES = CUDA_SHAPES + [SCALE_SHAPE, ((256, 384), (201, 329)),
                                 ((255, 383), None)]


def _fused_ff_args(shape, logical, device):
    """The fused kernels' operands: a pair (low half ~1e-8 of the high), a
    correction ``e`` of ~1e-3 and the pair of ``b / c``."""
    u, b, u_lo, h = _cuda_inputs(shape, logical, device)
    gen = torch.Generator(device=device).manual_seed(3)
    e = torch.randn(shape, generator=gen, device=device) * 1e-3
    d_hi, d_lo = text.ff_from_div(b, ALPHA / (h * h))
    return (u, u_lo, e, d_hi, d_lo, b, ALPHA, h, logical)


def _check_fused_ff(fn, residual, key, args):
    """``fn`` (new buffers and given ones) bit-equal to its twin in the
    updated pair and r, and r to the pair update followed by ``residual``
    (the kernel route before the fusion); one launch per call."""
    want = text.ff_update_residual(*args)
    out = (torch.empty_like(args[0]), torch.empty_like(args[0]))
    cs.reset_launch_counts()
    got = fn(*args)
    got_out = fn(*args, out=out)
    hi, lo = text.ff_accumulate(*args[:3])
    before = residual(hi, lo, *args[3:])
    torch.cuda.synchronize()
    assert cs.LAUNCHES[key] == 2
    assert got_out[0] is out[0] and got_out[1] is out[1]
    for g, go, w in zip(got, got_out, want):
        assert torch.equal(g, w) and torch.equal(go, w)
    assert torch.equal(got[2], before)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,logical", FUSED_FF_SHAPES)
def test_cuda_ff_update_residual_equals_twin(cuda_device, shape, logical):
    """The 2D fused pair update and float-float residual bit-equal to the
    twin (``ff_accumulate``, then ``ff_poisson_residual``)."""
    _check_fused_ff(cs.ff_update_residual, cs.ff_poisson_residual,
                    "ff_update_residual",
                    _fused_ff_args(shape, logical, cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,logical", RESIDUAL3D_SHAPES)
def test_cuda_ff_update_residual3d_equals_twin(cuda_device, shape, logical):
    """The 3D fused march bit-equal to the same twin."""
    _check_fused_ff(c3.ff_update_residual_3d, c3.ff_poisson_residual_3d,
                    "ff_update_residual3d",
                    _fused_ff_args(shape, logical, cuda_device))


@pytest.mark.cuda
def test_cuda_ff_update_residual_refusals(cuda_device):
    """Both fused wrappers refuse output buffers that are, or overlap, an
    input or each other, a CPU buffer and float64, before any launch; the
    3D entry point a geometry other than the compiled one and the chunk
    rule's."""
    import ctypes

    from multigrid_prj_tpu_torch.kernels._build import library

    for shape, fn, key in (((160, 160), cs.ff_update_residual,
                            "ff_update_residual"),
                           ((33, 33, 33), c3.ff_update_residual_3d,
                            "ff_update_residual3d")):
        args = _fused_ff_args(shape, None, cuda_device)
        u = args[0]
        free = torch.empty_like(u)
        both = torch.empty((2, *shape), device=cuda_device)
        shifted = both.view(-1)[1:1 + u.numel()].view(shape)
        cs.reset_launch_counts()
        for out in ((u, free), (free, args[1]), (args[2], free),
                    (free, args[3]), (free, args[5]), (free, free),
                    (shifted, both[1])):
            with pytest.raises(ValueError, match="overlaps"):
                fn(*args, out=out)
        with pytest.raises(ValueError):
            fn(*args, out=(free, free.cpu()))
        with pytest.raises(NotImplementedError):
            fn(*(t.double() for t in args[:6]), *args[6:])
        assert cs.LAUNCHES[key] == 0
        fn(*args, out=(both[0], both[1]))  # adjacent, not overlapping
        assert cs.LAUNCHES[key] == 1
    lib, stream, p = library(), cs._stream(), cs._ptr
    r, hi2, lo2 = (torch.empty_like(u) for _ in range(3))
    ptrs = tuple(p(t) for t in args[:6]) + (p(hi2), p(lo2), p(r))
    dims = (33, 33, 33, 33, 33, 33, ALPHA / (args[7] ** 2))
    tx, ty, zc, ahead = c3.ff_residual3d_tile(u.shape)
    assert lib.mg_ff_update_residual3d(*ptrs, *dims, (ctypes.c_int * 4)(
        tx, ty, zc, ahead), stream) == 0
    for g in ((tx, ty, zc + 1, ahead), (32, ty, zc, ahead),
              (tx, 16, zc, ahead), (tx, ty, zc, ahead + 1)):
        assert lib.mg_ff_update_residual3d(*ptrs, *dims, (ctypes.c_int * 4)(
            *g), stream) != 0, g
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_3d_solve_refined_equals_plain_ff_residual_path(cuda_device):
    """A 65^3 refined solve (config 4 cut to 3 levels) on the float-float
    residual's kernels and the same solve with the route's residual and
    update set to the plain twins: the same history and solution bit for
    bit; on the one the first residual's launch and one fused launch per
    iteration, on the other none."""
    from multigrid_prj_tpu_torch.gmg import GMGSolver

    kw = dict(shape=(65, 65, 65), length=1.0, alpha=1.0, num_levels=3,
              cycle="v", nu=2, tol=1e-8, maxit=40)
    runs = {}
    for path in ("kernel", "plain"):
        s = GMGSolver(device="cuda", **kw)
        route = s._route(torch.float32)
        assert route.ff_residual is c3.ff_poisson_residual_3d
        assert route.ff_update_residual is c3.ff_update_residual_3d
        if path == "plain":
            s._f32_route = route._replace(
                ff_residual=text.ff_poisson_residual,
                ff_update_residual=text.ff_update_residual)
        b = _rhs_3d(s.levels[0], "cuda")
        cs.reset_launch_counts()
        res = s.solve_refined(b)
        torch.cuda.synchronize()
        runs[path] = (res, dict(cs.LAUNCHES))
    (kern, ck), (plain, cp) = runs["kernel"], runs["plain"]
    assert kern.converged and kern.iterations == plain.iterations
    assert ck["ff_residual3d"] == 1
    assert ck["ff_update_residual3d"] == kern.iterations
    assert cp["ff_residual3d"] == cp["ff_update_residual3d"] == 0
    np.testing.assert_array_equal(kern.history, plain.history)
    assert torch.equal(kern.u, plain.u)


# the 3D exact-layout transfers' shapes: config 4's exact levels (each
# kernel's chunk rule from one chunk to many), odd / even / mixed shapes,
# the smallest, and even axes (the fake high edge, the repeated last node)
TRANSFER3D_SHAPES = [(257, 257, 257), (129, 129, 129), (65, 65, 65),
                     (33, 33, 33), (9, 10, 11), (17, 33, 8), (3, 3, 3),
                     (264, 264, 384), (71, 45, 77)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", TRANSFER3D_SHAPES)
def test_cuda_transfer3d_equals_twins(cuda_device, shape):
    """The exact-layout restriction and prolong-add kernels against their
    plain twins, bit for bit, one launch each; the inputs are only read."""
    from multigrid_prj_tpu_torch.ops import transfer as tr

    gen = torch.Generator(device="cuda").manual_seed(sum(shape))
    r = torch.randn(shape, generator=gen, device="cuda")
    coarse = tuple((n + 1) // 2 for n in shape)
    e = torch.randn(coarse, generator=gen, device="cuda")
    r0, e0 = r.clone(), e.clone()
    cs.reset_launch_counts()
    got_r, got_p = c3.restrict_fw3d(r), c3.prolong_add3d(e, r)
    torch.cuda.synchronize()
    assert {k: v for k, v in cs.LAUNCHES.items() if v} == {
        "restrict_fw3d": 1, "prolong_add3d": 1}
    assert torch.equal(got_r, tr.restrict_full_weighting(r))
    assert torch.equal(got_p, r + tr.prolong(e, r.shape))
    assert torch.equal(got_p, c3.prolong_add3d_plain(e, r))
    assert torch.equal(r, r0) and torch.equal(e, e0)


@pytest.mark.cuda
def test_cuda_transfer3d_refusals(cuda_device):
    """The wrappers refuse what the kernels do not take, before any launch;
    the C entry points refuse a geometry other than the compiled one and
    the chunk rule's, and shapes that are no refinement."""
    import ctypes

    from multigrid_prj_tpu_torch.kernels import _build

    u = torch.randn((17, 33, 8), device="cuda")
    e = torch.randn((9, 17, 4), device="cuda")
    cs.reset_launch_counts()
    with pytest.raises(NotImplementedError, match="float32"):
        c3.restrict_fw3d(u.double())
    with pytest.raises(ValueError, match="contiguous"):
        c3.restrict_fw3d(u.transpose(1, 2))
    with pytest.raises(ValueError, match="range"):
        c3.restrict_fw3d(u[:, :2].contiguous())
    with pytest.raises(ValueError, match="refinement"):
        c3.prolong_add3d(e[:, :, :3].contiguous(), u)
    with pytest.raises(ValueError, match="one device"):
        c3.prolong_add3d(e.cpu(), u)
    assert sum(cs.LAUNCHES.values()) == 0
    lib, stream = _build.library(), cs._stream()
    rc, out = torch.empty((9, 17, 4), device="cuda"), torch.empty_like(u)
    geo = c3.restrict3d_tile(u.shape)
    ok = lib.mg_restrict_fw3d(cs._ptr(u), cs._ptr(rc), *u.shape,
                              (ctypes.c_int * 3)(*geo), stream)
    bad = [lib.mg_restrict_fw3d(cs._ptr(u), cs._ptr(rc), *u.shape,
                                (ctypes.c_int * 3)(*g), stream)
           for g in ((geo[0], geo[1], geo[2] + 1), (64, geo[1], geo[2]),
                     (geo[0], 16, geo[2]))]
    pgeo = c3.prolong3d_tile(u.shape)
    ok_p = lib.mg_prolong_add3d(cs._ptr(e), cs._ptr(u), cs._ptr(out),
                                *e.shape, *u.shape,
                                (ctypes.c_int * 4)(*pgeo), stream)
    bad += [lib.mg_prolong_add3d(cs._ptr(e), cs._ptr(u), cs._ptr(out),
                                 *e.shape, *u.shape,
                                 (ctypes.c_int * 4)(*g), stream)
            for g in ((pgeo[0], pgeo[1], pgeo[2] + 1, pgeo[3]),
                      (32, pgeo[1], pgeo[2], pgeo[3]),
                      (pgeo[0], pgeo[1], pgeo[2], pgeo[3] + 1))]
    bad.append(lib.mg_prolong_add3d(cs._ptr(e), cs._ptr(u), cs._ptr(out),
                                    9, 17, 3, *u.shape,
                                    (ctypes.c_int * 4)(*pgeo), stream))
    torch.cuda.synchronize()
    assert ok == 0 and ok_p == 0 and all(bad)


@pytest.mark.cuda
def test_cuda_3d_solve_refined_equals_plain_transfer_path(cuda_device):
    """Config 4's 257^3 refined solve on the transfer kernels and the same
    solve with the route's exact-layout transfers set to the plain
    functions: 11 iterations, the same history and solution bit for bit;
    on the one 44 launches of each kernel (4 transfer levels, 11
    iterations), on the other none."""
    from multigrid_prj_tpu_torch.gmg import GMGSolver
    from multigrid_prj_tpu_torch.ops import transfer as tr

    kw = dict(shape=(257, 257, 257), length=1.0, alpha=1.0, num_levels=5,
              cycle="v", nu=2, pre_sweeps=2, tol=1e-8, maxit=60)
    runs = {}
    for path in ("kernel", "plain"):
        s = GMGSolver(device="cuda", **kw)
        route = s._route(torch.float32)
        assert route.exact_restrict is c3.restrict_fw3d
        assert route.exact_prolong_add is c3.prolong_add3d
        if path == "plain":
            s._f32_route = route._replace(
                exact_restrict=tr.restrict_full_weighting,
                exact_prolong_add=tr.prolong_add)
        b = _rhs_3d(s.levels[0], "cuda")
        cs.reset_launch_counts()
        res = s.solve_refined(b)
        torch.cuda.synchronize()
        runs[path] = (res, dict(cs.LAUNCHES))
        del s
    (kern, ck), (plain, cp) = runs["kernel"], runs["plain"]
    assert kern.iterations == plain.iterations == 11 and kern.converged
    assert ck["restrict_fw3d"] == ck["prolong_add3d"] == 44
    assert cp["restrict_fw3d"] == cp["prolong_add3d"] == 0
    for k in ("restrict_fw3d", "prolong_add3d"):
        del ck[k], cp[k]
    assert ck == cp  # every other kernel launches alike
    np.testing.assert_array_equal(kern.history, plain.history)
    assert torch.equal(kern.u, plain.u)


@pytest.mark.cuda
def test_cuda_8193_refined_launch_counts(cuda_device):
    """The 2D cell's solve (test 1 at 8193^2, 8 padded levels) launches the
    2D kernels it launched before the 3D transfer kernels came, and none of
    those: 9 iterations; 126 smoother, 63 residual, 63 restriction and 63
    prolong-add launches, one float-float residual and 9 fused updates."""
    from multigrid_prj_tpu_torch.gmg import GMGSolver
    from multigrid_prj_tpu_torch.models.poisson import assemble_rhs

    s = GMGSolver(shape=(8193, 8193), num_levels=8, cycle="v", nu=2,
                  tol=1e-7, maxit=200, pad_align=256, device="cuda")
    b = assemble_rhs(s.levels[0], 10.0, test=1, device="cuda")
    cs.reset_launch_counts()
    res = s.solve_refined(b)
    torch.cuda.synchronize()
    assert res.converged and res.iterations == 9
    assert {k: v for k, v in cs.LAUNCHES.items() if v} == {
        "rbgs_fused": 126, "residual": 63, "restrict_fw": 63,
        "prolong_add": 63, "ff_residual": 1, "ff_update_residual": 9}


# the 3D Jacobi march's and apply march's shapes: every level of config 4
# and of 513^3, padded levels, a non-cubic shape, and shapes whose x-y
# extents are no multiple of either tile or whose nz no multiple of the chunk
JACOBI3D_SHAPES = CUDA_SHAPES_3D + [((19, 53, 101), None),
                                   ((71, 45, 77), None)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,logical", JACOBI3D_SHAPES)
def test_cuda_jacobi3d_equals_twin_and_per_sweep(cuda_device, shape,
                                                 logical):
    """The fused 3D Jacobi at sweeps 0-9 and 100, omega 1 and 0.8, on the
    route its size picks (the march: one launch per group of <= 4 sweeps;
    resident: one launch), bit-equal to its twin and to the per-sweep
    oracle; ``u`` is never written."""
    u, b, _, h = _cuda_inputs(shape, logical, cuda_device)
    u0 = u.clone()
    resident = c3.jacobi3d_route(shape) == "resident"
    for sweeps in list(range(10)) + [100]:
        for omega in (1.0, 0.8):
            cs.reset_launch_counts()
            got = c3.jacobi_3d(u, b, ALPHA, h, omega=omega, sweeps=sweeps,
                               logical_shape=logical)
            torch.cuda.synchronize()
            n = min(sweeps, 1) if resident else -(-sweeps // 4)
            assert cs.LAUNCHES["jacobi3d"] == n, (sweeps, omega)
            assert sum(cs.LAUNCHES.values()) == n, (sweeps, omega)
            want = c3.jacobi_3d_plain(u, b, ALPHA, h, omega, sweeps,
                                      logical)
            assert torch.equal(got, want), (sweeps, omega)
            oracle = c3._jacobi3d_per_sweep(u, b, ALPHA, h, omega, sweeps,
                                            logical)
            assert cs.LAUNCHES["jacobi3d_sweep"] == sweeps
            assert torch.equal(got, oracle), (sweeps, omega)
            assert torch.equal(u, u0), (sweeps, omega)
            del got, want, oracle
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,logical", JACOBI3D_SHAPES)
def test_cuda_apply3d_equals_twin_and_point_kernel(cuda_device, shape,
                                                   logical):
    """The apply on the residual's march bit-equal to its twin and to the
    one-thread-per-point kernel it replaced, one launch each."""
    u, _, _, h = _cuda_inputs(shape, logical, cuda_device)
    cs.reset_launch_counts()
    got = c3.poisson_apply_3d(u, ALPHA, h, logical)
    old = c3._apply3d_launch(u, ALPHA, h, logical, "apply3d_point")
    torch.cuda.synchronize()
    assert {k: v for k, v in cs.LAUNCHES.items() if v} == {
        "apply3d": 1, "apply3d_point": 1}
    assert torch.equal(got, c3.poisson_apply_3d_plain(u, ALPHA, h, logical))
    assert torch.equal(got, old)


@pytest.mark.cuda
def test_cuda_jacobi3d_and_apply3d_refusals(cuda_device):
    """The C entry points refuse, before any launch: a march geometry other
    than the compiled tile, the sweeps' halo and the chunk rule's; a march
    of more than 4 sweeps or none; a resident array above the cap, a cap
    other than the compiled one, no sweeps; an apply geometry other than
    the residual's."""
    import ctypes

    from multigrid_prj_tpu_torch.kernels._build import library

    lib, stream, p = library(), cs._stream(), cs._ptr
    u, b, _, h = _cuda_inputs((65, 65, 65), None, cuda_device)
    y = torch.empty_like(u)
    args = (65, 65, 65, 65, 65, 65, 4096.0, 1.0 / 6.0, 1, 0.2, 0.8)

    def geom(*g):
        return (ctypes.c_int * len(g))(*g)

    tx, ty, halo, zc, ahead = c3.jacobi3d_tile(u.shape, 2)
    assert lib.mg_jacobi3d(p(u), p(b), p(y), *args, 2,
                           geom(tx, ty, halo, zc, ahead), stream) == 0
    for sweeps, g in ((2, (tx, ty, halo, zc + 1, ahead)),
                      (2, (tx, ty, 3, zc, ahead)),
                      (2, (32, ty, halo, zc, ahead)),
                      (2, (tx, 16, halo, zc, ahead)),
                      (2, (tx, ty, halo, zc, ahead + 1)),
                      (3, (tx, ty, halo, zc, ahead)),
                      (0, (tx, ty, 0, zc, ahead)),
                      (5, (tx, ty, 5, zc, ahead))):
        assert lib.mg_jacobi3d(p(u), p(b), p(y), *args, sweeps, geom(*g),
                               stream) != 0, (sweeps, g)
    with pytest.raises(ValueError, match="1 .. 4 sweeps"):
        c3.jacobi3d_tile(u.shape, 5)
    cap = c3.RESIDENT_MAX_POINTS
    small = torch.zeros((17, 17, 17), device=cuda_device)
    out = torch.empty_like(small)
    sargs = (17, 17, 17, 17, 17, 17, 256.0, 1.0 / 6.0, 1, 0.2, 0.8)
    assert lib.mg_jacobi3d_resident(p(small), p(small), p(out), *sargs, 100,
                                    cap, stream) == 0
    assert lib.mg_jacobi3d_resident(p(small), p(small), p(out), *sargs, 1,
                                    cap + 1, stream) != 0
    assert lib.mg_jacobi3d_resident(p(small), p(small), p(out), *sargs, 0,
                                    cap, stream) != 0
    assert lib.mg_jacobi3d_resident(p(u), p(b), p(y), *args, 1, cap,
                                    stream) != 0  # 274625 points
    g = c3.residual3d_tile(u.shape)
    adims = (65, 65, 65, 65, 65, 65, 4096.0)
    assert lib.mg_apply3d(p(u), p(y), *adims, geom(*g), stream) == 0
    for bad in ((g[0], g[1], g[2] + 1, g[3]), (16, g[1], g[2], g[3]),
                (g[0], 16, g[2], g[3]), (g[0], g[1], g[2], g[3] + 1)):
        assert lib.mg_apply3d(p(u), p(y), *adims, geom(*bad), stream) != 0
    with pytest.raises(ValueError, match="CUDA kernels only"):
        c3._jacobi3d_per_sweep(u.cpu(), b.cpu(), ALPHA, h)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_3d_solves_equal_with_jacobi_and_apply_oracles(cuda_device):
    """33^3 with 2 levels (the 17^3 bottom above the dense inverse's cap, so
    the smoother's 100 sweeps on the resident route): the Jacobi omega 0.8
    solve launches 3 ``jacobi3d`` per iteration and equals the same solve
    with the per-sweep kernel swapped in (2 + 2 + 100 launches per
    iteration) bit for bit; the inner_cg=2 solve equals the one with the
    point apply swapped in."""
    from multigrid_prj_tpu_torch.gmg import GMGSolver

    kw = dict(shape=(33, 33, 33), length=1.0, alpha=1.0, num_levels=2,
              cycle="v", nu=2, tol=1e-8, maxit=40)
    jkw = dict(kw, smoother="jacobi", omega=0.8)
    runs = {}
    for path in ("march", "per-sweep"):
        s = GMGSolver(device="cuda", **jkw)
        assert s._coarse_inv is None
        if path == "per-sweep":
            s._f32_route = s._f32_route._replace(
                smooth=lambda u, b, alpha, h, sweeps=1, logical_shape=None:
                c3._jacobi3d_per_sweep(u, b, alpha, h, 0.8, sweeps,
                                       logical_shape))
        b = _rhs_3d(s.levels[0], "cuda")
        cs.reset_launch_counts()
        res = s.solve_refined(b)
        torch.cuda.synchronize()
        runs[path] = (res, dict(cs.LAUNCHES))
    (fused, cf), (sweep, cw) = runs["march"], runs["per-sweep"]
    assert fused.converged and fused.iterations == sweep.iterations
    assert cf["jacobi3d"] == 3 * fused.iterations and cf["jacobi3d_sweep"] == 0
    assert cw["jacobi3d_sweep"] == 104 * sweep.iterations
    assert cw["jacobi3d"] == 0
    np.testing.assert_array_equal(fused.history, sweep.history)
    assert torch.equal(fused.u, sweep.u)
    runs = {}
    for path in ("march", "point"):
        s = GMGSolver(device="cuda", **kw)
        if path == "point":
            s._f32_route = s._f32_route._replace(
                apply=lambda u, alpha, h, logical_shape=None:
                c3._apply3d_launch(u, alpha, h, logical_shape,
                                   "apply3d_point"))
        b = _rhs_3d(s.levels[0], "cuda")
        cs.reset_launch_counts()
        res = s.solve_refined(b, inner_cg=2)
        torch.cuda.synchronize()
        runs[path] = (res, dict(cs.LAUNCHES))
    (march, cm), (point, cp) = runs["march"], runs["point"]
    assert march.converged and march.iterations == point.iterations
    assert cm["apply3d"] > 0 and cm["apply3d_point"] == 0
    assert cp["apply3d_point"] == cm["apply3d"] and cp["apply3d"] == 0
    np.testing.assert_array_equal(march.history, point.history)
    assert torch.equal(march.u, point.u)


@pytest.mark.cuda
def test_cuda_ell_spmm_equals_twin_and_spmv(cuda_device):
    """SpMM with 1, 4 and 9 vectors (9: two launches) on every ELL test
    matrix, bit-equal to its twin and column by column to the SpMV
    kernel."""
    from multigrid_prj_tpu_torch.ops import cuda_spmv as cv

    rng = np.random.default_rng(3)
    for name, M in _ell_matrices().items():
        E = cv.CudaELL.build(M, device=cuda_device)
        for nvec in (1, 4, 9):
            X = torch.from_numpy(rng.standard_normal((M.shape[1], nvec))
                                 .astype(np.float32)).to(cuda_device)
            cs.reset_launch_counts()
            got = E.spmm(X)
            assert cs.LAUNCHES["ell_spmm"] == -(-nvec // 8)
            assert torch.equal(got, cv.ell_spmm_plain(E.colsT, E.valsT, X))
            for j in range(nvec):
                assert torch.equal(got[:, j], E.spmv(X[:, j].contiguous()))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_fuse_downleg_solve_equals_unfused(cuda_device):
    """129^2 ff32 V(2,2) with ``fuse_downleg`` on the card: the history
    equals the unfused solve's exactly; each fused launch replaces one
    residual and one restriction launch; the CPU-twin run takes the same
    iterations (histories within 1e-3, as the unfused case)."""
    from multigrid_prj_tpu_torch.gmg import GMGSolver
    from multigrid_prj_tpu_torch.models.poisson import assemble_rhs

    kw = dict(shape=(129, 129), num_levels=4, cycle="v", nu=2, tol=1e-8,
              maxit=60, pad_align=128)
    runs = {}
    for fused in (False, True):
        gpu = GMGSolver(device="cuda", fuse_downleg=fused, **kw)
        b = assemble_rhs(gpu.levels[0], 10.0, test=1, device="cuda")
        cs.reset_launch_counts()
        runs[fused] = (gpu.solve_refined(b), dict(cs.LAUNCHES))
    (plain, pc), (fused, fc) = runs[False], runs[True]
    assert fused.converged and fused.iterations == plain.iterations
    np.testing.assert_array_equal(fused.history, plain.history)
    assert torch.equal(fused.u, plain.u)
    n = fc["rbgs_resfilter"]
    assert n > 0 and pc["rbgs_resfilter"] == 0
    assert pc["residual"] - fc["residual"] == n
    assert pc["restrict_fw"] - fc["restrict_fw"] == n
    want = GMGSolver(device="cpu", use_pallas=True, fuse_downleg=True,
                     **kw).solve_refined(b.cpu())
    assert want.iterations == fused.iterations
    np.testing.assert_allclose(fused.history, want.history, rtol=1e-3)


@pytest.mark.cuda
def test_cuda_f64_with_kernels_launches_nothing(cuda_device):
    """f64 with ``use_pallas=True`` on the card runs the plain ops, as the
    JAX wrappers send f64 to XLA: no launch, and the CPU f64 plain solve's
    iterations and history: 1e-8 relative plus 1e-12, the f64 round-off
    floor of a relative residual, eps_f64 kappa(A) ~ 1.5e-12 at 129^2 (the
    coarse matvec and the norms sum in another order on the two devices;
    measured on an H100: 4.6e-14 apart at entries near 1e-10)."""
    from multigrid_prj_tpu_torch.gmg import GMGSolver
    from multigrid_prj_tpu_torch.models.poisson import assemble_rhs

    kw = dict(shape=(129, 129), num_levels=4, cycle="v", nu=2, tol=1e-11,
              maxit=60, pad_align=128, fuse_downleg=True)
    gpu = GMGSolver(device="cuda", use_pallas=True, **kw)
    b = assemble_rhs(gpu.levels[0], 10.0, test=1, dtype=torch.float64,
                     device="cuda")
    for method in ("solve_refined", "solve"):
        cs.reset_launch_counts()
        got = getattr(gpu, method)(b)
        torch.cuda.synchronize()
        assert sum(cs.LAUNCHES.values()) == 0, method
        want = getattr(GMGSolver(device="cpu", use_pallas=False, **kw),
                       method)(b.cpu())
        assert got.converged and got.iterations == want.iterations
        np.testing.assert_allclose(got.history, want.history, rtol=1e-8,
                                   atol=1e-12)


# the sharded solver's extended-slab smoother: (rows R, columns m) of the
# slab, global logical shape, and the slab's first global row
EXT_CASES = [(64, 330, (8192, 330), -8), (64, 330, (8000, 300), 7990),
             (2048, 256, (8192, 256), 4088), (8, 128, (8192, 128), 8184),
             (64, 330, (8192, 330), -7), (200, 384, (8000, 379), 57)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,m,logical,row0", EXT_CASES)
def test_cuda_fused_ext_equals_twin(cuda_device, rows, m, logical, row0):
    """The extended-slab kernel against its twin, bit for bit, at sweeps
    1-4; one launch per call, and more than 4 sweeps refused."""
    rng = np.random.default_rng(2)
    ue, be = (torch.from_numpy(rng.standard_normal((rows + 16, m)).astype(
        np.float32)).to(cuda_device) for _ in range(2))
    h = 10.0 / (logical[0] - 1)
    for sweeps in (1, 2, 3, 4):
        cs.reset_launch_counts()
        got = cs.rbgs_fused_extended(ue, be, row0, logical, ALPHA, h, sweeps)
        torch.cuda.synchronize()
        assert cs.LAUNCHES["rbgs_fused_ext"] == 1
        want = cs.rbgs_fused_extended_plain(ue, be, row0, logical, ALPHA, h,
                                            sweeps)
        assert torch.equal(got, want), sweeps
    with pytest.raises(ValueError, match="at most 4"):
        cs.rbgs_fused_extended(ue, be, row0, logical, ALPHA, h, 5)


@pytest.mark.cuda
def test_cuda_fused_ext_equals_twin_and_refuses(cuda_device):
    """The colour-split extended-slab kernel equals its twin bit for bit at
    sweeps 1-4 on an odd row offset; no sweeps is a copy of the core and no
    launch; the C entry point refuses a geometry other than the compiled
    one, more than 4 sweeps, and a slab with no core row."""
    import ctypes

    from multigrid_prj_tpu_torch.kernels._build import library

    rng = np.random.default_rng(3)
    ue, be = (torch.from_numpy(rng.standard_normal((80, 330)).astype(
        np.float32)).to(cuda_device) for _ in range(2))
    h = 10.0 / 8191
    for sweeps in (1, 2, 3, 4):
        cs.reset_launch_counts()
        got = cs.rbgs_fused_extended(ue, be, 57, (8192, 330), ALPHA, h,
                                     sweeps)
        torch.cuda.synchronize()
        assert sum(cs.LAUNCHES.values()) == cs.LAUNCHES["rbgs_fused_ext"] == 1
        assert torch.equal(got, cs.rbgs_fused_extended_plain(
            ue, be, 57, (8192, 330), ALPHA, h, sweeps)), sweeps
    cs.reset_launch_counts()
    assert torch.equal(cs.rbgs_fused_extended(ue, be, 57, (8192, 330), ALPHA,
                                              h, 0), ue[8:-8])
    assert sum(cs.LAUNCHES.values()) == 0
    lib, stream, p = library(), cs._stream(), cs._ptr
    out = torch.empty((64, 330), device=cuda_device)
    args = (80, 330, 57, 8192, 330, 0.1)
    assert lib.mg_rbgs_fused_ext(p(ue), p(be), p(out), *args, 2,
                                 cs._geometry(4), stream) == 0
    for sweeps, geom in ((5, cs._geometry(8)), (0, cs._geometry(4)),
                         (1, cs._geometry(4)),
                         (2, (ctypes.c_int * 4)(4, 4, 96, 128))):
        assert lib.mg_rbgs_fused_ext(p(ue), p(be), p(out), *args, sweeps,
                                     geom, stream) != 0, sweeps
    assert lib.mg_rbgs_fused_ext(p(ue), p(be), p(out), 16, *args[1:], 2,
                                 cs._geometry(4), stream) != 0
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_sharded_one_rank_step(cuda_device):
    """A one-rank sharded step on the card (no process group: the one-rank
    mesh): ``"auto"`` takes the kernel route and the grouped schedule there,
    two extended-slab launches per sharded level, and the step agrees with
    the same step on the CPU (the twin; the plain ops' sums and the
    replicated bottom's ``b / c`` round differently on the two devices) to
    1e-5 of the scale."""
    from multigrid_prj_tpu_torch.models.poisson import assemble_rhs
    from multigrid_prj_tpu_torch.parallel import ShardedGMGSolver, make_mesh

    kw = dict(shape=(256, 256), mesh=make_mesh(), num_levels=4)
    s = ShardedGMGSolver(**kw, device="cuda")
    assert s.use_pallas and s.use_grouped
    b = assemble_rhs(s.levels[0], 10.0, test=1, dtype=torch.float32,
                     device="cuda")
    cs.reset_launch_counts()
    got = s.step(torch.zeros_like(b), b)
    torch.cuda.synchronize()
    assert cs.LAUNCHES["rbgs_fused_ext"] == 2 * s.num_sharded
    cpu = ShardedGMGSolver(**kw, device="cpu", use_pallas=True)
    want = cpu.step(torch.zeros_like(b.cpu()), b.cpu())
    scale = float(want.abs().max())
    assert float((got.cpu() - want).abs().max()) <= 1e-5 * scale


@pytest.mark.cuda
def test_cuda_auto_means_on_cuda(cuda_device):
    """``use_pallas="auto"`` on the card: the AMG solver takes RCM and the
    kernel route (ROADMAP.md fault C2)."""
    from multigrid_prj_tpu_torch.amg import AMGSolver
    from multigrid_prj_tpu_torch.models.poisson import poisson_fd_csr

    s = AMGSolver(poisson_fd_csr(16), num_levels=2, use_pallas="auto",
                  device="cuda")
    assert s._use_pallas and s._perm is not None


@pytest.mark.cuda
def test_cuda_sharded_amg_one_rank_matches_cpu_twin(cuda_device):
    """A one-rank ``ShardedAMGSolver`` (no process group: the one-rank
    mesh) at FD 256^2 on the card, where ``"auto"`` takes the kernel route,
    against the same hierarchy through the twins on the CPU: the same
    iterations, x within 1e-2 of its scale and histories within 1e-2
    relative (the norms and the bottom's LU round differently on the two
    devices); one SpMV launch per apply: per sharded level 3 + 3 Chebyshev
    applies of A, the residual's, P^T's and P's, and one more per cycle for
    the residual norm."""
    from multigrid_prj_tpu_torch.models.poisson import poisson_fd_csr
    from multigrid_prj_tpu_torch.parallel import ShardedAMGSolver, make_mesh

    kw = dict(num_levels=12, min_coarse=2000, tol=1e-5, maxit=200)
    gpu = ShardedAMGSolver(poisson_fd_csr(256), make_mesh(),
                           device=cuda_device, **kw)
    assert gpu._use_pallas and gpu.num_sharded >= 2
    assert all(f is not None for lv in gpu.sharded_levels
               for f in (lv.A_fast, lv.P_fast, lv.Pt_fast))
    cpu = ShardedAMGSolver.from_hierarchy(
        gpu.host_matrices, gpu.host_P, make_mesh(), perm=gpu._perm,
        lmax=gpu.lmax, use_pallas=True, device="cpu", tol=1e-5, maxit=200)
    b = np.random.default_rng(0).standard_normal(256 * 256)
    cs.reset_launch_counts()
    got = gpu.solve(b)
    torch.cuda.synchronize()
    per = gpu.num_sharded * (2 * 3 + 3) + 1
    assert cs.LAUNCHES["spmv"] == per * got.iterations == sum(
        cs.LAUNCHES.values())
    want = cpu.solve(b)
    assert got.iterations == want.iterations and got.rel_residual <= 1e-5
    assert got.x.is_cuda and got.x.shape == (256 * 256,)
    xw = want.x.numpy()
    assert np.abs(got.x.cpu().numpy() - xw).max() <= 1e-2 * np.abs(xw).max()
    np.testing.assert_allclose(got.history, want.history, rtol=1e-2,
                               atol=1e-12)


@pytest.mark.cuda
def test_cuda_sharded_amg_f64_launches_nothing(cuda_device):
    """float64 on the card with ``use_pallas=True``: the plain gather ops,
    no launch (as the JAX solver keeps its Pallas route to float32)."""
    from multigrid_prj_tpu_torch.models.poisson import poisson_fd_csr
    from multigrid_prj_tpu_torch.parallel import ShardedAMGSolver, make_mesh

    s = ShardedAMGSolver(poisson_fd_csr(64), make_mesh(), num_levels=3,
                         dtype=torch.float64, use_pallas=True, tol=1e-10,
                         device=cuda_device)
    assert not s._use_pallas and s.sharded_levels[0].A_fast is None
    cs.reset_launch_counts()
    res = s.solve(np.random.default_rng(1).standard_normal(64 * 64))
    torch.cuda.synchronize()
    assert res.rel_residual <= 1e-10 and sum(cs.LAUNCHES.values()) == 0


# the design probes of benchmarks/ (csrc/ablation.cu): stencil probes at a
# ragged-free and a ragged width, each R of the harness
PROBE_SHAPES = [(256, 512), (512, 8200)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", PROBE_SHAPES)
def test_cuda_stencil_probes_equal_twins(cuda_device, shape):
    """Each stencil probe kernel, one apply and a 29-apply chain at every R
    of the harness, bit-equal to its twin; the carry probe equal to the
    full one; the halo probe's clamped edge rows."""
    from multigrid_prj_tpu_torch.benchmarks import stencil_ablation as sa

    rng = np.random.default_rng(5)
    u = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        cuda_device)
    for name, mk, rs in sa.VARIANTS:
        kind = mk.__name__[2:]
        for r in rs:
            plain = ((lambda v, r=r: mk.plain(v, r)) if kind == "carry"
                     else mk.plain)
            cs.reset_launch_counts()
            got = mk(r)(u)
            assert cs.LAUNCHES[f"probe_{kind}"] == 1, (name, r)
            assert torch.equal(got, plain(u)), (name, r)
            chained = sa.chain(mk(r))(29)(u)
            twin = sa.chain(plain)(29)(u)
            assert torch.equal(chained, twin), (name, r)
    n = shape[0]
    halo = sa.v_halo(32)(u)
    assert torch.equal(halo[0], (4.0 * u[0] - u[7]) - u[1])
    assert torch.equal(halo[n - 1], (4.0 * u[n - 1] - u[n - 2]) - u[n - 8])
    assert torch.equal(sa.v_carry(64)(u), sa.v_full(32)(u))
    assert torch.equal(sa.v_carry_plain(u.cpu(), 32), sa.v_full_plain(u.cpu()))
    with pytest.raises(ValueError, match="divide"):
        sa.v_copy(96)(u)
    with pytest.raises(ValueError, match="made for"):
        sa.v_copy(64)(u.cpu())
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_spmv_probes_equal_twins(cuda_device):
    """Each SpMV probe kernel at every block size on banded_csr and on the
    scattered test matrix, bit-equal to its twin; ``orig`` is the SpMV
    kernel."""
    from multigrid_prj_tpu_torch.benchmarks import spmv_ablation as sp
    from multigrid_prj_tpu_torch.models.poisson import banded_csr
    from multigrid_prj_tpu_torch.ops import cuda_spmv as cv

    rng = np.random.default_rng(6)
    for M in (banded_csr(40000), _ell_matrices()["scattered"]):
        E = cv.CudaELL.build(M, device=cuda_device)
        x = sp.pad_x(torch.from_numpy(rng.standard_normal(M.shape[1]).astype(
            np.float32)).to(cuda_device))
        for tag, kern, _ in sp.VARIANTS:
            for br in sp.BLOCK_ROWS:
                cs.reset_launch_counts()
                got = sp.spmv_variant(E, x, kern, br)
                if tag == "orig":
                    assert cs.LAUNCHES["spmv"] == 1
                    assert torch.equal(got, E.spmv(x[:M.shape[1]]))
                    continue
                assert cs.LAUNCHES[tag] == 1, (tag, br)
                want = sp._PLAIN[tag](E.colsT, E.valsT, x)
                assert torch.equal(got, want), (tag, br)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_program_counts_captured_and_replayed_launches(cuda_device):
    """A harness chain as one CUDA graph: the wrapper counts its warm call
    and its capture, the replays run the captured launches (counted in
    ``REPLAYED``) and give the eager chain's result."""
    from multigrid_prj_tpu_torch.benchmarks import program as pg
    from multigrid_prj_tpu_torch.benchmarks import stencil_ablation as sa

    u = torch.rand(256, 512, device=cuda_device)
    out = []
    chain = sa.chain(sa.v_full(32))(3)
    cs.reset_launch_counts()
    pg.reset_program_counts()
    prog = pg.Program(lambda v: out.append(chain(v)), u, reps=2)
    assert cs.LAUNCHES["probe_full"] == 3 + 6
    assert pg.CAPTURED == {"probe_full": 6} and prog.launches == pg.CAPTURED
    assert pg.executed_launches()["probe_full"] == 3
    prog()
    prog()
    assert pg.REPLAYED == {"probe_full": 12}
    assert pg.executed_launches()["probe_full"] == 3 + 12
    assert cs.LAUNCHES["probe_full"] == 9
    assert torch.equal(out[-1], chain(u)) and torch.equal(out[0], out[-1])
    pg.reset_program_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("smt,cycle", [(0, "sawtooth"), (0, "v"), (1, "v"),
                                       (2, "sawtooth")])
def test_cuda_web_run_solver_equals_direct_solve(cuda_device, tmp_path, smt,
                                                 cycle):
    """The web server's solve on the card (129^2: the form's N = 9, 5
    levels) against the same solve made directly: history and x equal bit
    for bit, the same launches (f32, tol 1e-6)."""
    from multigrid_prj_tpu_torch.gmg import GMGSolver
    from multigrid_prj_tpu_torch.models.poisson import assemble_rhs
    from multigrid_prj_tpu_torch.ops.krylov import bicgstab
    from multigrid_prj_tpu_torch.ops.stencil import poisson_apply
    from multigrid_prj_tpu_torch.utils.io import load_vector
    from multigrid_prj_tpu_torch.web.server import run_solver

    form = {"n": "9", "ml": "5", "test": "1", "smt": str(smt),
            "cycle": cycle}
    cs.reset_launch_counts()
    ans = run_solver(form, str(tmp_path), device="cuda")
    served = {k: v for k, v in cs.LAUNCHES.items() if v}
    s = GMGSolver(shape=(129, 129), num_levels=5, cycle=cycle, tol=1e-6,
                  smoother="jacobi" if smt == 1 else "gs", device="cuda")
    b = assemble_rhs(s.levels[0], 10.0, test=1, device="cuda")
    cs.reset_launch_counts()
    if smt == 2:
        h0 = s.levels[0].h
        res = bicgstab(lambda x: poisson_apply(x, 10.0, h0), b, tol=1e-6,
                       maxit=200, history=True,
                       M=lambda r: s.step(torch.zeros_like(r), r))
        x, hist, iters = res.x, res.history.cpu().numpy(), res.iterations
    else:
        out = s.solve(b)
        x, hist, iters = out.u, out.history, out.iterations
    direct = {k: v for k, v in cs.LAUNCHES.items() if v}
    assert ans["iterations"] == iters and len(ans["history"]) == iters + 1
    assert ans["history"] == [float(v) for v in hist]
    assert served == direct
    assert served.get("jacobi" if smt == 1 else "rbgs_fused", 0) > 0
    assert np.array_equal(load_vector(tmp_path / "x.mtx"),
                          x.cpu().numpy().reshape(-1).astype(np.float64))


@pytest.mark.cuda
def test_cuda_record_cycle_stages_equal_step(cuda_device):
    """The corrected frames of ``record_cycle_stages`` on the card (the RB-GS
    kernel) equal ``step`` iterated, bit for bit, with the same smoother
    launches."""
    from multigrid_prj_tpu_torch.gmg import GMGSolver
    from multigrid_prj_tpu_torch.models.poisson import assemble_rhs
    from multigrid_prj_tpu_torch.viz.plots import record_cycle_stages

    s = GMGSolver(shape=(129, 129), num_levels=4, device="cuda")
    b = assemble_rhs(s.levels[0], 10.0, test=0, device="cuda")
    cs.reset_launch_counts()
    frames = record_cycle_stages(s, b, iterations=3)
    n_rec = cs.LAUNCHES["rbgs_fused"]
    cs.reset_launch_counts()
    u = torch.zeros_like(b)
    corrected = [f for lab, f in frames if lab.endswith("corrected")]
    assert len(corrected) == 3
    for frame in corrected:
        u = s.step(u, b)
        assert np.array_equal(u.cpu().numpy(), frame)
    assert n_rec == cs.LAUNCHES["rbgs_fused"] > 0


@pytest.mark.cuda
def test_cuda_checkpoint_resume_equals_uninterrupted(cuda_device, tmp_path):
    """Checkpoint after 3 iterations and resume for 5 on the card (the main
    path's V-cycle at 257^2, pad 256): history and u equal an
    uninterrupted 8-iteration solve bit for bit."""
    from multigrid_prj_tpu_torch.gmg import GMGSolver
    from multigrid_prj_tpu_torch.models.poisson import assemble_rhs
    from multigrid_prj_tpu_torch.utils.checkpoint import (
        load_checkpoint,
        resume_solve,
        save_checkpoint,
    )

    kw = dict(shape=(257, 257), num_levels=4, cycle="v", pad_align=256,
              device="cuda")
    s = GMGSolver(maxit=3, **kw)
    b = assemble_rhs(s.levels[0], 10.0, test=1, device="cuda")
    part = s.solve(b)
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, part.u, b, part.history, config={"maxit": 3})
    state = load_checkpoint(path)
    assert state["u"].dtype == np.float32 and state["config"] == {"maxit": 3}
    cs.reset_launch_counts()
    got = resume_solve(GMGSolver(maxit=5, **kw), path)
    assert all(cs.LAUNCHES[k] > 0 for k in ("rbgs_fused", "residual",
                                            "restrict_fw", "prolong_add"))
    want = GMGSolver(maxit=8, **kw).solve(b)
    assert got.u.is_cuda and len(got.history) == 9
    assert np.array_equal(got.history, want.history)
    assert torch.equal(got.u, want.u)
