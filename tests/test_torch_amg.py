"""The port's AMG (``multigrid_prj_tpu_torch/amg.py``) vs the JAX package on
the CPU: setup parity (level sizes, every host operator and prolongation
bit-equal, ``lmax``), the f64 cycles and solves of every smoother, PCG,
the f32 kernel path through the twins against the JAX Pallas path in
interpret mode, the reference sawtooth pass, the history semantics and
``convert.amg_solver_from_numpy``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multigrid_prj_tpu import amg as jamg
from multigrid_prj_tpu.models import fem as jfem
from multigrid_prj_tpu.models import poisson as jpoisson
from multigrid_prj_tpu_torch import amg as tamg
from multigrid_prj_tpu_torch.convert import amg_solver_from_numpy
from multigrid_prj_tpu_torch.models import fem as tfem
from multigrid_prj_tpu_torch.models import poisson as tpoisson
from multigrid_prj_tpu_torch.ops import cuda_stencil as cs
from torch_native_parity import native_parity  # noqa: F401

torch.set_num_threads(1)
pytestmark = pytest.mark.usefixtures("native_parity")
EPS32 = 2.0 ** -23


def _system(name):
    """(JAX HostCSR, port HostCSR, rhs) of a test system."""
    if name.startswith("fd"):
        n = int(name[2:])
        Aj, At = jpoisson.poisson_fd_csr(n), tpoisson.poisson_fd_csr(n)
        b = np.random.default_rng(n).standard_normal(Aj.shape[0])
        return Aj, At, b
    n = int(name[len("p1_mesh"):])
    Aj, b = jfem.assemble_p1(jfem.structured_unit_square_mesh(n))
    At, _ = tfem.assemble_p1(tfem.structured_unit_square_mesh(n))
    return Aj, At, b


def _same(a, b):
    assert tuple(a.shape) == tuple(b.shape)
    for f in ("indptr", "indices", "data"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("name,kw", [
    ("fd32", dict(smoother="chebyshev")),
    ("fd32", dict(coarsening="greedy", interp="direct", smoother="mcgs")),
    ("fd24", dict(smoother="jacobi", reorder="rcm", min_coarse=50)),
    ("p1_mesh17", dict(smoother="chebyshev", num_levels=3)),
])
def test_setup_matches_jax(name, kw):
    Aj, At, _ = _system(name)
    kw = dict(dict(num_levels=4), **kw)
    js = jamg.AMGSolver(Aj, **kw)
    ts = tamg.AMGSolver(At, device="cpu", **kw)
    assert ts.level_sizes == js.level_sizes and len(ts.levels) > 2
    assert ts.operator_complexity == js.operator_complexity
    for Mj, Mt in zip(js.host_matrices + js.host_P,
                      ts.host_matrices + ts.host_P):
        _same(Mj, Mt)
    assert len(ts.host_P) == len(js.host_P)
    assert [lv.lmax for lv in ts.levels] == [lv.lmax for lv in js.levels]
    assert [lv.n_colors for lv in ts.levels] == [lv.n_colors
                                                 for lv in js.levels]
    if js._perm is None:
        assert ts._perm is None
    else:
        assert np.array_equal(ts._perm, js._perm)
    np.testing.assert_array_equal(ts._coarse_dense.numpy(),
                                  np.asarray(js._coarse_dense))


@pytest.mark.parametrize("smoother", ["mcgs", "jacobi", "chebyshev"])
def test_vcycle_and_solve_f64_match_jax(smoother):
    Aj, At, b = _system("fd32")
    js = jamg.AMGSolver(Aj, num_levels=4, smoother=smoother)
    ts = tamg.AMGSolver(At, device="cpu", num_levels=4, smoother=smoother)
    assert ts.dtype == torch.float64
    x = np.random.default_rng(1).standard_normal(Aj.shape[0])
    got = ts.vcycle(torch.from_numpy(x), torch.from_numpy(b)).numpy()
    # the JAX cycle body, run eagerly: its public ``vcycle`` jits nu1/nu2
    # as traced values and cannot trace (ROADMAP.md section C)
    want = np.asarray(js._vcycle_impl(js.levels, js._coarse_dense,
                                      jnp.asarray(x), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    with pytest.raises(jax.errors.TracerIntegerConversionError):
        js.vcycle(jnp.asarray(x), jnp.asarray(b))
    oj = js.solve(b, tol=1e-10, maxit=60)
    ot = ts.solve(b, tol=1e-10, maxit=60)
    assert ot.iterations == oj.iterations and ot.rel_residual <= 1e-10
    np.testing.assert_allclose(ot.history, oj.history, rtol=0, atol=1e-10)
    assert isinstance(ot.x, torch.Tensor) and not ot.history_truncated
    np.testing.assert_allclose(ot.x.numpy(), np.asarray(oj.x), rtol=0,
                               atol=1e-10)
    x_, k_, rel_ = ot  # unpacks as the JAX triple
    assert k_ == ot.iterations and rel_ == ot.rel_residual


@pytest.mark.parametrize("name,smoother", [("fd24", "chebyshev"),
                                           ("p1_mesh17", "mcgs")])
def test_solve_pcg_matches_jax(name, smoother):
    Aj, At, b = _system(name)
    js = jamg.AMGSolver(Aj, num_levels=3, smoother=smoother)
    ts = tamg.AMGSolver(At, device="cpu", num_levels=3, smoother=smoother)
    oj = js.solve_pcg(b, tol=1e-10, maxit=100)
    ot = ts.solve_pcg(b, tol=1e-10, maxit=100)
    assert ot.iterations == oj.iterations and ot.rel_residual <= 1e-10
    np.testing.assert_allclose(ot.history, oj.history, rtol=0, atol=1e-10)
    np.testing.assert_allclose(ot.x.numpy(), np.asarray(oj.x), rtol=0,
                               atol=1e-9)


def test_f32_kernel_path_matches_jax_pallas():
    """FD 40^2 in f32 with the kernel path (the port's twins on the CPU)
    against the JAX Pallas path in interpret mode (tests/test_amg.py's
    ``test_amg_refined_pallas_residual_path`` setting): RCM, Chebyshev,
    kernels from 512 rows.  The same iterations; histories within 1e-3
    relative (the Pallas SpMV sums its slots in another order, and XLA
    contracts mul-adds) plus the f32 floor of what each history holds:
    ``solve`` forms its residual in f32, so each entry ||b - A x|| / ||b||
    carries a rounding of at least u32 * ||A|| ||x|| / ||b|| >= 2^-24, and
    it is held to eps32 = 2^-23 absolute (measured here: 1.1e-8 to 1.8e-8
    apart at every entry after the first, the last 4.440e-6 against
    4.458e-6, 0.39 % relative); ``solve_refined`` forms its residual in
    float-float (a 48-bit significand), held to eps32^2 absolute (measured
    here: 4.1e-6 relative at most, 3.6e-16 absolute at the last entry,
    8.7e-11)."""
    Aj, At, b = _system("fd40")
    kw = dict(num_levels=3, smoother="chebyshev", reorder="rcm",
              pallas_min_rows=512)
    js = jamg.AMGSolver(Aj, dtype=jnp.float32, use_pallas=True,
                        pallas_interpret=True, **kw)
    ts = tamg.AMGSolver(At, device="cpu", dtype=torch.float32,
                        use_pallas=True, **kw)
    assert [lv.A_fast is not None for lv in ts.levels] == \
        [lv.A_fast is not None for lv in js.levels] == [True, True, False]
    assert [lv.A_dense is not None for lv in ts.levels] == [True, True, False]
    cs.reset_launch_counts()
    oj = js.solve_refined(b, tol=1e-9, maxit=80)
    ot = ts.solve_refined(b, tol=1e-9, maxit=80)
    assert js._ell_pair_fast is not None and ts._ell_pair_fast is not None
    assert ot.iterations == oj.iterations and ot.rel_residual <= 1e-9
    np.testing.assert_allclose(ot.history, oj.history, rtol=1e-3,
                               atol=EPS32 ** 2)
    assert isinstance(ot.x, np.ndarray) and ot.x.dtype == np.float64
    r = b - At.spmv(ot.x)
    assert np.linalg.norm(r) / np.linalg.norm(b) < 5e-9
    sj = js.solve(b, tol=1e-5, maxit=60)
    st = ts.solve(b, tol=1e-5, maxit=60)
    assert st.iterations == sj.iterations and st.rel_residual <= 1e-5
    np.testing.assert_allclose(st.history, sj.history, rtol=1e-3,
                               atol=EPS32)
    assert all(v == 0 for v in cs.LAUNCHES.values())  # twins on the CPU


def test_refined_gather_path_matches_jax():
    """solve_refined with the kernel path off (the gather ff residual) in
    f32, as tests/test_amg.py's ``test_amg_refined_history``."""
    Aj, At, b = _system("fd16")
    kw = dict(num_levels=3, reorder="rcm", use_pallas=False)
    oj = jamg.AMGSolver(Aj, dtype=jnp.float32, **kw).solve_refined(
        b, tol=1e-9, maxit=60)
    ot = tamg.AMGSolver(At, device="cpu", dtype=torch.float32,
                        **kw).solve_refined(b, tol=1e-9, maxit=60)
    assert ot.iterations == oj.iterations and ot.history[0] == 1.0
    assert ot.history[-1] <= 1e-9
    np.testing.assert_allclose(ot.history, oj.history, rtol=1e-3)


def test_reference_sawtooth_pass_matches_jax():
    Aj, At, rhs = _system("p1_mesh17")
    js = jamg.AMGSolver(Aj, num_levels=3, rhs=rhs)
    ts = tamg.AMGSolver(At, device="cpu", num_levels=3, rhs=rhs)
    x0 = np.zeros(Aj.shape[0])
    xj = js.reference_sawtooth_pass(x0, pre=4, coarse=50, post=4)
    xt = ts.reference_sawtooth_pass(x0, pre=4, coarse=50, post=4)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0,
                               atol=1e-10)
    r0, r1 = ts.residual_norm(x0, rhs), ts.residual_norm(xt, rhs)
    np.testing.assert_allclose(r1, js.residual_norm(xj, rhs), rtol=1e-10)
    assert r1 < 0.5 * r0
    with pytest.raises(ValueError, match="rhs"):
        tamg.AMGSolver(At, device="cpu",
                       num_levels=2).reference_sawtooth_pass(x0)


def test_history_cap_semantics(monkeypatch):
    """Past HIST_CAP the last slot keeps the newest value and the result
    says the history is truncated, as in the JAX package."""
    Aj, At, b = _system("fd16")
    monkeypatch.setattr(jamg, "HIST_CAP", 3)
    monkeypatch.setattr(tamg, "HIST_CAP", 3)
    oj = jamg.AMGSolver(Aj, num_levels=3).solve(b, tol=1e-30, maxit=6)
    ot = tamg.AMGSolver(At, device="cpu", num_levels=3).solve(b, tol=1e-30,
                                                             maxit=6)
    assert ot.iterations == oj.iterations == 6
    assert ot.history_truncated and oj.history_truncated
    assert ot.history.shape == oj.history.shape == (4,)
    np.testing.assert_allclose(ot.history, oj.history, rtol=0, atol=1e-12)


def test_convert_from_jax_state():
    Aj, _, b = _system("fd24")
    js = jamg.AMGSolver(Aj, num_levels=4, smoother="chebyshev",
                        reorder="rcm")

    def csr(M):
        return (M.indptr, M.indices, M.data, M.shape)

    state = dict(host_matrices=[csr(M) for M in js.host_matrices],
                 host_P=[csr(P) for P in js.host_P], perm=js._perm,
                 lmax=[lv.lmax for lv in js.levels],
                 bottom_inv=np.asarray(js._coarse_dense))
    ts = amg_solver_from_numpy(state, device="cpu", smoother="chebyshev")
    assert ts.level_sizes == js.level_sizes
    assert [lv.lmax for lv in ts.levels] == [lv.lmax for lv in js.levels]
    np.testing.assert_array_equal(ts._coarse_dense.numpy(),
                                  np.asarray(js._coarse_dense))
    oj = js.solve(b, tol=1e-10, maxit=60)
    ot = ts.solve(b, tol=1e-10, maxit=60)
    assert ot.iterations == oj.iterations
    np.testing.assert_allclose(ot.history, oj.history, rtol=0, atol=1e-10)
    np.testing.assert_allclose(ot.x.numpy(), np.asarray(oj.x), rtol=0,
                               atol=1e-10)


def test_defaults_inputs_and_mcgs_fixed_point():
    _, At, b = _system("fd6")
    ts = tamg.AMGSolver(At, device="cpu", num_levels=1)
    assert (ts.dtype, ts.smoother_name, ts._use_pallas, ts._perm) == \
        (torch.float64, "mcgs", False, None)
    # f32 without the kernel path: no CudaELL anywhere
    t32 = tamg.AMGSolver(At, device="cpu", num_levels=2, dtype=torch.float32,
                         use_pallas=False, pallas_min_rows=1)
    assert all(lv.A_fast is None and lv.A_dense is None for lv in t32.levels)
    # f64 with use_pallas: the JAX rule keeps the kernel path f32-only
    assert not tamg.AMGSolver(At, device="cpu", num_levels=2,
                              use_pallas=True)._use_pallas
    x_exact = np.linalg.solve(At.to_dense(), b)
    lvl = ts.levels[0]
    np.testing.assert_allclose(
        tamg.mc_gs_sweep(lvl, torch.from_numpy(x_exact),
                         torch.from_numpy(b)).numpy(), x_exact, atol=1e-10)
    x0 = torch.zeros(36, dtype=torch.float64)
    assert torch.equal(tamg.mc_gs_sweep(lvl, x0, torch.from_numpy(b)) * 0, x0)
    with pytest.raises(ValueError):
        ts.solve(np.full(36, np.nan))
    with pytest.raises(ValueError, match="is on meta"):
        ts.solve_pcg(torch.zeros(36, device="meta"))
