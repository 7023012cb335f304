"""The port's sharded AMG (``multigrid_prj_tpu_torch.parallel.sharded_amg``)
on gloo ranks on the CPU against the JAX ``ShardedAMGSolver`` on the virtual
CPU mesh (``tests/conftest.py``), mirroring ``tests/test_sharded_amg.py``.

The port runs in ranks spawned once per world size (2 and 4) by a
module-scoped fixture that runs every check and hands back the gathered
results; world size 1 runs in this process on the one-rank mesh, with the
ranks' torch thread count (1), so the CPU LU of the bottom is the same
call.  The cases compare the results with the JAX package in this process.
Spawned ranks import this module, so it imports no jax at its top: jax is
imported inside the fixtures and tests.
"""

import os
import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from multigrid_prj_tpu_torch.convert import sharded_amg_solver_from_numpy
from multigrid_prj_tpu_torch.models.poisson import poisson_fd_csr
from multigrid_prj_tpu_torch.ops import cuda_stencil as cs
from multigrid_prj_tpu_torch.parallel import ShardedAMGSolver, make_mesh
from multigrid_prj_tpu_torch.parallel import sharded_amg as tsa

torch.set_num_threads(1)
pytestmark = pytest.mark.usefixtures("native_parity")

# tests/test_sharded_amg.py's systems and settings
CHEB = dict(n=32, seed=1, kw=dict(num_levels=3, smoother="chebyshev",
                                  tol=1e-10, maxit=60, min_rows_per_shard=32))
JACOBI = dict(n=24, seed=2, kw=dict(num_levels=3, smoother="jacobi", nu1=2,
                                    nu2=2, tol=1e-9, maxit=100,
                                    min_rows_per_shard=16))
DET = dict(n=24, seed=3, kw=dict(num_levels=2, tol=1e-8, maxit=30,
                                 min_rows_per_shard=16))
KERNEL = dict(n=32, seed=5, kw=dict(num_levels=3, smoother="chebyshev",
                                    tol=1e-5, maxit=40,
                                    min_rows_per_shard=32))
APPLY_N = 24  # the applies: FD 24^2, RCM'd, 576 rows


def _rhs(case, dtype=np.float64):
    n = case["n"] * case["n"]
    return np.random.default_rng(case["seed"]).standard_normal(n).astype(
        dtype)


def _apply_x():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(APPLY_N ** 2)
    return x, np.random.default_rng(4).standard_normal(APPLY_N ** 2).astype(
        np.float32)


def _rcm_fd(n):
    A = poisson_fd_csr(n)
    return A.permute(A.rcm_permutation())


def _launches_per_cycle(solver):
    """Applies per cycle: per sharded level the smoother's applies of A,
    the residual's, P^T's and P's; one more of A for the residual norm."""
    smooth = (solver.nu1 + solver.nu2) * (
        solver.cheb_degree if solver.smoother_name == "chebyshev" else 1)
    return solver.num_sharded * (smooth + 3) + 1


# ---------------------------------------------------------------------------
# the ranks (no jax here)
# ---------------------------------------------------------------------------


def _np(t):
    return t.numpy().copy()


def _solve(case, mesh, dtype=torch.float64, **kw):
    s = ShardedAMGSolver(poisson_fd_csr(case["n"]), mesh, dtype=dtype,
                         device="cpu", **case["kw"], **kw)
    return s, s.solve(_rhs(case))


def _solve_out(s, res):
    return dict(x=_np(res.x), iterations=res.iterations,
                rel=res.rel_residual, history=res.history,
                num_sharded=s.num_sharded)


def _counted_kernel_solve(mesh):
    """The float32 kernel-route solve with its collective and launch
    counts."""
    s = ShardedAMGSolver(poisson_fd_csr(KERNEL["n"]), mesh,
                         dtype=torch.float32, use_pallas=True, device="cpu",
                         **KERNEL["kw"])
    b = _rhs(KERNEL)
    cs.reset_launch_counts()
    mesh.reset_counts()
    res = s.solve(b)
    return dict(_solve_out(s, res), counts=dict(mesh.counts),
                launches=sum(cs.LAUNCHES.values()),
                per_cycle=_launches_per_cycle(s),
                halos=[(lv.A.halo, lv.P.halo, lv.Pt.halo)
                       for lv in s.sharded_levels],
                fast=all(f is not None for lv in s.sharded_levels
                         for f in (lv.A_fast, lv.P_fast, lv.Pt_fast)))


def _gathered(objs):
    """Every rank's ``objs`` in rank order (on every rank)."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, objs)
    return out


def _jobs(inp, world):
    mesh = make_mesh(world)
    out = {}

    # the applies on the RCM'd FD 24^2: gather (f64) and kernel route (f32)
    Ap = _rcm_fd(APPLY_N)
    n = Ap.shape[0]
    R = n // world
    rows = slice(mesh.index * R, (mesh.index + 1) * R)
    x64, x32 = (torch.from_numpy(a)[rows] for a in _apply_x())
    m = tsa.build_sharded_ell(Ap, n, n, world, torch.float64).block(
        mesh.index, "cpu")
    m32 = tsa.build_sharded_ell(Ap, n, n, world, torch.float32).block(
        mesh.index, "cpu")
    out["apply"] = _np(mesh.all_gather_rows(tsa.sharded_ell_apply(m, x64,
                                                                  mesh)))
    out["apply_kernel"] = _np(mesh.all_gather_rows(tsa.cuda_sharded_apply(
        tsa.build_cuda_sharded(m32), m32, x32, mesh)))

    # f64 solves (Chebyshev, Jacobi), the step, determinism
    s, res = _solve(CHEB, mesh)
    out["cheb"] = _solve_out(s, res)
    out["step"] = _np(mesh.all_gather_rows(s.step(_rhs(CHEB))))
    out["jacobi"] = _solve_out(*_solve(JACOBI, mesh))
    s, res = _solve(DET, mesh)
    res2 = s.solve(_rhs(DET))
    out["det"] = (res.iterations, res2.iterations,
                  torch.equal(res.x, res2.x))

    # the kernel route (the twins on the CPU), counted on every rank
    k = _counted_kernel_solve(mesh)
    k["counts"] = _gathered(k["counts"])
    k["launches"] = _gathered(k["launches"])
    out["kernel"] = k

    if world == 4:
        # not shardable: FD 8^2 has 16 rows per rank < 64
        try:
            ShardedAMGSolver(poisson_fd_csr(8), mesh, device="cpu")
            out["unshardable"] = None
        except ValueError as exc:
            out["unshardable"] = str(exc)
        # the JAX solver partitions over "x" alone
        try:
            ShardedAMGSolver(poisson_fd_csr(16), make_mesh(2, 2),
                             device="cpu")
            out["dcn"] = None
        except ValueError as exc:
            out["dcn"] = str(exc)
        # the JAX solver's hierarchy through convert: this rank's blocks
        s = sharded_amg_solver_from_numpy(
            inp["jax_state"], mesh, device="cpu", dtype=torch.float32,
            use_pallas=True, min_rows_per_shard=KERNEL["kw"][
                "min_rows_per_shard"])
        levels = [dict(
            {f"{name}_{f}": _np(getattr(getattr(lv, name), f))
             for name in ("A", "P", "Pt") for f in ("vals", "cols_rel")},
            statics=[(getattr(lv, name).halo, getattr(lv, name).in_rows,
                      getattr(lv, name).out_rows)
                     for name in ("A", "P", "Pt")],
            inv_diag=_np(lv.inv_diag), lmax=lv.lmax,
            layout=all(torch.equal(f.colsT, m.cols_rel.T)
                       and torch.equal(f.valsT, m.vals.T)
                       for f, m in ((lv.A_fast, lv.A), (lv.P_fast, lv.P),
                                    (lv.Pt_fast, lv.Pt))))
            for lv in s.sharded_levels]
        out["convert"] = dict(levels=_gathered(levels),
                              num_sharded=s.num_sharded)
    return out


def _rank_main(rank, world, init_file, inputs, out_path):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        out = _jobs(inputs, world)
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _spawn(world, inputs, tmp):
    out_path = os.path.join(tmp, f"out{world}.pkl")
    mp.spawn(_rank_main, args=(world, os.path.join(tmp, f"init{world}"),
                               inputs, out_path), nprocs=world, join=True)
    with open(out_path, "rb") as f:
        return pickle.load(f)


# ---------------------------------------------------------------------------
# this process: native parity, inputs, spawns, JAX references
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def native_parity():
    """``tests/torch_native_parity.py``'s fixture (both packages on the same
    ``native/`` library, so the hierarchies are bit-equal), imported here
    and not at the top: spawned ranks import this module and must not
    import the JAX package."""
    from torch_native_parity import native_parity as parity

    parity.__wrapped__()


def _jax_mesh(p):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:p]), axis_names=("x",))


def _jax_solver(case, p, dtype=None, **kw):
    import jax.numpy as jnp

    from multigrid_prj_tpu.models.poisson import poisson_fd_csr as jfd
    from multigrid_prj_tpu.parallel.sharded_amg import ShardedAMGSolver as J

    return J(jfd(case["n"]), _jax_mesh(p), dtype=dtype or jnp.float64,
             **case["kw"], **kw)


@pytest.fixture(scope="module")
def inputs():
    """What the ranks need from the JAX side: the float32 kernel-route
    solver's host hierarchy at p = 4, as numpy (``convert.py``)."""
    import jax.numpy as jnp

    js = _jax_solver(KERNEL, 4, jnp.float32, use_pallas=True,
                     pallas_interpret=True)

    def csr(M):
        return (M.indptr, M.indices, M.data, M.shape)

    state = dict(host_matrices=[csr(M) for M in js.host_matrices],
                 host_P=[csr(P) for P in js.host_P], perm=js._perm,
                 lmax=[lv.lmax for lv in js.sharded_levels]
                 + [t[2] for t in js._tail],
                 smoother=js.smoother_name, cheb_degree=js.cheb_degree,
                 nu1=js.nu1, nu2=js.nu2, tol=js.tol, maxit=js.maxit,
                 num_sharded=js.num_sharded)
    return dict(jax_state=state, jax_state_solver=js)


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    """world size -> the gathered results of that spawn (one spawn each);
    world size 1 in this process."""
    tmp = str(tmp_path_factory.mktemp("ranks"))
    rank_in = {"jax_state": inputs["jax_state"]}
    out = {p: _spawn(p, rank_in, tmp) for p in (2, 4)}
    out[1] = {"kernel": _counted_kernel_solve(make_mesh())}
    return out


@pytest.fixture(scope="module")
def jax_solves():
    """(case, p) -> the JAX solver and its solve, shared by the cases."""
    cache = {}

    def get(name, p):
        if (name, p) not in cache:
            case = {"cheb": CHEB, "jacobi": JACOBI}[name]
            js = _jax_solver(case, p)
            cache[name, p] = (js, js.solve(_rhs(case)))
        return cache[name, p]

    return get


@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_build_sharded_ell_matches_jax(p):
    """A, P and P^T of the 3-level FD 32^2 hierarchy, partitioned over p
    shards: vals, cols_rel, halo, in_rows and out_rows bit-equal to the JAX
    ``build_sharded_ell``, and ``None`` where it returns ``None`` (at p = 8
    level 1's band reaches past one neighbour block)."""
    import jax.numpy as jnp

    from multigrid_prj_tpu.parallel import sharded_amg as jsa

    js = _jax_solver(CHEB, 1)
    ts = ShardedAMGSolver(poisson_fd_csr(CHEB["n"]), make_mesh(),
                          dtype=torch.float64, device="cpu", **CHEB["kw"])
    assert ts.level_sizes == js.level_sizes and len(ts.host_P) == 2
    assert np.array_equal(ts._perm, js._perm)
    compared = nones = 0
    for l, (Mt, Pt) in enumerate(zip(ts.host_matrices, ts.host_P)):
        Mj, Pj = js.host_matrices[l], js.host_P[l]
        pads = [-(-M.shape[0] // p) * p for M in ts.host_matrices]
        for (tm, jm), (out_pad, in_pad) in (
                ((Mt, Mj), (pads[l], pads[l])),
                ((Pt, Pj), (pads[l], pads[l + 1])),
                ((Pt.transpose(), Pj.transpose()), (pads[l + 1], pads[l]))):
            got = tsa.build_sharded_ell(tm, out_pad, in_pad, p, torch.float64)
            want = jsa.build_sharded_ell(jm, out_pad, in_pad, p, jnp.float64)
            assert (got is None) == (want is None)
            if want is None:
                nones += 1
                continue
            assert (got.halo, got.in_rows, got.out_rows) == (
                want.halo, want.in_rows, want.out_rows)
            assert np.array_equal(got.vals.numpy(), np.asarray(want.vals))
            assert np.array_equal(got.cols_rel.numpy(),
                                  np.asarray(want.cols_rel))
            assert got.cols_rel.dtype == torch.int32
            compared += 1
    assert compared >= 3 and (nones > 0) == (p == 8)


def test_build_sharded_ell_refuses_a_wide_band():
    """Without RCM the FD system's band (n columns) reaches past one
    neighbour block of 64 rows: ``None`` on both sides."""
    import jax.numpy as jnp

    from multigrid_prj_tpu.models.poisson import poisson_fd_csr as jfd
    from multigrid_prj_tpu.parallel import sharded_amg as jsa

    A = poisson_fd_csr(16)
    shuffled = A.permute(np.random.default_rng(0).permutation(256))
    assert tsa.build_sharded_ell(shuffled, 256, 256, 4) is None
    Aj = jfd(16)
    assert jsa.build_sharded_ell(Aj.permute(np.random.default_rng(0)
                                            .permutation(256)), 256, 256, 4,
                                 jnp.float32) is None
    m = tsa.build_sharded_ell(A, 256, 256, 4)  # natural order: band 16
    assert m is not None and m.halo == 16 and m.vals.dtype == torch.float32


def _jax_apply(p, x, kernel: bool):
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.experimental.pallas import tpu as pltpu
    from jax.sharding import PartitionSpec as P

    from multigrid_prj_tpu.models.poisson import poisson_fd_csr as jfd
    from multigrid_prj_tpu.parallel import sharded_amg as jsa

    A = jfd(APPLY_N)
    Ap = A.permute(A.rcm_permutation())
    n = Ap.shape[0]
    dtype = jnp.float32 if kernel else jnp.float64
    m = jsa.build_sharded_ell(Ap, n, n, p, dtype)

    def specs(tree):
        return jax.tree.map(lambda a: P("x", *([None] * (a.ndim - 1))), tree,
                            is_leaf=lambda a: isinstance(a, jax.Array))

    if not kernel:
        f = jax.jit(shard_map(lambda mm, xx: jsa.sharded_ell_apply(mm, xx),
                              mesh=_jax_mesh(p), in_specs=(specs(m), P("x")),
                              out_specs=P("x")))
        return np.asarray(f(m, jnp.asarray(x))), Ap
    pm = jsa.build_pallas_sharded(m, p, jnp.float32, interpret=True)
    f = jax.jit(shard_map(
        lambda mm, pp, xx: jsa.pallas_sharded_apply(pp, mm, xx),
        mesh=_jax_mesh(p), in_specs=(specs(m), specs(pm), P("x")),
        out_specs=P("x")))
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(f(m, pm, jnp.asarray(x)), np.float64), Ap


@pytest.mark.parametrize("p", [2, 4])
def test_gather_apply_matches_jax_and_oracle(runs, p):
    """The gather apply on p ranks (f64) against the JAX
    ``sharded_ell_apply`` on p devices and the host SpMV, to 1e-12
    (tests/test_sharded_amg.py:38)."""
    x, _ = _apply_x()
    want, Ap = _jax_apply(p, x, kernel=False)
    got = runs[p]["apply"]
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got, Ap.spmv(x), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("p", [2, 4])
def test_kernel_route_apply_matches_jax_pallas(runs, p):
    """The kernel route's apply on p ranks (the SpMV kernel's twin on the
    extended input, f32) against the JAX ``pallas_sharded_apply`` in
    interpret mode, to 1e-6 of max |y| (tests/test_sharded_amg.py:129), and
    bit-equal to the port's unsharded twin."""
    from multigrid_prj_tpu_torch.ops import cuda_spmv as cv

    _, x32 = _apply_x()
    want, _ = _jax_apply(p, x32, kernel=True)
    got = runs[p]["apply_kernel"]
    scale = np.abs(want).max()
    assert np.abs(got - want).max() < 1e-6 * max(scale, 1.0)
    E = cv.CudaELL.build(_rcm_fd(APPLY_N), device="cpu")
    assert np.array_equal(got, _np(E.spmv(torch.from_numpy(x32))))


@pytest.mark.parametrize("p", [2, 4])
def test_chebyshev_solve_matches_jax(runs, jax_solves, p):
    """The f64 Chebyshev solve at FD 32^2 (3 levels, tol 1e-10) on p ranks:
    the JAX solver's sharded levels and iterations on p devices, x within
    1e-11 of its scale (XLA contracts the smoothers' multiply-adds into
    FMAs, torch does not: a few ulp per cycle); within one iteration of the
    port's ``AMGSolver`` and to 1e-6 of the dense solve
    (tests/test_sharded_amg.py:63)."""
    from multigrid_prj_tpu_torch.amg import AMGSolver

    js, (xj, kj, relj) = jax_solves("cheb", p)
    got = runs[p]["cheb"]
    assert got["num_sharded"] == js.num_sharded >= 1
    assert got["iterations"] == kj and got["rel"] <= 1e-10
    want = np.asarray(xj)
    assert np.abs(got["x"] - want).max() < 1e-11 * np.abs(want).max()
    assert abs(got["rel"] - relj) <= 1e-3 * relj
    A = poisson_fd_csr(CHEB["n"])
    b = _rhs(CHEB)
    single = AMGSolver(A, num_levels=3, smoother="chebyshev",
                       dtype=torch.float64, use_pallas=False, reorder="rcm",
                       device="cpu")
    x1, it1, _ = single.solve(b, tol=1e-10, maxit=60)
    assert abs(got["iterations"] - it1) <= 1
    np.testing.assert_allclose(got["x"], x1.numpy(), rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(got["x"], np.linalg.solve(A.to_dense(), b),
                               rtol=1e-6, atol=1e-7)
    hist = got["history"]
    assert len(hist) == kj + 1 and hist[0] == 1.0 and hist[-1] == got["rel"]


@pytest.mark.parametrize("p", [2, 4])
def test_jacobi_solve_matches_jax(runs, jax_solves, p):
    """Damped Jacobi (2/3), V(2,2), FD 24^2 on p ranks: the JAX solver's
    iterations, x within 1e-11 of its scale, and the dense solve to 1e-5
    (tests/test_sharded_amg.py:92)."""
    js, (xj, kj, _) = jax_solves("jacobi", p)
    got = runs[p]["jacobi"]
    assert got["num_sharded"] == js.num_sharded
    assert got["iterations"] == kj and got["rel"] <= 1e-9
    want = np.asarray(xj)
    assert np.abs(got["x"] - want).max() < 1e-11 * np.abs(want).max()
    A = poisson_fd_csr(JACOBI["n"])
    np.testing.assert_allclose(got["x"], np.linalg.solve(A.to_dense(),
                                                         _rhs(JACOBI)),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("p", [2, 4])
def test_step_matches_jax(runs, jax_solves, p):
    """One V-cycle from zero on p ranks (gathered: the padded RCM-frame
    vector) against the JAX ``step`` on p devices, to 1e-12 of the
    scale."""
    js, _ = jax_solves("cheb", p)
    want = np.asarray(js.step(_rhs(CHEB)))
    got = runs[p]["step"]
    assert got.shape == want.shape == (js.n_pads[0],)
    assert np.abs(got - want).max() < 1e-12 * np.abs(want).max()


def test_sharded_solve_deterministic(runs):
    """Two solves of one right-hand side: the same iterations and x bit for
    bit, on 2 and 4 ranks (tests/test_sharded_amg.py:105)."""
    for p in (2, 4):
        k1, k2, same = runs[p]["det"]
        assert k1 == k2 and same


def test_kernel_route_solve_matches_jax_pallas(runs):
    """The float32 solve on the kernel route (the SpMV kernel's twin on
    every sharded level, 2 ranks; bit-equal on 1 and 4, below) against the
    JAX solver on the Pallas kernels in interpret mode on 2 devices, with
    the JAX test's bounds (tests/test_sharded_amg.py:158): iterations within
    one, x to 5e-4 relative plus 5e-5.  JAX keeps the gather on a level
    whose TPU window is too wide (a Mosaic limit the port does not have), as
    its own test allows."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    js = _jax_solver(KERNEL, 2, jnp.float32, use_pallas=True,
                     pallas_interpret=True)
    assert any(lv.A_fast is not None for lv in js.sharded_levels)
    with pltpu.force_tpu_interpret_mode():
        xj, kj, _ = js.solve(_rhs(KERNEL))
    got = runs[2]["kernel"]
    assert got["fast"] and got["num_sharded"] == js.num_sharded
    assert abs(got["iterations"] - kj) <= 1 and got["rel"] <= 1e-5
    np.testing.assert_allclose(got["x"], np.asarray(xj), rtol=5e-4,
                               atol=5e-5)


def test_kernel_route_x_equal_across_world_sizes(runs):
    """On the kernel route every real row sums its slots in CSR order
    whatever the partition, and padding adds exact zeros: x after the same
    cycles is bit-equal on 1, 2 and 4 ranks (only the reduced norms round
    differently)."""
    ref = runs[1]["kernel"]
    assert ref["num_sharded"] == 2
    for p in (2, 4):
        got = runs[p]["kernel"]
        assert got["num_sharded"] == ref["num_sharded"]
        assert got["iterations"] == ref["iterations"]
        assert np.array_equal(got["x"], ref["x"])
        np.testing.assert_allclose(got["history"], ref["history"],
                                   rtol=1e-5)


@pytest.mark.parametrize("p", [1, 2, 4])
def test_collective_counts_pinned(runs, p):
    """Collectives of a k-cycle solve on each rank: one halo exchange per
    apply (9 per sharded level per cycle with Chebyshev V(1,1), degree 3,
    and one for the residual norm), counted both directions on every rank
    (``Mesh.post_halo``), none where an operator's halo is 0 (every one at
    p = 1); ``all_reduce`` k + 1 (|b|^2 and one per cycle); ``all_gather``
    k + 1 (one per cycle at the sharded bottom, one to assemble x).  No
    launch on the CPU."""
    got = runs[p]["kernel"]
    k, per = got["iterations"], got["per_cycle"]
    assert per == 2 * 9 + 1
    halos = [h for lv in got["halos"] for h in lv]
    assert all(h > 0 for h in halos) if p > 1 else not any(halos)
    want = dict(halo=2 * per * k if p > 1 else 0, all_reduce=k + 1,
                all_gather=k + 1)
    counts = got["counts"] if p > 1 else [got["counts"]]
    assert counts == [want] * p
    assert (got["launches"] if p > 1 else [got["launches"]]) == [0] * p


def test_unshardable_and_two_axis_mesh_raise(runs):
    """As the JAX solver: a level 0 of < min_rows_per_shard rows per rank
    raises ``ValueError``; and the solver partitions over ``"x"`` alone, so
    a ``("dcn", "x")`` mesh is refused."""
    import jax
    from jax.sharding import Mesh

    from multigrid_prj_tpu.models.poisson import poisson_fd_csr as jfd
    from multigrid_prj_tpu.parallel.sharded_amg import ShardedAMGSolver as J

    assert "not shardable over 4 devices" in runs[4]["unshardable"]
    with pytest.raises(ValueError, match="not shardable over 4 devices"):
        J(jfd(8), Mesh(np.array(jax.devices()[:4]), axis_names=("x",)))
    assert "('x',)" in runs[4]["dcn"]


def test_flags_on_the_cpu():
    """``use_pallas="auto"`` on the CPU takes no kernel route (the JAX
    ``"auto"`` means "on a TPU"); ``True`` takes it in float32 only; any
    other string is refused; the default device is the card."""
    import inspect

    import jax.numpy as jnp

    A = poisson_fd_csr(16)
    kw = dict(num_levels=2, min_rows_per_shard=16, device="cpu")
    auto = ShardedAMGSolver(A, make_mesh(), use_pallas="auto", **kw)
    js = _jax_solver(dict(n=16, kw=dict(num_levels=2, min_rows_per_shard=16)),
                     1, jnp.float32, use_pallas="auto")
    assert auto._use_pallas is js._use_pallas is False
    assert auto.sharded_levels[0].A_fast is None
    on = ShardedAMGSolver(A, make_mesh(), use_pallas=True, **kw)
    assert on._use_pallas and on.sharded_levels[0].A_fast is not None
    f64 = ShardedAMGSolver(A, make_mesh(), use_pallas=True,
                           dtype=torch.float64, **kw)
    assert not f64._use_pallas and f64.sharded_levels[0].A_fast is None
    with pytest.raises(ValueError, match="use_pallas"):
        ShardedAMGSolver(A, make_mesh(), use_pallas="yes", **kw)
    sig = inspect.signature(ShardedAMGSolver)
    assert sig.parameters["device"].default == "cuda"


def test_convert_holds_the_jax_levels(runs, inputs):
    """``sharded_amg_solver_from_numpy`` on the JAX solver's host hierarchy
    (4 ranks): each rank's blocks of A, P and P^T, ``inv_diag``, ``lmax``
    and the statics equal the JAX solver's sharded levels' rows of that
    rank; the kernel layout is the block transposed."""
    js = inputs["jax_state_solver"]
    got = runs[4]["convert"]
    assert got["num_sharded"] == js.num_sharded
    for l, jl in enumerate(js.sharded_levels):
        ranks = [r[l] for r in got["levels"]]
        for name in ("A", "P", "Pt"):
            jm = getattr(jl, name)
            for f in ("vals", "cols_rel"):
                cat = np.concatenate([r[f"{name}_{f}"] for r in ranks])
                assert np.array_equal(cat, np.asarray(getattr(jm, f)))
            assert all(r["statics"][("A", "P", "Pt").index(name)] == (
                jm.halo, jm.in_rows, jm.out_rows) for r in ranks)
        assert np.array_equal(np.concatenate([r["inv_diag"] for r in ranks]),
                              np.asarray(jl.inv_diag))
        assert all(r["lmax"] == jl.lmax and r["layout"] for r in ranks)
