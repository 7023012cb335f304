"""The port's sharded GMG (``multigrid_prj_tpu_torch.parallel``) on gloo
ranks on the CPU against the JAX ``ShardedGMGSolver`` on the virtual CPU
mesh (``tests/conftest.py``), mirroring ``tests/test_sharded_gmg.py``.

The port runs in ranks spawned once per world size (2 and 4) by a
module-scoped fixture that runs every check and hands back the gathered
results; the test cases compare them with the JAX package in this process.
Spawned ranks import this module, so it imports no jax at its top: jax is
imported inside the fixtures and tests.  Inputs are made in this process
(numpy or the JAX package's right-hand sides) and handed to both sides.
"""

import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from multigrid_prj_tpu_torch.convert import sharded_solver_from_numpy
from multigrid_prj_tpu_torch.ops import cuda_stencil as cs
from multigrid_prj_tpu_torch.parallel import (
    ShardedGMGSolver,
    make_mesh,
    maybe_initialize_distributed,
)
from multigrid_prj_tpu_torch.parallel import sharded_gmg as sg

torch.set_num_threads(1)

N = 128
LEN, ALPHA = 10.0, 10.0
SOLVE_KW = dict(shape=(N, N), length=LEN, alpha=ALPHA, num_levels=4, nu1=2,
                nu2=2, tol=1e-10, maxit=60)
N3 = 32
SOLVE3D_KW = dict(shape=(N3, N3, N3), length=10.0, alpha=10.0, num_levels=3,
                  nu1=2, nu2=2, tol=1e-8, maxit=40, min_rows_per_shard=4)
# tests/test_sharded_gmg.py:226-255: the kernel route's solve
PALLAS_KW = dict(shape=(N, N), length=LEN, alpha=ALPHA, num_levels=3, nu1=2,
                 nu2=2, tol=1e-3, maxit=30)


# ---------------------------------------------------------------------------
# the ranks (no jax here)
# ---------------------------------------------------------------------------


def _np(t):
    return t.numpy().copy()


def _solve_out(res, mesh):
    return dict(u=_np(sg.gather_slabs(res.u, mesh)), history=res.history,
                iterations=res.iterations, converged=res.converged)


def _step_and_solve(mesh, b):
    s = ShardedGMGSolver(mesh=mesh, device="cpu", **SOLVE_KW)
    bl = sg.scatter_slabs(b, mesh)
    u = s.step(torch.zeros_like(bl), bl)
    return dict(step=_np(sg.gather_slabs(u, mesh)),
                solve=_solve_out(s.solve(bl), mesh),
                num_sharded=s.num_sharded)


def _jobs_2(inp):
    return dict(x=_step_and_solve(make_mesh(2), inp["b"]))


def _jobs_4(inp):
    out = {}
    mesh = make_mesh(4)
    out["x"] = _step_and_solve(mesh, inp["b"])
    dcn = make_mesh(2, 2)
    out["dcn"] = _step_and_solve(dcn, inp["b"])
    out["dcn_axes"] = (dcn.axis_names, sg.row_axes(dcn), dcn.size)

    # a mesh on two of the four ranks (its own process group; ranks 2 and
    # 3 hold no slab), and the four ranks in reverse slab order
    pair = make_mesh(2)
    if pair.index >= 0:
        out["pair"] = _step_and_solve(pair, inp["b"])
    else:  # a rank outside the mesh is refused (an exception fails the run)
        try:
            ShardedGMGSolver(mesh=pair, device="cpu", **SOLVE_KW)
        except ValueError:
            pass
        else:
            raise AssertionError("a rank outside the mesh built a solver")
    out["reversed"] = _step_and_solve(make_mesh(devices=[3, 2, 1, 0]),
                                      inp["b"])["step"]

    # overlap True / False: the same arithmetic (tests/test_sharded_gmg.py
    # :162)
    bl = sg.scatter_slabs(inp["b"], mesh)
    h = LEN / (N - 1)
    out["overlap"] = {
        ov: _np(sg.gather_slabs(sg.rbgs_local(
            torch.zeros_like(bl), bl, ALPHA, h, (N, N), mesh, sweeps=3,
            overlap=ov), mesh)) for ov in (True, False)}

    # grouped down-leg vs the per-colour composition (:259)
    n = 64
    gshape, h = (n, n), LEN / (n - 1)
    u, b = (sg.scatter_slabs(a, mesh) for a in inp["ub64"])
    out["grouped"] = {}
    for nu in (2, 5):
        u2, rc = sg.downleg_group_local(u, b, ALPHA, h, gshape, mesh, nu)
        v2 = sg.rbgs_local(u, b, ALPHA, h, gshape, mesh, nu, overlap=False)
        r = sg.residual_local(v2, b, ALPHA, h, gshape, mesh)
        vc = sg.restrict_fw_local(r, gshape, mesh)
        out["grouped"][nu] = [_np(sg.gather_slabs(x, mesh))
                              for x in (u2, rc, v2, vc)]

    # the fused post-smoothing residual norm (:305)
    u, b = (sg.scatter_slabs(a, mesh) for a in inp["ub64_2"])
    u2, rn2 = sg.postsmooth_group_local(u, b, ALPHA, h, gshape, mesh, 2,
                                        resnorm=True)
    v2 = sg.rbgs_local(u, b, ALPHA, h, gshape, mesh, 2, overlap=False)
    r = sg.residual_local(v2, b, ALPHA, h, gshape, mesh)
    out["resnorm"] = dict(
        fused=(_np(sg.gather_slabs(u2, mesh)),
               float(mesh.all_reduce(rn2))),
        explicit=(_np(sg.gather_slabs(v2, mesh)),
                  float(sg.norm2_psum(r, mesh))))

    # halo exchanges per V(2,2) cycle (:349)
    out["halos"] = {}
    for grouped in (True, False):
        s = ShardedGMGSolver(shape=(64 * 4, 128), mesh=mesh, num_levels=3,
                             nu1=2, nu2=2, maxit=2, tol=0.0,
                             use_grouped=grouped, use_pallas=False,
                             device="cpu")
        ones = torch.ones(s.local_shape(), dtype=torch.float32)
        mesh.reset_counts()
        s.step(torch.zeros_like(ones), ones)
        out["halos"][grouped] = (mesh.counts["halo"], s.num_sharded)

    # the measured schedule decision (:377)
    s = ShardedGMGSolver(shape=(32 * 4, 64), mesh=mesh, num_levels=2, nu1=2,
                         nu2=2, tol=1e-3, maxit=50, use_grouped="measure",
                         use_pallas=False, device="cpu")
    res = s.solve(torch.ones(s.local_shape(), dtype=torch.float32))
    out["measure"] = dict(decision=s.schedule_decision,
                          converged=res.converged)

    # not shardable (:73): 100 rows do not split into 4 even slabs
    try:
        ShardedGMGSolver(shape=(100, 100), mesh=mesh, num_levels=3,
                         device="cpu")
        out["unshardable"] = None
    except ValueError as exc:
        out["unshardable"] = str(exc)

    # 3D (:101), on both layouts (:144)
    out["3d"] = {}
    for name, m in (("x", mesh), ("dcn", dcn)):
        s = ShardedGMGSolver(mesh=m, device="cpu", **SOLVE3D_KW)
        out["3d"][name] = _solve_out(s.solve(sg.scatter_slabs(inp["b3"], m)),
                                     m)
        out["3d"]["num_sharded"] = s.num_sharded

    # the kernel route on the CPU (the twin) on the JAX solver's state
    s = sharded_solver_from_numpy(inp["pallas_state"], mesh, device="cpu")
    cs.reset_launch_counts()
    res = s.solve(sg.scatter_slabs(inp["b32"], mesh))
    out["pallas"] = dict(_solve_out(res, mesh), use_pallas=s.use_pallas,
                         launches=sum(cs.LAUNCHES.values()))
    return out


_JOBS = {2: _jobs_2, 4: _jobs_4}


def _rank_main(rank, world, init_file, inputs, out_path):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        out = _JOBS[world](inputs)
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
# this process: inputs, spawns, JAX references
# ---------------------------------------------------------------------------


def _jax_mesh(p):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:p]), axis_names=("x",))


@pytest.fixture(scope="module")
def inputs():
    import jax.numpy as jnp

    from multigrid_prj_tpu.gmg import GMGSolver
    from multigrid_prj_tpu.models.poisson import assemble_rhs
    from multigrid_prj_tpu.parallel.sharded_gmg import (
        ShardedGMGSolver as JShardedGMGSolver,
    )
    from tests.test_gmg_3d import rhs_3d

    lev0 = GMGSolver(shape=(N, N), length=LEN, alpha=ALPHA,
                     num_levels=4).levels[0]
    b = np.asarray(assemble_rhs(lev0, LEN, test=1, dtype=jnp.float64))
    rng1, rng2 = np.random.default_rng(1), np.random.default_rng(2)
    js = JShardedGMGSolver(mesh=_jax_mesh(4), use_pallas=True, **PALLAS_KW)
    state = dict(levels=[dataclasses.astuple(lev) for lev in js.levels],
                 alpha=js.alpha, nu1=js.nu1, nu2=js.nu2,
                 coarse_sweeps=js.coarse_sweeps, tol=js.tol, maxit=js.maxit,
                 use_pallas=js.use_pallas, use_grouped=js.use_grouped,
                 num_sharded=js.num_sharded)
    return dict(
        b=b, b32=b.astype(np.float32),
        ub64=[rng1.standard_normal((64, 64)).astype(np.float32)
              for _ in range(2)],
        ub64_2=[rng2.standard_normal((64, 64)).astype(np.float32)
                for _ in range(2)],
        b3=np.asarray(rhs_3d((N3, N3, N3), 10.0)),
        pallas_state=state)


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    """world size -> the gathered results of that spawn (one spawn each)."""
    tmp = str(tmp_path_factory.mktemp("ranks"))
    return {2: _spawn(2, {"b": inputs["b"]}, tmp), 4: _spawn(4, inputs, tmp)}


def _jax_solver(p, **kw):
    from multigrid_prj_tpu.parallel.sharded_gmg import (
        ShardedGMGSolver as JShardedGMGSolver,
    )

    return JShardedGMGSolver(mesh=_jax_mesh(p), **kw)


@pytest.mark.parametrize("p", [2, 4])
def test_sharded_step_matches_jax(runs, inputs, p):
    """One V(2,2) cycle from zero, f64: the port's ranks against the JAX
    sharded step on p devices, to 1e-12 of the scale (JAX's own sharded vs
    replicated bound, tests/test_sharded_gmg.py:79)."""
    import jax.numpy as jnp

    js = _jax_solver(p, **SOLVE_KW)
    b = jnp.asarray(inputs["b"])
    want = np.asarray(js.step(jnp.zeros_like(b), b))
    got = runs[p]["x"]["step"]
    assert runs[p]["x"]["num_sharded"] == js.num_sharded
    assert np.abs(got - want).max() < 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("p", [2, 4])
def test_sharded_solve_matches_jax(runs, inputs, p):
    """The f64 solve to 1e-10: the JAX solver's iteration count, and u to
    1e-8 of the scale (tests/test_sharded_gmg.py:37).  The histories agree
    to 1e-13 absolute: the norms are summed in another order, and the late
    entries (~1e-10) are ratios of residuals at the f64 round-off of the
    residual sum (9.2e-15 measured on the CPU)."""
    import jax.numpy as jnp

    ref = _jax_solver(p, **SOLVE_KW).solve(jnp.asarray(inputs["b"]))
    got = runs[p]["x"]["solve"]
    assert got["converged"] and got["iterations"] == ref.iterations
    want = np.asarray(ref.u)
    assert np.abs(got["u"] - want).max() < 1e-8 * np.abs(want).max()
    np.testing.assert_allclose(got["history"], np.asarray(ref.history),
                               rtol=1e-6, atol=1e-13)


def test_two_axis_layout_equals_one_axis(runs):
    """("dcn", "x") = (2, 2) lays the slabs out dcn-major: results bitwise
    equal to the ("x",) layout of the same 4 ranks
    (tests/test_sharded_gmg.py:121)."""
    r = runs[4]
    assert r["dcn_axes"] == (("dcn", "x"), ("dcn", "x"), 4)
    assert np.array_equal(r["dcn"]["step"], r["x"]["step"])
    assert np.array_equal(r["dcn"]["solve"]["u"], r["x"]["solve"]["u"])
    assert np.array_equal(r["dcn"]["solve"]["history"],
                          r["x"]["solve"]["history"])


def test_mesh_on_chosen_ranks(runs):
    """``make_mesh(devices=...)``: a mesh on ranks 0 and 1 of a world of 4
    (a process group of its own) equals the 2-rank world bit for bit; the
    4 ranks in reverse slab order give the same grid."""
    r = runs[4]
    for key in ("step", "solve"):
        want, got = runs[2]["x"][key], r["pair"][key]
        if key == "solve":
            want, got = want["u"], got["u"]
        assert np.array_equal(got, want)
    assert np.array_equal(r["reversed"], r["x"]["step"])


def test_sharded_3d_solve(runs, inputs):
    """3D block-slab sharding at 32^3 on 4 ranks: the JAX sharded solver's
    iterations, u to 1e-8 of the scale; the (2, 2) layout bitwise equal
    (tests/test_sharded_gmg.py:101, :144)."""
    import jax.numpy as jnp

    r = runs[4]["3d"]
    js = _jax_solver(4, **SOLVE3D_KW)
    ref = js.solve(jnp.asarray(inputs["b3"]))
    assert r["num_sharded"] == js.num_sharded >= 1
    got = r["x"]
    assert got["converged"] and got["iterations"] == ref.iterations
    want = np.asarray(ref.u)
    assert np.abs(got["u"] - want).max() < 1e-8 * np.abs(want).max()
    assert np.array_equal(r["dcn"]["u"], got["u"])


def test_overlap_schedule_bitwise_identical(runs):
    """overlap=True (interior first, then the edge rows) and overlap=False
    are the same arithmetic (tests/test_sharded_gmg.py:162)."""
    o = runs[4]["overlap"]
    assert np.array_equal(o[True], o[False])
    assert np.abs(o[True]).max() > 0


@pytest.mark.parametrize("nu", [2, 5])
def test_grouped_downleg_matches_per_color(runs, nu):
    """The grouped down-leg (one exchange per group, residual and
    restriction fused) against the per-colour composition: the same float
    ops on every row that stays valid, so bitwise equal here (torch never
    contracts; the JAX test allows 1e-6 for XLA's FMAs,
    tests/test_sharded_gmg.py:259)."""
    u2, rc, v2, vc = runs[4]["grouped"][nu]
    assert u2.shape == (64, 64) and rc.shape == (32, 32)
    assert np.array_equal(u2, v2) and np.array_equal(rc, vc)


def test_postsmooth_resnorm_matches_explicit_residual(runs):
    """The fused post-smoothing residual norm equals the explicit one
    (tests/test_sharded_gmg.py:305): the same residual values, summed in the
    same order on each rank, then over the ranks."""
    res = runs[4]["resnorm"]
    assert np.array_equal(res["fused"][0], res["explicit"][0])
    assert res["fused"][1] == res["explicit"][1] > 0


def test_halo_exchange_count_pinned(runs):
    """Halo exchanges per V(2,2) step, one per direction of each exchange
    (JAX's collective-permute count, tests/test_sharded_gmg.py:349): 7 per
    sharded level grouped (b once, u per leg, the prolongation's one
    direction), 21 per colour."""
    n_g, L = runs[4]["halos"][True]
    n_p, L2 = runs[4]["halos"][False]
    assert L == L2 >= 2
    assert n_g == 7 * L, (n_g, L)
    assert n_p == 21 * L, (n_p, L)


def test_measured_schedule_decision_recorded(runs):
    """use_grouped="measure" times both schedules on the ranks and records
    the decision; the chosen schedule solves (tests/test_sharded_gmg.py
    :377)."""
    m = runs[4]["measure"]
    d = m["decision"]
    assert d["mode"] == "measured"
    assert d["chosen"] in ("grouped", "per_color")
    assert d["grouped_cycle_s"] > 0 and d["per_color_cycle_s"] > 0
    assert m["converged"]


def test_unshardable_config_raises(runs):
    assert "not shardable" in runs[4]["unshardable"]


def test_kernel_route_matches_jax_pallas(runs, inputs):
    """use_pallas=True on the CPU (the twin of the extended-slab kernel, no
    launch) on the JAX solver's state against the JAX solve with
    use_pallas=True in interpret mode, 4 shards each, with the tolerances of
    tests/test_sharded_gmg.py:226-255: u to 1e-4 of the scale, histories to
    2e-2 where they sit above 1e-3.  The port's route also takes level 1
    (64 columns), which JAX's Mosaic terms send to XLA."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    got = runs[4]["pallas"]
    assert got["use_pallas"] and got["launches"] == 0
    js = _jax_solver(4, use_pallas=True, **PALLAS_KW)
    with pltpu.force_tpu_interpret_mode():
        ref = js.solve(jnp.asarray(inputs["b32"]))
    assert got["converged"] and ref.converged
    want = np.asarray(ref.u, np.float64)
    du = np.abs(got["u"].astype(np.float64) - want).max()
    assert du / np.abs(want).max() < 1e-4
    hp, hx = got["history"], np.asarray(ref.history)
    k = min(len(hp), len(hx))
    sel = hx[:k] > 1e-3
    np.testing.assert_allclose(hp[:k][sel], hx[:k][sel], rtol=2e-2)


def test_maybe_initialize_distributed_noop(monkeypatch):
    """Without the launch variables there is nothing to join: no process
    group, False, twice; the mesh is the one-rank mesh, whose collectives
    are the identity."""
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert maybe_initialize_distributed() is False
    assert maybe_initialize_distributed() is False
    assert not dist.is_initialized()
    mesh = make_mesh()
    assert (mesh.axis_names, mesh.size, mesh.index) == (("x",), 1, 0)
    x = torch.arange(6.0).reshape(3, 2)
    top, bot = mesh.post_halo(x, 2).wait()
    assert not top.any() and not bot.any() and top.shape == (2, 2)
    assert mesh.all_gather_rows(x) is x and mesh.all_reduce(x) is x
    with pytest.raises(ValueError, match="need 2 ranks"):
        make_mesh(2)


# ---------------------------------------------------------------------------
# "auto" means "on CUDA" (ROADMAP.md fault C2) and the import surface (C1)
# ---------------------------------------------------------------------------


def test_auto_flags_take_no_kernel_route_on_the_cpu():
    """``use_pallas="auto"`` (and ``use_grouped="auto"``) on the CPU: no RCM
    and no kernel route for the AMG solver, per-colour sweeps and no kernel
    route for the sharded solver, as the JAX package on the CPU; any other
    string is refused."""
    import jax.numpy as jnp

    from multigrid_prj_tpu import amg as jamg
    from multigrid_prj_tpu.models import poisson as jpoisson
    from multigrid_prj_tpu_torch import amg as tamg
    from multigrid_prj_tpu_torch.models import poisson as tpoisson

    js = jamg.AMGSolver(jpoisson.poisson_fd_csr(8), num_levels=2,
                        dtype=jnp.float32, use_pallas="auto")
    ts = tamg.AMGSolver(tpoisson.poisson_fd_csr(8), num_levels=2,
                        dtype=torch.float32, use_pallas="auto", device="cpu")
    assert js._perm is None and not js._use_pallas
    assert ts._perm is None and not ts._use_pallas
    with pytest.raises(ValueError, match="use_pallas"):
        tamg.AMGSolver(tpoisson.poisson_fd_csr(8), use_pallas="on",
                       device="cpu")

    jsh = _jax_solver(1, shape=(64, 64), num_levels=3)
    tsh = ShardedGMGSolver(shape=(64, 64), mesh=make_mesh(), num_levels=3,
                           device="cpu")
    assert (tsh.use_pallas, tsh.use_grouped) == (
        jsh.use_pallas, jsh.use_grouped) == (False, False)
    assert tsh.schedule_decision["chosen"] == "per_color"
    for kw in (dict(use_pallas="yes"), dict(use_grouped="on")):
        with pytest.raises(ValueError):
            ShardedGMGSolver(shape=(64, 64), mesh=make_mesh(), num_levels=3,
                             device="cpu", **kw)


@pytest.mark.parametrize("sub", ["", ".ops", ".models", ".utils",
                                 ".parallel"])
def test_exports_match_the_jax_package(sub):
    """Every name of each JAX ``__all__`` imports from the port's
    counterpart and is in its ``__all__`` (``parallel.ShardedAMGSolver``
    too, since ROADMAP.md queue A item 19b)."""
    import importlib

    jmod = importlib.import_module("multigrid_prj_tpu" + sub)
    tmod = importlib.import_module("multigrid_prj_tpu_torch" + sub)
    missing = {n for n in jmod.__all__ if not hasattr(tmod, n)}
    assert not missing
    assert set(tmod.__all__) >= set(jmod.__all__)


def test_added_functions_match_jax():
    """The four functions the port lacked: ``interior_mask``,
    ``poisson_diag``, ``poisson_apply_jit`` and ``ff_neg``."""
    import jax.numpy as jnp

    from multigrid_prj_tpu.ops import extended as jext
    from multigrid_prj_tpu.ops import stencil as jst
    from multigrid_prj_tpu_torch.ops import extended as text
    from multigrid_prj_tpu_torch.ops import stencil as tst

    assert np.array_equal(tst.interior_mask((5, 7)).numpy(),
                          np.asarray(jst.interior_mask((5, 7))))
    assert tst.poisson_diag(3, 10.0, 0.1) == jst.poisson_diag(3, 10.0, 0.1)
    u = np.random.default_rng(3).standard_normal((9, 11))
    want = np.asarray(jst.poisson_apply_jit(jnp.asarray(u), 10.0, 0.25))
    got = tst.poisson_apply_jit(torch.from_numpy(u), 10.0, 0.25).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-12)
    pair = (np.float32([1.5]), np.float32([-2e-9]))
    hi, lo = text.ff_neg(*(torch.from_numpy(a) for a in pair))
    jhi, jlo = jext.ff_neg(*(jnp.asarray(a) for a in pair))
    assert float(hi) == float(jhi[0]) and float(lo) == float(jlo[0])
