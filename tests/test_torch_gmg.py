"""The port's GMG slice vs the JAX package on the CPU: hierarchy, RHS, the
solver (``solve`` / ``solve_refined`` with and without ``inner_cg``, the
Jacobi smoother, ``fmg_start``), the CLI (``-smt 0/1/2``, ``-device``), the
f64 route of the kernel solver (the plain ops, as the JAX wrappers run XLA),
the route each solver and dtype takes (the kernels of its dimension, and
where ``fuse_downleg`` applies), the card as the default device, and that the
port imports without jax.  The fused down-leg's solves are in
``tests/test_torch_fused2d.py``.

The JAX solver runs with ``use_pallas=True`` in Pallas interpret mode where
the port runs its kernel twins, and with the plain XLA path where the port
runs its plain ops.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from multigrid_prj_tpu import gmg as jgmg
from multigrid_prj_tpu import grids as jgrids
from multigrid_prj_tpu.cli import gmg_main as jcli
from multigrid_prj_tpu.models import poisson as jpoisson
from multigrid_prj_tpu_torch import gmg as tgmg
from multigrid_prj_tpu_torch import grids as tgrids
from multigrid_prj_tpu_torch.cli import gmg_main as tcli
from multigrid_prj_tpu_torch.convert import solver_state_from_numpy
from multigrid_prj_tpu_torch.models import poisson as tpoisson
from multigrid_prj_tpu_torch.ops import cuda_stencil as cs
from multigrid_prj_tpu_torch.ops import cuda_stencil_3d as c3
from multigrid_prj_tpu_torch.ops import extended as text
from multigrid_prj_tpu_torch.ops import stencil as tstencil
from multigrid_prj_tpu_torch.ops import transfer as ttransfer
from multigrid_prj_tpu_torch.utils import io as tio
from multigrid_prj_tpu_torch.utils.guards import check_finite

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["-device", "cpu"]  # the port's CLI runs on the card unless asked


def _state(js):
    """The JAX solver's state as plain numpy data (see convert.py)."""
    return dict(levels=[dataclasses.astuple(lev) for lev in js.levels],
                coarse_inv=(None if js._coarse_inv is None
                            else np.asarray(js._coarse_inv)),
                length=js.length, alpha=js.alpha, tol=js.tol, maxit=js.maxit,
                nu=js.nu, pre_sweeps=js.pre_sweeps, cycle=js.cycle,
                coarse_tol=js.coarse_tol, coarse_maxit=js.coarse_maxit)


@pytest.mark.parametrize("shape,levels,pad", [((129, 129), 4, 128),
                                              ((1025, 1025), 6, 256),
                                              ((65, 65), 4, None),
                                              ((33, 33, 33), 3, (8, 8, 128))])
def test_hierarchy_matches_jax(shape, levels, pad):
    assert (tgrids.build_hierarchy(shape, 10.0, levels, pad_align=pad)
            == [tgrids.GridLevel(*dataclasses.astuple(lev)) for lev in
                jgrids.build_hierarchy(shape, 10.0, levels, pad_align=pad)])
    assert tgrids.max_levels(shape) == jgrids.max_levels(shape)


@pytest.mark.parametrize("test", [0, 1, 2])
def test_assemble_rhs_matches_jax(test):
    """exp / sin / cos come from different math libraries; sin(30 r) and
    cos(30 r) reach arguments of ~420, whose range reduction differs: the
    measured largest relative difference is 2.4e-13."""
    lev = tgrids.build_hierarchy((65, 65), 10.0, 1)[0]
    got = tpoisson.assemble_rhs(lev, 10.0, test=test, dtype=torch.float64,
                                device="cpu")
    want = np.asarray(jpoisson.assemble_rhs(lev, 10.0, test=test,
                                            dtype=jnp.float64))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def _jax_pallas_and_port(**kw):
    """The JAX solver (``use_pallas=True``), the port solver with its
    state (kernel twins), and the 129^2 test-function-1 RHS."""
    js = jgmg.GMGSolver(use_pallas=True, **kw)
    ts = solver_state_from_numpy(_state(js), device="cpu", use_pallas=True,
                                 smoother=kw.get("smoother", "gs"),
                                 omega=kw.get("omega", 1.0))
    b = jpoisson.assemble_rhs(js.levels[0], 10.0, test=1, dtype=jnp.float32)
    return js, ts, b


def test_solve_refined_129_matches_jax_pallas():
    """129^2, 4 levels, pad 128, f32 ff refinement to 1e-8: the port's kernel
    twins against the JAX Pallas kernels in interpret mode, with the same
    hierarchy and coarse inverse.  JAX takes 8 iterations to 2.70e-9.  The
    twins differ from interpret mode by a rounding where XLA contracts an
    FMA, and the coarsest levels of JAX run XLA-order fallbacks (widths
    below 128): the histories differ by a relative 2.1e-5 at most (measured)
    and are held to 1e-4."""
    js, ts, b = _jax_pallas_and_port(
        shape=(129, 129), length=10.0, alpha=10.0, num_levels=4, cycle="v",
        nu=2, pre_sweeps=2, tol=1e-8, maxit=60, pad_align=128)
    with pltpu.force_tpu_interpret_mode():
        want = js.solve_refined(b)
    got = ts.solve_refined(torch.from_numpy(np.array(b)))
    assert want.iterations == 8 and want.converged
    assert got.iterations == want.iterations and got.converged
    assert got.history.dtype == np.float32
    np.testing.assert_allclose(got.history, want.history, rtol=1e-4)
    u = got.u.numpy()
    assert u.shape == (129, 129) and np.all(np.isfinite(u))
    np.testing.assert_allclose(u, np.asarray(want.u),
                               atol=1e-6 * np.abs(u).max())


@pytest.mark.parametrize("kw,inner_cg,iters,hist_rtol", [
    (dict(tol=1e-11), 2, 5, 1e-2),
    (dict(tol=1e-8, smoother="jacobi", omega=0.8), 0, 13, 1e-3)])
def test_solve_refined_129_variants_match_jax_pallas(kw, inner_cg, iters,
                                                     hist_rtol):
    """129^2, 4 levels, pad 128, f32 ff refinement; the JAX Pallas kernels
    in interpret mode against the port's twins, with the same hierarchy and
    coarse inverse.

    ``inner_cg=2`` (V-cycle-preconditioned CG through ``poisson_apply``):
    JAX 5 iterations to 8.3e-12.  The twins differ from interpret mode by a
    rounding where XLA contracts an FMA; CG's dot products carry that into
    every correction.  Held to 1e-2 relative plus an absolute floor: the
    inner CG runs in f32, so its last correction is exact only to
    u32 = 2^-24 relative, which moves the next entry by up to
    u32 * kappa(A) * h[k-1] (kappa ~ 6.6e3 at 129^2, h[k-1] = 1.49e-8:
    5.9e-12); entries near 1e-11 sit at that ff32 inner-solve floor, and
    the solve stops at tol = 1e-11 there.  The floor is taken as tol / 10
    = 1e-12 (chip_smoke's HISTORY_ATOL for the same solve on the card).
    Measured: last entry 8.891e-12 here against 8.294e-12 in JAX, 5.97e-13
    apart (7.2 % relative; 3.7e-3 relative on another CPU, as XLA's CPU
    code generation contracts differently); every earlier entry within
    1.2e-4 relative.

    Jacobi, omega 0.8 (the ``jacobi`` kernel): JAX 13 iterations to
    7.9e-9; measured 8.4e-5 relative at most, held to 1e-3."""
    args = dict(shape=(129, 129), length=10.0, alpha=10.0, num_levels=4,
                cycle="v", nu=2, pre_sweeps=2, maxit=60, pad_align=128, **kw)
    js, ts, b = _jax_pallas_and_port(**args)
    with pltpu.force_tpu_interpret_mode():
        want = js.solve_refined(b, inner_cg=inner_cg)
    cs.reset_launch_counts()
    got = ts.solve_refined(torch.from_numpy(np.array(b)), inner_cg=inner_cg)
    assert all(v == 0 for v in cs.LAUNCHES.values())  # twins on the CPU
    assert want.iterations == iters and want.converged
    assert got.iterations == want.iterations and got.converged
    floor = 1e-12 if inner_cg else 0.0  # the ff32 inner-solve floor
    np.testing.assert_allclose(got.history, want.history, rtol=hist_rtol,
                               atol=floor)
    np.testing.assert_allclose(got.u.numpy(), np.asarray(want.u),
                               atol=1e-6 * np.abs(np.asarray(want.u)).max())


@pytest.mark.parametrize("cycle,fmg_start", [("v", False), ("w", False),
                                             ("v", True)])
def test_solve_f64_matches_jax_xla(cycle, fmg_start):
    """Plain path (use_pallas=False) in f64 on a padded 65^2: the same
    iterations; histories to rtol 1e-8 plus the f64 round-off floor of a
    relative residual, eps_f64 * kappa(A) ~ 4e-13 at 65^2 (measured
    absolute differences up to 1.4e-14)."""
    kw = dict(shape=(65, 65), num_levels=3, cycle=cycle, nu=2, tol=1e-10,
              maxit=30, pad_align=128, use_pallas=False)
    js = jgmg.GMGSolver(**kw)
    b = jpoisson.assemble_rhs(js.levels[0], 10.0, test=1, dtype=jnp.float64)
    want = js.solve(b, fmg_start=fmg_start)
    ts = solver_state_from_numpy(_state(js), device="cpu", use_pallas=False)
    got = ts.solve(torch.from_numpy(np.array(b)), fmg_start=fmg_start)
    assert got.iterations == want.iterations and got.converged
    np.testing.assert_allclose(got.history, np.asarray(want.history),
                               rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(got.u.numpy(), np.asarray(want.u), rtol=1e-9,
                               atol=1e-9 * np.abs(np.asarray(want.u)).max())


def test_port_solver_builds_the_same_coarse_inverse():
    kw = dict(shape=(129, 129), num_levels=4, cycle="v", pad_align=128)
    js = jgmg.GMGSolver(use_pallas=False, **kw)
    ts = tgmg.GMGSolver(**kw, device="cpu")
    np.testing.assert_array_equal(ts._coarse_inv.numpy(),
                                  np.asarray(js._coarse_inv))


def test_convert_refuses_other_levels():
    js = jgmg.GMGSolver(shape=(65, 65), num_levels=3, cycle="v",
                        pad_align=128, use_pallas=False)
    state = _state(js)
    state["levels"] = state["levels"][:2]
    state["levels"][1] = ((34, 34), *state["levels"][1][1:])
    with pytest.raises(ValueError):
        solver_state_from_numpy(state, device="cpu")


def _run_cli(main, argv, cwd, monkeypatch):
    monkeypatch.chdir(cwd)
    assert main(argv) == 0
    return tio.load_vector(cwd / "MGGS4.txt"), tio.load_vector(cwd / "x.mtx")


def test_cli_65_test0_f64_matches_jax_cli(tmp_path, monkeypatch):
    """``-n 65 -ml 4 -test 0`` (sawtooth, f64, XLA order on both sides):
    11 iterations as in PARITY.md.  Measured max relative history
    difference 3.5e-13; the late entries sit near 1e-11 where ulp
    differences are amplified by about kappa(A), so the bound is 1e-8."""
    argv = ["-n", "65", "-ml", "4", "-test", "0"]
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    jh, jx = _run_cli(jcli.main, argv, tmp_path / "jax", monkeypatch)
    th, tx = _run_cli(tcli.main, argv + CPU, tmp_path / "torch", monkeypatch)
    assert len(th) == len(jh) == 12  # 1.0 + 11 iterations
    np.testing.assert_allclose(th, jh, rtol=1e-8)
    assert th[-1] < 1e-11
    assert tx.size == 65 * 65
    np.testing.assert_allclose(tx, jx, rtol=1e-9, atol=1e-12 * np.abs(jx).max())


def test_cli_jacobi_65_f64_matches_jax_cli(tmp_path, monkeypatch):
    """``-smt 1`` (undamped Jacobi in the sawtooth cycle, f64, XLA order on
    both sides) to ``-tol 1e-6``: 706 iterations on both sides, the
    reference's slow undamped Jacobi.  Measured max relative history
    difference 3.7e-8 (706 iterations of round-off, each amplified by about
    kappa(A)); held to 1e-6."""
    argv = ["-n", "65", "-ml", "4", "-test", "0", "-smt", "1", "-tol", "1e-6"]
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    jh, jx = _run_cli(jcli.main, argv, tmp_path / "jax", monkeypatch)
    th, tx = _run_cli(tcli.main, argv + CPU, tmp_path / "torch", monkeypatch)
    assert len(th) == len(jh) == 707  # 1.0 + 706 iterations
    np.testing.assert_allclose(th, jh, rtol=1e-6)
    assert th[-1] <= 1e-6
    np.testing.assert_allclose(tx, jx, rtol=1e-6, atol=1e-9 * np.abs(jx).max())


def test_cli_bicgstab_65_f64_matches_jax_cli(tmp_path, monkeypatch):
    """``-smt 2 -cycle v``: BiCGSTAB on the plain apply, preconditioned by
    one V-cycle step; MGGS4.txt holds only the final relative residual
    (JAX: 2.85e-12).  Round-off of the dot products' summation order:
    measured 1.8e-13 relative on the residual; held to 1e-6, and x to
    1e-9."""
    argv = ["-n", "65", "-ml", "4", "-test", "0", "-smt", "2", "-cycle", "v"]
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    jh, jx = _run_cli(jcli.main, argv, tmp_path / "jax", monkeypatch)
    th, tx = _run_cli(tcli.main, argv + CPU, tmp_path / "torch", monkeypatch)
    assert th.size == jh.size == 1 and th[0] < 1e-11
    np.testing.assert_allclose(th, jh, rtol=1e-6)
    assert tx.size == 65 * 65
    np.testing.assert_allclose(tx, jx, rtol=1e-9, atol=1e-9 * np.abs(jx).max())


def test_cli_bicgstab_with_pad_fails_on_both_sides(tmp_path, monkeypatch):
    """The JAX CLI hands logical-shape vectors to the padded cycle under
    ``-smt 2 -pad`` and fails (an assertion in the sawtooth cycle here); the
    port reproduces the failure with a clear error instead of fixing it."""
    argv = ["-n", "65", "-ml", "4", "-test", "0", "-smt", "2", "-pad", "128"]
    monkeypatch.chdir(tmp_path)
    with pytest.raises((AssertionError, TypeError)):
        jcli.main(argv)
    with pytest.raises(ValueError, match="finest-level buffers"):
        tcli.main(argv + CPU)


_KERNEL_WRAPPERS = ("red_black_gauss_seidel", "jacobi", "poisson_residual",
                    "ff_poisson_residual", "poisson_apply",
                    "restrict_fw_padded_fast", "prolong_add_padded_fast",
                    "rbgs_residual_restrict")


@pytest.mark.parametrize("method,kw", [("solve_refined", {}),
                                       ("solve_refined", dict(inner_cg=2)),
                                       ("solve", {}),
                                       ("solve", dict(fmg_start=True))])
def test_f64_with_kernels_runs_the_plain_ops(monkeypatch, method, kw):
    """The JAX kernel wrappers take f32 only and send f64 to XLA ops
    (``_is_supported``); so ``use_pallas=True`` in f64 runs the plain ops on
    every device: no kernel wrapper is called, and the solve equals the
    ``use_pallas=False`` one bit for bit (the same solver in f32 does call
    the wrappers)."""
    called = []
    for name in _KERNEL_WRAPPERS:
        def spy(*a, _orig=getattr(cs, name), _name=name, **k):
            called.append(_name)
            return _orig(*a, **k)

        monkeypatch.setattr(cs, name, spy)
    args = dict(shape=(65, 65), num_levels=3, cycle="v", nu=2, tol=1e-10,
                maxit=30, pad_align=128, fuse_downleg=True, device="cpu")
    ts = tgmg.GMGSolver(use_pallas=True, **args)
    b = tpoisson.assemble_rhs(ts.levels[0], 10.0, test=1,
                              dtype=torch.float64, device="cpu")
    got = getattr(ts, method)(b, **kw)
    assert not called
    want = getattr(tgmg.GMGSolver(use_pallas=False, **args), method)(b, **kw)
    assert got.converged and got.iterations == want.iterations
    np.testing.assert_array_equal(got.history, want.history)
    assert torch.equal(got.u, want.u)
    getattr(ts, method)(b.float(), **kw)
    assert called


def _route_fns(kind):
    """The functions a route of ``kind`` holds (all but the smoother):
    ``plain``, ``2d`` (the 2D kernels' wrappers, the down-leg left out) or
    ``3d``."""
    if kind == "plain":
        return dict(residual=tstencil.poisson_residual,
                    apply=tstencil.poisson_apply,
                    padded_restrict=ttransfer.restrict_fw_padded,
                    prolong_add=None, downleg=None,
                    ff_residual=text.ff_poisson_residual,
                    ff_update_residual=text.ff_update_residual)
    if kind == "2d":
        return dict(residual=cs.poisson_residual, apply=cs.poisson_apply,
                    padded_restrict=cs.restrict_fw_padded_fast,
                    prolong_add=cs.prolong_add_padded_fast,
                    ff_residual=cs.ff_poisson_residual,
                    ff_update_residual=cs.ff_update_residual)
    return dict(residual=c3.poisson_residual_3d, apply=c3.poisson_apply_3d,
                padded_restrict=ttransfer.restrict_fw_padded,
                prolong_add=None, downleg=None,
                ff_residual=c3.ff_poisson_residual_3d,
                ff_update_residual=c3.ff_update_residual_3d)


_BASE2 = dict(shape=(129, 129), num_levels=4, cycle="v", pad_align=128,
              coarse="none", fuse_downleg=True)
_BASE3 = dict(_BASE2, shape=(17, 17, 17), num_levels=3, pad_align=(8, 8, 128))


@pytest.mark.parametrize("kw,dtype,kind,downleg", [
    (dict(_BASE2, device="cpu"), torch.float32, "plain", False),
    (dict(_BASE2, device="cuda"), torch.float32, "2d", True),
    (dict(_BASE2, device="cuda"), torch.float64, "plain", False),
    (dict(_BASE2, use_pallas=True, device="cpu"), torch.float32, "2d", True),
    (dict(_BASE2, use_pallas=True, device="cpu"), torch.bfloat16, "plain",
     False),
    (dict(_BASE2, fuse_downleg=False, use_pallas=True, device="cpu"),
     torch.float32, "2d", False),
    (dict(_BASE2, smoother="jacobi", use_pallas=True, device="cpu"),
     torch.float32, "2d", False),
    (dict(_BASE2, omega=1.2, use_pallas=True, device="cpu"), torch.float32,
     "2d", False),
    (dict(_BASE3, use_pallas=True, device="cpu"), torch.float32, "3d", False),
    (dict(_BASE3, use_pallas=True, device="cpu"), torch.float64, "plain",
     False),
    (dict(_BASE3, use_pallas=False, device="cpu"), torch.float32, "plain",
     False),
    (dict(_BASE3, device="cuda"), torch.float32, "3d", False)])
def test_route_per_solver_and_dtype(kw, dtype, kind, downleg):
    """The route ``_route(dtype)`` of a solver: the 2D kernels' wrappers in
    2D and the 3D ones in 3D (plain transfers, no down-leg) for float32
    with ``use_pallas`` (the default on the card), the plain ops for any
    other dtype or without ``use_pallas``; the fused down-leg where the JAX
    solver wires it: the 2D kernel route, RB-GS, omega 1, ``fuse_downleg``.
    The public ``smoother`` is the float32 route's (``coarse="none"`` makes
    no tensor, so a CUDA solver builds without a card)."""
    s = tgmg.GMGSolver(**kw)
    route = s._route(dtype)
    for field, want in _route_fns(kind).items():
        assert getattr(route, field) is want, field
    assert (route.downleg is not None) == downleg
    assert s.smoother is s._route(torch.float32).smooth
    assert (s._route(torch.float64).smooth
            is s._route(torch.bfloat16).smooth)


def _device_defaults():
    from multigrid_prj_tpu_torch import amg, convert
    from multigrid_prj_tpu_torch.ops import cuda_spmv, sparse, sparse_extended

    return [tgmg.GMGSolver, amg.AMGSolver, amg.AMGSolver.from_hierarchy,
            convert.solver_state_from_numpy, convert.amg_solver_from_numpy,
            tpoisson.grid_coords, tpoisson.assemble_rhs,
            sparse.ELLMatrix.from_host_csr, sparse.to_device,
            cuda_spmv.CudaELL.build, sparse_extended.ELLPair.from_host_csr,
            sparse_extended.ff_pair_from_f64]


@pytest.mark.parametrize("fn", _device_defaults(),
                         ids=lambda fn: fn.__qualname__)
def test_the_card_is_the_default_device(fn):
    """Every function that makes a solver or its device data runs on the
    card unless the caller names another device."""
    import inspect

    assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("cli", ["gmg", "amg"])
def test_cli_without_a_card_asks_for_device_cpu(cli, monkeypatch, capsys,
                                               tmp_path):
    """Without a card and without ``-device cpu`` both CLIs fail and name
    the flag, writing nothing; ``-device`` takes cuda or cpu."""
    from multigrid_prj_tpu_torch.cli import amg_main as tamg_cli
    from multigrid_prj_tpu_torch.utils.config import parse_gmg_args

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    main, argv = ((tcli.main, ["-n", "17", "-ml", "2"]) if cli == "gmg"
                  else (tamg_cli.main, ["-matrix", "fd.mtx"]))
    assert main(argv) == 1
    assert "-device cpu" in capsys.readouterr().out
    assert not any(tmp_path.iterdir())
    if cli == "gmg":
        assert parse_gmg_args(["-n", "17"]).device == "cuda"
        assert parse_gmg_args(["-device", "cpu"]).device == "cpu"
        with pytest.raises(SystemExit):
            parse_gmg_args(["-device", "tpu"])
    else:
        with pytest.raises(SystemExit):
            main(["-matrix", "fd.mtx", "-device", "tpu"])


def test_solver_is_pure_and_checks_inputs():
    # tol above the f32 floor eps_f32 * kappa(A) (~6e-6 at 33^2)
    ts = tgmg.GMGSolver(shape=(33, 33), num_levels=3, cycle="v", tol=1e-4,
                        pad_align=64, use_pallas=True, device="cpu")
    b = tpoisson.assemble_rhs(ts.levels[0], 10.0, test=1, dtype=torch.float32,
                              device="cpu")
    b0 = b.clone()
    cs.reset_launch_counts()
    out = ts.solve(b)
    assert torch.equal(b, b0)
    assert all(v == 0 for v in cs.LAUNCHES.values())  # twins on the CPU
    assert out.converged and 0 < out.convergence_factor < 0.5
    with pytest.raises(ValueError):
        ts.solve(b.clone().fill_(float("nan")))
    with pytest.raises(ValueError):
        check_finite(np.array([1.0, np.inf]))


def test_port_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['multigrid_prj_tpu'] = None; "
            "sys.modules['benchmarks'] = None; "
            "import multigrid_prj_tpu_torch as p; "
            "import multigrid_prj_tpu_torch.convert, "
            "multigrid_prj_tpu_torch.ops.krylov, "
            "multigrid_prj_tpu_torch.cli.gmg_main, "
            "multigrid_prj_tpu_torch.kernels._build, "
            "multigrid_prj_tpu_torch.amg, multigrid_prj_tpu_torch.native, "
            "multigrid_prj_tpu_torch.ops.sparse, "
            "multigrid_prj_tpu_torch.ops.cuda_spmv, "
            "multigrid_prj_tpu_torch.ops.sparse_extended, "
            "multigrid_prj_tpu_torch.models.fem, "
            "multigrid_prj_tpu_torch.utils.metrics, "
            "multigrid_prj_tpu_torch.cli.amg_main, "
            "multigrid_prj_tpu_torch.benchmarks.program, "
            "multigrid_prj_tpu_torch.benchmarks.stencil_ablation, "
            "multigrid_prj_tpu_torch.benchmarks.spmv_ablation, "
            "multigrid_prj_tpu_torch.utils.guards, "
            "multigrid_prj_tpu_torch.utils.checkpoint, "
            "multigrid_prj_tpu_torch.cli.amg_debug, "
            "multigrid_prj_tpu_torch.cli.viz_main, "
            "multigrid_prj_tpu_torch.viz.plots, "
            "multigrid_prj_tpu_torch.web.server; "
            "assert p.GMGSolver; print('ok')")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_viz_plots_imports_and_records_without_matplotlib():
    """The card's machine has no matplotlib: ``viz.plots`` imports without
    it, and ``record_cycle_stages`` / ``write_stage_files`` run (the
    drawing functions import it when called)."""
    code = ("import sys, tempfile; sys.modules['matplotlib'] = None; "
            "sys.modules['jax'] = None; "
            "sys.modules['multigrid_prj_tpu'] = None; "
            "import torch; "
            "from multigrid_prj_tpu_torch.viz import plots; "
            "from multigrid_prj_tpu_torch.gmg import GMGSolver; "
            "from multigrid_prj_tpu_torch.models.poisson import assemble_rhs; "
            "s = GMGSolver(shape=(17, 17), num_levels=2, device='cpu'); "
            "b = assemble_rhs(s.levels[0], 10.0, test=0, device='cpu'); "
            "f = plots.record_cycle_stages(s, b, iterations=1); "
            "plots.write_stage_files(f, tempfile.mkdtemp()); "
            "assert len(f) == 5 and 'matplotlib.pyplot' not in sys.modules; "
            "print('ok')")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
