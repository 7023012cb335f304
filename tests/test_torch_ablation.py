"""The port's design probes (``multigrid_prj_tpu_torch/benchmarks/``) vs the
JAX package's (``benchmarks/stencil_ablation.py``, ``spmv_ablation.py``) on
the CPU: the stencil twins against the Pallas probes in interpret mode at
N = 128, M = 256 (the module globals set on both sides), the SpMV twins
against the three Pallas probes, ``PallasELL.spmv`` and NumPy statements of
their definitions on ``banded_csr(4096)``, the timing program off the card
and its launch arithmetic, and both harness ``main``s on ``-device cpu`` at
a tiny size, printing the JAX harnesses' line formats.

Bounds: the copy probe is exact.  The other stencil probes are held to 2
ulp of the field's maximum: XLA's CPU backend may contract ``4 * u - x``
into an FMA, where the twins round the product first (the product by 4 is
exact in f32, so both usually agree bit for bit).  The stream probe's
products and sums are integers below 2^24 on ``banded_csr`` (values 8 and
-1), so every order gives the same f32 result.  The Pallas SpMV sums its
slots with a vector reduction, the twin in slot order: 4 ulp (f32) of
``sum_k |a_ik| |x_k|`` per row, as in tests/test_torch_spmv.py.
"""

import json
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from benchmarks import spmv_ablation as jsp
from benchmarks import stencil_ablation as jsa
from benchmarks.spmv_bench import banded_csr as jbanded_csr
from multigrid_prj_tpu.ops.pallas_spmv import PallasELL
from multigrid_prj_tpu_torch.benchmarks import program as pg
from multigrid_prj_tpu_torch.benchmarks import spmv_ablation as tsp
from multigrid_prj_tpu_torch.benchmarks import stencil_ablation as tsa
from multigrid_prj_tpu_torch.models.poisson import banded_csr
from multigrid_prj_tpu_torch.ops import cuda_stencil as cs
from multigrid_prj_tpu_torch.ops.cuda_spmv import CudaELL

torch.set_num_threads(1)
EPS32 = float(np.finfo(np.float32).eps)
N, M = 128, 256
SPMV_N = 4096
PROBES = ("copy", "rolls", "shifts", "halo", "full", "carry")


@pytest.fixture
def small(monkeypatch):
    """N x M on both sides: each module's ``v_*`` and ``make_u`` read them
    when called."""
    for mod in (jsa, tsa):
        monkeypatch.setattr(mod, "N", N)
        monkeypatch.setattr(mod, "M", M)


def _u():
    return np.random.default_rng(7).standard_normal((N, M)).astype(np.float32)


def _jax_probe(kind, r, u):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(getattr(jsa, f"v_{kind}")(r)(jnp.asarray(u)))


@pytest.mark.parametrize("r", [32, 64])
@pytest.mark.parametrize("kind", PROBES)
def test_stencil_twin_matches_jax_probe(small, kind, r):
    u = _u()
    want = _jax_probe(kind, r, u)
    cs.reset_launch_counts()
    got = getattr(tsa, f"v_{kind}")(r, device="cpu")(torch.from_numpy(u))
    assert sum(cs.LAUNCHES.values()) == 0  # the twin on the CPU
    got = got.numpy()
    assert got.shape == (N, M) and got.dtype == np.float32
    if kind == "copy":
        assert np.array_equal(got, want)
    else:
        bound = 2 * np.spacing(np.float32(np.abs(want).max()))
        assert np.abs(got - want).max() <= bound, kind


def test_halo_edge_rows_and_carry_equal_full(small):
    """The halo probe's clamped 8-row halo blocks: row 0's north is u[7],
    row N-1's south is u[N-8] (interpret mode gives the same); the carry
    twin equals the full twin at every R."""
    u = _u()
    got = tsa.v_halo(32, device="cpu")(torch.from_numpy(u)).numpy()
    row0 = (np.float32(4) * u[0] - u[7]) - u[1]
    last = (np.float32(4) * u[N - 1] - u[N - 2]) - u[N - 8]
    assert np.array_equal(got[0], row0) and np.array_equal(got[-1], last)
    want = _jax_probe("halo", 64, u)
    bound = 2 * np.spacing(np.float32(np.abs(want).max()))
    assert np.abs(want[0] - row0).max() <= bound
    assert np.abs(want[-1] - last).max() <= bound
    ut = torch.from_numpy(u)
    full = tsa.v_full(32, device="cpu")(ut)
    for r in (8, 32, 64, 128):
        assert torch.equal(tsa.v_carry(r, device="cpu")(ut), full), r
    assert torch.equal(full[0], ut[0]) and torch.equal(full[:, -1], ut[:, -1])


def test_stencil_probe_refusals(small):
    u = torch.from_numpy(_u())
    with pytest.raises(ValueError, match="divide"):
        tsa._launch("copy", u, 96)
    with pytest.raises(ValueError, match="8-row halo"):
        tsa._launch("halo", u, 4)
    with pytest.raises(ValueError, match="made for"):
        tsa.v_full(32, device="cuda")(u)
    assert tsa.make_u("cpu").shape == (N, M)


@pytest.fixture(scope="module")
def ell():
    """``banded_csr(4096)``: the JAX Pallas layout (block_rows 1024), the
    port's slot-major ELL, and x."""
    pA = PallasELL.build(jbanded_csr(SPMV_N), dtype=jnp.float32,
                         block_rows=1024)
    A = banded_csr(SPMV_N)
    E = CudaELL.build(A, device="cpu")
    x = np.random.default_rng(0).standard_normal(SPMV_N).astype(np.float32)
    return pA, A, E, x


def test_stream_twin_matches_jax_probe(ell):
    """Fed JAX's own ``colsT_rel`` (as int32) and ``valsT``, the stream twin
    gives the Pallas probe's integers; on the port's ELL it gives the f64
    sum of vals * cols."""
    pA, A, E, x = ell
    assert pA.colsT_rel.shape == (8, SPMV_N) and pA.t_win == 3
    x2d = pA.pad_x(jnp.asarray(x))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jsp.spmv_variant(pA, x2d, jsp._kernel_probe_stream,
                                           1024)).reshape(-1)[:SPMV_N]
    cols = torch.from_numpy(np.asarray(pA.colsT_rel).astype(np.int32))
    vals = torch.from_numpy(np.array(pA.valsT))
    got = tsp.spmv_variant(
        CudaELL(colsT=cols, valsT=vals, shape=(SPMV_N, SPMV_N), nnz=0),
        torch.from_numpy(x), tsp._kernel_probe_stream, 1024)
    assert np.array_equal(got.numpy(), want)
    got = tsp.spmv_variant(E, torch.from_numpy(x), tsp._kernel_probe_stream,
                           8192).numpy()
    exact = (E.valsT.double() * E.colsT.double()).sum(0).numpy()
    assert np.array_equal(got.astype(np.float64), exact)


def test_orig_matches_pallas_and_oracle(ell):
    pA, A, E, x = ell
    xp = tsp.pad_x(torch.from_numpy(x))
    cs.reset_launch_counts()
    got = tsp.spmv_variant(E, xp, tsp._orig, 32768).numpy()
    assert sum(cs.LAUNCHES.values()) == 0
    bound = 4 * EPS32 * (np.abs(A.to_dense()) @ np.abs(x.astype(np.float64)))
    want = np.asarray(pA.spmv(jnp.asarray(x), interpret=True))
    assert np.all(np.abs(got - want) <= bound)
    oracle = A.spmv(x.astype(np.float64))
    assert np.all(np.abs(got - oracle) <= bound)


@pytest.mark.parametrize("tag", ["probe_staticwin", "probe_noshuffle"])
def test_gather_probe_twins_match_jax_probe(ell, tag):
    """The Pallas probe in interpret mode against the port's twin.  At
    block_rows 1024 the Pallas layout of ``banded_csr(4096)`` is not
    windowed (``t_win`` 3, absolute ``base2``, ``rel = col - 128 base2``):
    the staticwin probe reads ``x[rel]`` from its base-0 window, which the
    twin gives fed JAX's ``colsT_rel`` (rel < 384, so ``& 1023`` keeps it);
    the noshuffle probe reads ``x[128 (base2 + (rel >> 7)) + lane]`` =
    ``x[(col & ~127) | lane]``, the twin on the port's absolute ids.  Pallas
    sums its slots with ``jnp.sum``, the twin in slot order: 4 ulp (f32) of
    ``sum_k |vals[k, i]| |x gathered|`` per row."""
    pA, A, E, x = ell
    assert pA.q is None and pA.t_win == 3
    x2d = pA.pad_x(jnp.asarray(x))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jsp.spmv_variant(pA, x2d, getattr(
            jsp, f"_kernel_{tag}"), 1024)).reshape(-1)[:SPMV_N]
    xp = tsp.pad_x(torch.from_numpy(x))
    if tag == "probe_staticwin":
        cols = np.asarray(pA.colsT_rel).astype(np.int32)
        vals = np.array(pA.valsT)
        assert cols.max() < 3 * 128
        E = CudaELL(colsT=torch.from_numpy(cols), valsT=torch.from_numpy(vals),
                    shape=(SPMV_N, SPMV_N), nnz=0)
        idx = cols & 1023
    else:
        cols, vals = E.colsT.numpy(), E.valsT.numpy()
        idx = (cols & ~127) | (np.arange(SPMV_N) & 127)
    got = tsp.spmv_variant(E, xp, getattr(tsp, f"_kernel_{tag}"), 1024)
    gathered = np.abs(vals.astype(np.float64)) * np.abs(x[idx])
    bound = 4 * EPS32 * gathered.sum(0)
    assert np.all(np.abs(got.numpy().astype(np.float64) - want) <= bound)
    assert np.abs(want).max() > 1  # the probes gather, not zeros


@pytest.mark.parametrize("tag", ["probe_staticwin", "probe_noshuffle"])
def test_gather_probe_twins_match_numpy(ell, tag):
    """staticwin: ``sum_k vals[k, i] * x[cols[k, i] & 1023]``; noshuffle:
    ``sum_k vals[k, i] * x[(cols[k, i] & ~127) | (i & 127)]``, slot by slot
    in f32 (NumPy contracts nothing, so the twin is bit-equal)."""
    pA, A, E, x = ell
    xp = tsp.pad_x(torch.from_numpy(x[:SPMV_N - 5]), SPMV_N)
    cols, vals, xn = E.colsT.numpy(), E.valsT.numpy(), xp.numpy()
    lane = np.arange(SPMV_N) & 127
    acc = np.zeros(SPMV_N, np.float32)
    for k in range(cols.shape[0]):
        idx = cols[k] & 1023 if tag == "probe_staticwin" else \
            (cols[k] & ~127) | lane
        acc = acc + vals[k] * xn[idx]
    kern = dict((t, f) for t, f, _ in tsp.VARIANTS)[tag]
    got = tsp.spmv_variant(E, xp, kern, 1024).numpy()
    assert np.array_equal(got, acc)


def test_program_on_the_cpu_runs_the_calls():
    """Off the card a program is its calls, run on every replay, with no
    graph and no counts."""
    calls = []
    prog = pg.Program(lambda t: calls.append(t + 1), torch.zeros(2), reps=3)
    assert prog.graph is None and prog.launches == {} and calls == []
    prog()
    prog.replay()
    assert len(calls) == 6 and all(torch.equal(c, torch.ones(2))
                                   for c in calls)


def test_executed_launches_add_replays_and_drop_captures():
    """The copy harness at one R: 34 eager calls and 34 captured (the
    wrapper counts 68), five replays of each of its two graphs (5 + 29
    launches each) run 170 more: 204 executed."""
    cs.reset_launch_counts()
    pg.reset_program_counts()
    try:
        cs.LAUNCHES["probe_copy"] = 68
        pg.CAPTURED["probe_copy"] = 34
        pg.REPLAYED["probe_copy"] = 5 * (5 + 29)
        ran = pg.executed_launches()
        assert ran["probe_copy"] == 204 and set(ran) == set(cs.LAUNCHES)
        assert sum(ran.values()) == 204
    finally:
        cs.reset_launch_counts()
        pg.reset_program_counts()


def test_pad_x():
    x = torch.arange(5, dtype=torch.float32)
    assert tsp.pad_x(x).shape == (128,) and float(tsp.pad_x(x)[5:].abs().max()) == 0
    assert tsp.pad_x(torch.ones(256)).shape == (256,)
    assert tsp.pad_x(x, 1024).shape == (1024,)


_REPORT = re.compile(r"^(.{30}) +([0-9.]+) ms +([0-9.]+) GB/s effective$")


def test_stencil_main_on_cpu(small, capsys):
    out = tsa.main(["-device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    names = [f"{name} R={r}" for name, _, rs in tsa.VARIANTS for r in rs]
    assert len(lines) == len(out) == len(names) == 15
    for line, name, (n, r, dt) in zip(lines, names, out):
        m = _REPORT.match(line)
        assert m and m.group(1).strip() == name == f"{n} R={r}", line
        assert dt > 0 and float(m.group(3)) > 0


def test_spmv_main_on_cpu(capsys):
    out = tsp.main(["2048", "2", "-device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    tags = [f"{t}_br{br}" for br in tsp.BLOCK_ROWS for t, _, _ in tsp.VARIANTS]
    assert [json.loads(ln) for ln in lines] == out
    assert [o["variant"] for o in out] == tags
    for o in out:
        assert set(o) == {"variant", "nnz_per_s", "gb_s", "us_per_spmv"}
        assert o["us_per_spmv"] > 0
        assert o["gb_s"] == pytest.approx(o["nnz_per_s"] * 8e-9)


def test_mains_refuse_cuda_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((tsa.main, []), (tsp.main, ["256", "1"])):
        with pytest.raises(SystemExit) as exc:
            main(argv)
        assert exc.value.code == 1
    assert "-device cpu" in capsys.readouterr().err
