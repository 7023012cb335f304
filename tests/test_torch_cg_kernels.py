"""The CG step's kernels (``csrc/krylov.cu`` through ``ops/cuda_krylov.py``)
and how ``ops/krylov.cg_arrays`` takes them, on the CPU.

* the wrappers run their twins on a CPU tensor, which are the plain ops of
  ``cg_arrays`` as it was (``x + alpha * p``, ``r - alpha * Ap``,
  ``torch.vdot``, ``z + (rz1 / rz) * p``) bit for bit, and launch nothing;
* the routes: the plain route keeps those plain steps and a solve on it
  launches nothing; the kernel route takes the wrappers in 2D and 3D;
* ``cg_arrays`` with steps that write in place, as the kernels do on the
  card (emulated here with ``out=``), gives the plain steps' answer bit for
  bit and writes neither the caller's ``x0`` nor ``b``; so does an
  ``inner_cg`` refined solve with them in its route;
* the stop test, the history and ``rel`` read the ``r . r`` that the step
  returns; ``x_owned`` is False at the first step only;
* the C source: its kernels are port kernels to ``portbench/trace.py``,
  its constants are the wrapper's, its entry points have as many arguments
  as their ctypes signatures; the grid rule.

The card holds the kernels to the twins in ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.
"""

import re

import numpy as np
import pytest
import torch

from multigrid_prj_tpu_torch.gmg import GMGSolver
from multigrid_prj_tpu_torch.kernels import _build
from multigrid_prj_tpu_torch.models.poisson import assemble_rhs
from multigrid_prj_tpu_torch.ops import cuda_krylov as ck
from multigrid_prj_tpu_torch.ops import cuda_stencil as cs
from multigrid_prj_tpu_torch.ops import krylov as kr
from multigrid_prj_tpu_torch.ops import routes
from multigrid_prj_tpu_torch.ops.stencil import boundary_mask
from portbench import trace

torch.set_num_threads(1)

SHAPES = [(64, 96), (9, 10, 11), (1001,), (3,)]
KERNELS = ("cg_xr_update_kernel", "cg_rr_sum_kernel", "cg_p_update_kernel")
SOURCE = _build.SOURCES[3]


def _vectors(shape, seed, count):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for _ in range(count)]


def _scalar(value):
    return torch.tensor(value, dtype=torch.float32)


@pytest.mark.parametrize("x_owned", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_xr_twin_is_the_plain_step(shape, x_owned):
    x, r, p, Ap = _vectors(shape, 1, 4)
    alpha = _scalar(0.37)
    kept = [t.clone() for t in (x, r, p, Ap)]
    cs.reset_launch_counts()
    gx, gr, grr = ck.cg_xr_update(x, r, p, Ap, alpha, x_owned)
    assert sum(cs.LAUNCHES.values()) == 0
    want_x = x + alpha * p
    want_r = r - alpha * Ap
    assert torch.equal(gx, want_x) and torch.equal(gr, want_r)
    assert torch.equal(grr, torch.vdot(want_r.reshape(-1),
                                       want_r.reshape(-1)).real)
    assert grr.shape == () and grr.dtype == torch.float32
    for t, k in zip((x, r, p, Ap), kept):
        assert torch.equal(t, k)  # the twin writes new tensors


@pytest.mark.parametrize("shape", SHAPES)
def test_p_twin_is_the_plain_step(shape):
    z, p = _vectors(shape, 2, 2)
    rz1, rz = _scalar(0.61), _scalar(1.7)
    kept = p.clone()
    cs.reset_launch_counts()
    got = ck.cg_p_update(z, p, rz1, rz)
    assert sum(cs.LAUNCHES.values()) == 0
    assert torch.equal(got, z + (rz1 / rz) * p)
    assert torch.equal(p, kept)


def test_routes_take_the_steps_by_route():
    plain = routes.plain_route("gs", 1.0)
    assert plain.cg_xr_update is kr.cg_xr_step
    assert plain.cg_p_update is kr.cg_p_step
    for ndim in (2, 3):
        k = routes.kernel_route(ndim, "gs", 1.0, False, 1.0)
        assert k.cg_xr_update is ck.cg_xr_update
        assert k.cg_p_update is ck.cg_p_update
    assert {"cg_xr_update", "cg_rr_sum", "cg_p_update"} <= set(cs.LAUNCHES)


def _solver(**kw):
    return GMGSolver(device="cpu", shape=(65, 65), num_levels=3, cycle="v",
                     tol=1e-7, maxit=40, pad_align=128, **kw)


def _rhs(solver):
    return assemble_rhs(solver.levels[0], solver.length, test=1,
                        dtype=torch.float32, device="cpu")


def test_plain_route_inner_cg_launches_nothing():
    s = _solver(use_pallas=False)
    assert s._f32_route is s._plain_route
    cs.reset_launch_counts()
    res = s.solve_refined(_rhs(s), inner_cg=4)
    assert res.converged
    assert sum(cs.LAUNCHES.values()) == 0


def _inplace_xr(calls):
    """The kernel's contract on the CPU: ``r`` written in place, ``x`` when
    owned, else into a new buffer; the same roundings as the plain step."""
    def step(x, r, p, Ap, alpha, x_owned):
        calls.append(x_owned)
        x_out = x if x_owned else torch.empty_like(x)
        torch.add(x, alpha * p, out=x_out)
        torch.sub(r, alpha * Ap, out=r)
        return x_out, r, kr._dot(r, r).real

    return step


def _inplace_p(z, p, rz1, rz):
    torch.add(z, (rz1 / rz) * p, out=p)
    return p


@pytest.mark.parametrize("history", [False, True])
def test_cg_arrays_in_place_steps_equal_plain_and_spare_the_caller(history):
    s = _solver(use_pallas=True)
    b = s._padded(_rhs(s))
    # CG on the zero-boundary subspace, as the inner_cg correction runs it
    bmask = boundary_mask(b.shape, s._logical0, b.device)
    b = b.masked_fill(bmask, 0.0)
    h0 = s.levels[0].h

    def A(v):
        return s._route(torch.float32).apply(v, s.alpha, h0, s._logical0)

    def M(v):
        return s._error_cycle(v)

    x0 = (1e-3 * _vectors(b.shape, 5, 1)[0]).masked_fill(bmask, 0.0)
    kept_x0, kept_b = x0.clone(), b.clone()
    want = kr.cg_arrays(A, b, x0=x0, tol=1e-6, maxit=6, M=M, history=history)
    calls = []
    got = kr.cg_arrays(A, b, x0=x0, tol=1e-6, maxit=6, M=M, history=history,
                       xr_step=_inplace_xr(calls), p_step=_inplace_p)
    assert torch.equal(x0, kept_x0) and torch.equal(b, kept_b)
    assert got[1] == want[1] > 1
    assert calls == [False] + [True] * (got[1] - 1)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[2], want[2])
    k = got[1]
    assert torch.equal(got[3][: k + 1], want[3][: k + 1])


def test_stop_test_history_and_rel_read_the_steps_norm():
    """A step that reports ``r . r`` as 0 ends the loop after one step,
    writes 0 into the history and returns ``rel`` 0, whatever ``r`` is."""
    b = _vectors((32,), 6, 1)[0]
    A = lambda v: 2.0 * v

    def xr(x, r, p, Ap, alpha, x_owned):
        x, r, _ = kr.cg_xr_step(x, r, p, Ap, alpha, x_owned)
        return x, r, torch.zeros((), dtype=torch.float32)

    x, k, rel, hist = kr.cg_arrays(A, b, tol=1e-30, maxit=5, history=True,
                                   xr_step=xr)
    assert k == 1 and float(rel) == 0.0
    assert float(hist[0]) == pytest.approx(1.0) and float(hist[1]) == 0.0


@pytest.mark.parametrize("dims", [2, 3])
def test_inner_cg_solve_with_in_place_steps_is_bit_equal(dims):
    kw = (dict(shape=(65, 65), num_levels=3, pad_align=128) if dims == 2
          else dict(shape=(17, 17, 17), num_levels=2, length=1.0,
                    alpha=1.0))
    base = dict(device="cpu", cycle="v", tol=1e-7, maxit=40,
                use_pallas=True, **kw)
    s = GMGSolver(**base)
    b = (_rhs(s) if dims == 2 else 1e-2 * _vectors(s.levels[0].shape, 7,
                                                     1)[0])
    want = s.solve_refined(b, inner_cg=4)
    calls = []
    t = GMGSolver(**base)
    t._f32_route = t._f32_route._replace(cg_xr_update=_inplace_xr(calls),
                                         cg_p_update=_inplace_p)
    got = t.solve_refined(b, inner_cg=4)
    assert got.iterations == want.iterations >= 2
    assert calls == [False, True, True, True] * got.iterations
    np.testing.assert_array_equal(got.history, want.history)
    assert torch.equal(got.u, want.u)


def test_trace_counts_the_kernels_as_port_kernels():
    names = trace.port_kernel_names()
    assert set(KERNELS) <= names
    for k in KERNELS:
        assert trace.is_port_kernel(f"void {k}(float const*, int)", names)


def test_the_c_source_and_the_wrapper_agree():
    src = SOURCE.read_text()
    assert SOURCE.name == "krylov.cu"

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)
                   .group(1))

    assert const("kThreads") == ck._THREADS
    assert const("kBlocksPerSm") == ck._BLOCKS_PER_SM
    for name in ("mg_cg_xr_update", "mg_cg_p_update"):
        decl = re.search(rf"int {name}\(([^)]*)\)", src).group(1)
        assert decl.count(",") + 1 == len(_build._SIGNATURES[name]), name
    # the norm's reduction takes no atomics: the same value every run
    assert not re.search(r"\batomic\w*\s*\(", src)


@pytest.mark.parametrize("n,vec,blocks", [
    (8448 * 8448, True, 1056), (257 ** 3, True, 1056), (1001, True, 1),
    (1001, False, 4), (3, True, 1), (1, False, 1), (300_000, True, 293)])
def test_grid_is_one_resident_wave_at_most(monkeypatch, n, vec, blocks):
    monkeypatch.setattr(ck, "_max_blocks", lambda index: 8 * 132)
    assert ck._grid(torch.empty(n), vec) == blocks


def test_checks_refuse_what_the_kernels_do_not_take():
    v, w = _vectors((8, 8), 8, 2)
    assert ck._check("t", (v, w), (_scalar(1.0),))
    assert not ck._check("t", (v.reshape(-1)[1:], w.reshape(-1)[1:]), ())
    with pytest.raises(ValueError, match="shape"):
        ck._check("t", (v, w[:4]), ())
    with pytest.raises(ValueError, match="float32"):
        ck._check("t", (v, w.double()), ())
    with pytest.raises(ValueError, match="contiguous"):
        ck._check("t", (v, w.t()), ())
    with pytest.raises(ValueError, match="elements"):
        ck._check("t", (v, w), (torch.ones(2),))
