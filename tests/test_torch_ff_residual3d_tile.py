"""The z-chunked march of the 3D float-float residual kernel of
``csrc/stencil3d.cu`` (``ff_residual3d_march_kernel``), emulated in plain
torch on the CPU and held to its twin ``ops/extended.ff_poisson_residual``
bit for bit.

The emulation reads its geometry from ``ops/cuda_stencil_3d.
ff_residual3d_tile``, the values the CUDA wrapper hands the kernel: every
block (an x-y tile of the array and a chunk of planes) starts from the pair
``(u_hi, u_lo)`` at the plane before its chunk (its own column only, 0
before plane 0), and walks the chunk's planes as a block does: plane z of
each half of the pair as a copy of the tile with a one-cell ring (cells
outside the array are 0), the column's pair at z - 1 carried from the step
before, its pair at z + 1 from the copies of the next plane (0 past the
array), ``d_hi``, ``d_lo`` and ``b`` at the column's own point.  Equal to
the twin on odd, padded and non-cubic shapes, with chunks that divide nz
and chunks that do not, it shows that the planes a chunk reads beyond its
own are the ones it needs; with the plane beyond each chunk dropped it
differs.  The card holds the kernel to the same twin in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multigrid_prj_tpu_torch import gmg as tgmg
from multigrid_prj_tpu_torch.kernels import _build
from multigrid_prj_tpu_torch.ops import cuda_stencil as cs
from multigrid_prj_tpu_torch.ops import cuda_stencil_3d as c3
from multigrid_prj_tpu_torch.ops import extended as ext

torch.set_num_threads(1)

ALPHA = 10.0
# (physical, logical or None, chunk or None for the wrapper's): config 4's
# 17^3 bottom, a padded non-cubic shape, one whose x-y extents are no
# multiple of the tile, one with a chunk that does not divide nz, and one
# whose own chunk (2) does not divide its 131 planes
CASES = [((17, 17, 17), None, None), ((20, 24, 136), (17, 21, 129), None),
         ((19, 53, 101), None, None), ((19, 23, 41), None, 4),
         ((131, 40, 40), None, None)]


def _inputs(shape, logical, seed):
    """A pair ``u`` whose low half is ~1e-8 of its high half, and ``d``
    the pair of ``b / c``, as a refined solve carries them."""
    rng = np.random.default_rng(seed)
    u_hi, u_lo, b = (torch.from_numpy(rng.standard_normal(shape)
                                      .astype(np.float32)) for _ in range(3))
    u_lo = u_lo * 1e-8
    h = 1.0 / ((logical or shape)[0] - 1)
    d_hi, d_lo = ext.ff_from_div(b, ALPHA / (h * h))
    return u_hi, u_lo, d_hi, d_lo, b, h


def emulate_march(u_hi, u_lo, d_hi, d_lo, b, alpha, h, logical=None,
                  chunk=None, drop_beyond=False, e=None, drop_e_ring=False):
    """One launch of the march: every x-y tile at once, chunk after chunk
    (``chunk`` overrides the wrapper's; ``drop_beyond`` reads 0 for the
    plane just past each chunk).  With ``e``, the fused kernel's
    (``ff_update_residual3d_march_kernel``): each plane copy of the pair is
    updated with the copy of ``e`` beside it, ring cells included
    (``drop_e_ring`` reads 0 for ``e`` there), the column's pair at z0 - 1
    with ``e`` there; returns the updated pair and r."""
    nz, ny, nx = u_hi.shape
    nzl, nyl, nxl = logical or u_hi.shape
    tx, ty, zc, _ahead = c3.ff_residual3d_tile(u_hi.shape)
    zc = chunk or zc
    nty, ntx = -(-ny // ty), -(-nx // tx)
    gy = (torch.arange(nty) * ty)[:, None, None, None] \
        + torch.arange(ty)[None, None, :, None]
    gx = (torch.arange(ntx) * tx)[None, :, None, None] \
        + torch.arange(tx)[None, None, None, :]
    yx_in = (gy > 0) & (gy < nyl - 1) & (gx > 0) & (gx < nxl - 1)
    pad = (1, ntx * tx + 1 - nx, 1, nty * ty + 1 - ny)
    c = alpha / (h * h)

    def copy(x, z):  # plane z as (nty, ntx, ty + 2, tx + 2) tiles, a ring
        return F.pad(x[z], pad).unfold(0, ty + 2, ty).unfold(1, tx + 2, tx)

    def tiles(x):  # (ny, nx) -> (nty, ntx, ty, tx), zeros past the array
        return F.pad(x, (0, ntx * tx - nx, 0, nty * ty - ny)) \
            .unfold(0, ty, ty).unfold(1, tx, tx)

    def pair(z):  # the plane copies of the pair, updated with e's
        ph, pl = copy(u_hi, z), copy(u_lo, z)
        if e is None:
            return ph, pl
        pe = copy(e, z)
        if drop_e_ring:
            pe = F.pad(pe[:, :, 1:-1, 1:-1], (1, 1, 1, 1))
        return ext.ff_add_f(ph, pl, pe)

    def untile(t):  # (nty, ntx, ty, tx) -> (ny, nx)
        return t.permute(0, 2, 1, 3).reshape(nty * ty, ntx * tx)[:ny, :nx]

    r = torch.empty_like(u_hi)
    hi2, lo2 = torch.empty_like(u_hi), torch.empty_like(u_hi)
    zero = torch.zeros((nty, ntx, ty, tx))
    for z0 in range(0, nz, zc):
        z1 = min(z0 + zc, nz)
        zn = ((tiles(u_hi[z0 - 1]), tiles(u_lo[z0 - 1])) if z0 > 0
              else (zero, zero))
        if e is not None and z0 > 0:
            zn = ext.ff_add_f(*zn, tiles(e[z0 - 1]))
        uc = tuple(x[:, :, 1:-1, 1:-1] for x in pair(z0))
        for z in range(z0, z1):
            ph, pl = pair(z)
            if z + 1 >= nz or (z + 1 == z1 and drop_beyond):
                zs = (zero, zero)
            else:
                zs = tuple(x[:, :, 1:-1, 1:-1] for x in pair(z + 1))
            acc = ext.ff_add(4.0 * uc[0], 4.0 * uc[1], 2.0 * uc[0],
                             2.0 * uc[1])
            for nb in (zs, zn,
                       (ph[:, :, 2:, 1:-1], pl[:, :, 2:, 1:-1]),    # y + 1
                       (ph[:, :, :-2, 1:-1], pl[:, :, :-2, 1:-1]),  # y - 1
                       (ph[:, :, 1:-1, 2:], pl[:, :, 1:-1, 2:]),    # x + 1
                       (ph[:, :, 1:-1, :-2], pl[:, :, 1:-1, :-2])):  # x - 1
                acc = ext.ff_add(*acc, -nb[0], -nb[1])
            t_hi, t_lo = ext.ff_add(tiles(d_hi[z]), tiles(d_lo[z]), -acc[0],
                                    -acc[1])
            inside = yx_in & (0 < z < nzl - 1)
            rt = torch.where(inside, c * t_hi + c * t_lo,
                             (tiles(b[z]) - uc[0]) - uc[1])
            r[z], hi2[z], lo2[z] = untile(rt), untile(uc[0]), untile(uc[1])
            zn, uc = uc, zs
    return r if e is None else (hi2, lo2, r)


@pytest.mark.parametrize("drop_beyond", [False, True])
@pytest.mark.parametrize("shape,logical,chunk", CASES)
def test_march_equals_twin(shape, logical, chunk, drop_beyond):
    """The march equals the twin bit for bit, the chunk dividing nz or
    leaving a short last chunk; with the plane beyond each chunk read as 0
    the points at each chunk's last plane differ (where there is more than
    one chunk): the equality has teeth."""
    u_hi, u_lo, d_hi, d_lo, b, h = _inputs(shape, logical, seed=sum(shape))
    got = emulate_march(u_hi, u_lo, d_hi, d_lo, b, ALPHA, h, logical, chunk,
                        drop_beyond)
    want = ext.ff_poisson_residual(u_hi, u_lo, d_hi, d_lo, b, ALPHA, h,
                                   logical)
    zc = chunk or c3.ff_residual3d_tile(shape)[2]
    assert torch.equal(got, want) != (drop_beyond and zc < shape[0])


def _correction(shape, seed):
    """A correction ``e`` of a refined iteration's size against a unit
    ``u``: ~1e-3, so the two-sum's error term is live."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            * np.float32(1e-3))


@pytest.mark.parametrize("drop_e_ring", [False, True])
@pytest.mark.parametrize("shape,logical,chunk", CASES)
def test_fused_march_equals_twin(shape, logical, chunk, drop_e_ring):
    """The fused update-and-residual march equals its twin (the pair update,
    then the residual of the updated pair) bit for bit in the updated pair
    and in r, on the same shapes and chunks; with ``e`` read as 0 on each
    plane copy's ring, the points beside a tile's edge read neighbours that
    missed their update, and r differs: the ring of ``e`` is needed."""
    u_hi, u_lo, d_hi, d_lo, b, h = _inputs(shape, logical, seed=sum(shape))
    e = _correction(shape, seed=len(shape) + sum(shape))
    got = emulate_march(u_hi, u_lo, d_hi, d_lo, b, ALPHA, h, logical, chunk,
                        e=e, drop_e_ring=drop_e_ring)
    want = ext.ff_update_residual(u_hi, u_lo, e, d_hi, d_lo, b, ALPHA, h,
                                  logical)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[2], want[2]) != drop_e_ring


def test_geometry_and_the_c_source_agree():
    """The tile, the planes in flight and the chunk rule the wrapper passes
    are the ones the CUDA source compiles (its entry point refuses others):
    the residual march's tile and chunk, its own depth; the ring's slots
    stay 16-byte aligned and within a block's shared memory."""
    src = _build.SOURCES[1].read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)
                   .group(1))

    assert const("kF3Ahead") == c3._F3_AHEAD == 2
    assert (const("kR3X"), const("kR3Y")) == c3._R3_TILE
    for n in (513, 257, 129, 65):
        shape = (n, n, n)
        assert c3.ff_residual3d_tile(shape) \
            == (*c3.residual3d_tile(shape)[:3], 2)
    tx, ty = c3._R3_TILE
    slot = 2 * (tx + 2) * (ty + 2) + 3 * tx * ty
    assert slot % 4 == 0
    assert (c3._F3_AHEAD + 2) * slot * 4 <= 227 * 1024
    # the fused kernel's slot adds a ring copy of e: its 4 slots (2 planes
    # in flight) still fit four 512-thread blocks in an SM's 228 KB, 1 KB
    # reserved per block
    fused = (c3._F3_AHEAD + 2) * (slot + (tx + 2) * (ty + 2)) * 4
    assert fused == 56256 and 4 * (fused + 1024) <= 228 * 1024
    assert "constexpr int kU3Slot = 3 * kR3Plane + 3 * kR3Threads;" in src
    assert "__global__ void __launch_bounds__(kR3Threads)\n" \
        "    ff_update_residual3d_march_kernel(" in src
    fused_launch = src[src.index("int ff_update_residual3d_launch("):]
    assert "residual3d_chunk(nz, ny, nx)" in fused_launch[:700]
    assert "geom[3] != kF3Ahead" in fused_launch[:900]
    # the launcher checks the residual's tile and chunk rule
    launch = src[src.index("int ff_residual3d_launch("):]
    assert "residual3d_chunk(nz, ny, nx)" in launch[:400]
    assert "__global__ void __launch_bounds__(kR3Threads)\n" \
        "    ff_residual3d_march_kernel(" in src


def test_cpu_wrapper_runs_the_twin_and_launches_nothing():
    """On the CPU the wrapper runs the twin: no kernel is counted."""
    shape, logical, _ = CASES[1]
    args = _inputs(shape, logical, seed=3)
    cs.reset_launch_counts()
    got = c3.ff_poisson_residual_3d(*args[:5], ALPHA, args[5], logical)
    assert all(v == 0 for v in cs.LAUNCHES.values())
    assert "ff_residual3d" in cs.LAUNCHES
    assert torch.equal(got, ext.ff_poisson_residual(*args[:5], ALPHA,
                                                    args[5], logical))


@pytest.mark.parametrize("dtype,calls", [(torch.float32, True),
                                         (torch.float64, False)])
def test_3d_refined_solve_calls_the_kernel_route_in_f32_only(dtype, calls):
    """A 3D refined solve in f32 takes the kernel route's residual for its
    first residual and the fused update-and-residual at every iteration
    after it (1 and ``iterations`` calls); in f64, which the kernels do not
    take, it runs the plain functions and calls neither."""
    s = tgmg.GMGSolver(shape=(9, 9, 9), num_levels=2, length=1.0, alpha=1.0,
                       tol=1e-6, maxit=20, device="cpu", use_pallas=True)
    seen, fused = [], []

    def spy(*a):
        seen.append(a[0].dtype)
        return c3.ff_poisson_residual_3d(*a)

    def fused_spy(*a, **kw):
        fused.append(a[0].dtype)
        return c3.ff_update_residual_3d(*a, **kw)

    s._f32_route = s._f32_route._replace(ff_residual=spy,
                                         ff_update_residual=fused_spy)
    b = torch.ones((9, 9, 9), dtype=dtype)
    out = s.solve_refined(b)
    assert out.converged and out.iterations > 1
    assert len(seen) == (1 if calls else 0)
    assert fused == ([torch.float32] * out.iterations if calls else [])


FUSED_WRAPPERS = [((20, 24, 136), (17, 21, 129), c3.ff_update_residual_3d,
                   "ff_update_residual3d"),
                  ((40, 72), (33, 65), cs.ff_update_residual,
                   "ff_update_residual")]


@pytest.mark.parametrize("shape,logical,fn,key", FUSED_WRAPPERS)
def test_cpu_fused_wrappers_run_the_twin_and_launch_nothing(shape, logical,
                                                            fn, key):
    """On the CPU the fused wrappers run the twin, with and without output
    buffers, and count no launch."""
    u_hi, u_lo, d_hi, d_lo, b, h = _inputs(shape, logical, seed=5)
    e = _correction(shape, seed=6)
    args = (u_hi, u_lo, e, d_hi, d_lo, b, ALPHA, h, logical)
    want = ext.ff_update_residual(*args)
    cs.reset_launch_counts()
    for out in (None, (torch.empty_like(u_hi), torch.empty_like(u_hi))):
        got = fn(*args, out=out)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert key in cs.LAUNCHES
    assert all(v == 0 for v in cs.LAUNCHES.values())


@pytest.mark.parametrize("shape,logical,fn,key", FUSED_WRAPPERS)
def test_fused_wrappers_refuse_outputs_that_alias_inputs(shape, logical, fn,
                                                         key):
    """The updated pair goes out of place: an output buffer that is, or
    overlaps, an input or the other output is refused before any work."""
    u_hi, u_lo, d_hi, d_lo, b, h = _inputs(shape, logical, seed=7)
    e = _correction(shape, seed=8)
    args = (u_hi, u_lo, e, d_hi, d_lo, b, ALPHA, h, logical)
    free = torch.empty_like(u_hi)
    both = torch.empty((2, *shape))
    for out in ((u_hi, free), (free, u_lo), (e, free), (free, b),
                (free, d_lo), (free, free), (both.view(-1)[1:].view(-1)[
                    :u_hi.numel()].view(shape), both[1])):
        with pytest.raises(ValueError, match="overlaps"):
            fn(*args, out=out)
    fn(*args, out=(both[0], both[1]))  # adjacent, not overlapping


@pytest.mark.parametrize("shape,extra", [
    ((17, 17, 17), dict(length=1.0, alpha=1.0)),
    ((65, 65), dict(pad_align=128)),
    ((33, 33), dict(smoother="jacobi", omega=0.8))])
@pytest.mark.parametrize("inner_cg", [0, 2])
def test_cpu_refined_solve_unchanged_by_the_fused_route(shape, extra,
                                                        inner_cg):
    """A CPU refined solve on the kernel route (the twins) gives the same
    history and solution bit for bit with the kernel wrappers' fused update
    and residual as with the plain route's ``ff_update_residual`` (the
    update and the residual in turn), its iterations swapping two pairs of
    buffers."""
    kw = dict(shape=shape, num_levels=3, cycle="v", nu=2, tol=1e-8,
              maxit=40, device="cpu", use_pallas=True, **extra)
    runs = []
    for fused in (True, False):
        s = tgmg.GMGSolver(**kw)
        route = s._route(torch.float32)
        assert route.ff_update_residual in (cs.ff_update_residual,
                                            c3.ff_update_residual_3d)
        if not fused:
            s._f32_route = route._replace(
                ff_update_residual=ext.ff_update_residual)
        g = torch.Generator().manual_seed(11)
        b = torch.rand(shape, generator=g)
        runs.append(s.solve_refined(b, inner_cg=inner_cg))
    (a, b2) = runs
    assert a.converged and a.iterations == b2.iterations > 1
    np.testing.assert_array_equal(a.history, b2.history)
    assert torch.equal(a.u, b2.u)
