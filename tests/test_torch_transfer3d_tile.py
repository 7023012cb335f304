"""The marches of the 3D exact-layout grid transfers of ``csrc/stencil3d.cu``
(``restrict_fw3d_kernel``, ``prolong_add3d_kernel``), emulated in plain
torch on the CPU and held bit for bit to the kernels' twins
``transfer.restrict_full_weighting`` and ``u + transfer.prolong(e,
u.shape)``.

The emulations read their geometry from ``ops/cuda_stencil_3d.
restrict3d_tile`` and ``prolong3d_tile``, the values the CUDA wrappers hand
the kernels, and walk every x-y tile at once, chunk after chunk, as a block
does:

* the restriction: a tile of coarse (y, x) points reads its fine window
  (``2 * rows + 1`` by ``2 * columns + 1`` cells from fine row and column
  ``2 * y0 - 1`` and ``2 * x0 - 1``, 0 outside the array), filters z at
  each step from fine planes ``2K - 1`` (carried from the step before, or
  read once at the chunk's start), ``2K`` and ``2K + 1``, then y, then x;
* the prolong-add: a tile of fine (y, x) columns reads e's window
  (``rows / 2 + 1`` by ``columns / 2 + 1`` coarse cells) at coarse planes
  i and i + 1 (the plane after the chunk included), refines z, y and x at
  each column's corners, adds u, and emits fine planes 2i and 2i + 1.

Equal to the twins on the four levels of the 3D cell (257^3 .. 33^3) and on
odd, even and mixed shapes, with one chunk and with many; with the carried
plane at a chunk's start, or the plane after a chunk, read as 0 they
differ.  The card holds the kernels to the same twins in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multigrid_prj_tpu_torch.kernels import _build
from multigrid_prj_tpu_torch.ops import cuda_stencil as cs
from multigrid_prj_tpu_torch.ops import cuda_stencil_3d as c3
from multigrid_prj_tpu_torch.ops import routes
from multigrid_prj_tpu_torch.ops import transfer as tr

torch.set_num_threads(1)

# the exact levels of the 3D cell (config 4: 257^3, 5 levels), odd / even /
# mixed shapes, the smallest one, and shapes whose chunk does not divide
# their coarse planes
SHAPES = [(257, 257, 257), (129, 129, 129), (65, 65, 65), (33, 33, 33),
          (9, 10, 11), (17, 33, 8), (3, 3, 3), (40, 70, 9), (72, 30, 130)]
# shapes with more than one chunk and chunks that start inside the grid
MULTI_CHUNK = [(65, 65, 65), (129, 129, 129), (17, 33, 8), (40, 70, 9)]


def _array(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _fw(lo, mid, hi):
    return 0.25 * lo + 0.5 * mid + 0.25 * hi


def _mid(a, b):
    return 0.5 * (a + b)


def emulate_restrict(r, carry=True):
    """One launch of the restriction's march (``carry`` False reads the
    plane before each chunk as 0)."""
    nz, ny, nx = r.shape
    ncz, ncy, ncx = ((n + 1) // 2 for n in r.shape)
    tx, ty, zc = c3.restrict3d_tile(r.shape)
    ntx, nty = -(-ncx // tx), -(-ncy // ty)
    cy = (torch.arange(nty) * ty)[:, None, None, None] \
        + torch.arange(ty)[None, None, :, None]
    cx = (torch.arange(ntx) * tx)[None, :, None, None] \
        + torch.arange(tx)[None, None, None, :]
    zeros = torch.zeros((nty, ntx, 2 * ty + 1, 2 * tx + 1))

    def window(p):  # fine plane p as the tiles' windows, 0 outside
        if p >= nz:
            return zeros
        pad = F.pad(r[p], (1, 2 * tx * ntx - nx, 1, 2 * ty * nty - ny))
        return pad.unfold(0, 2 * ty + 1, 2 * ty).unfold(1, 2 * tx + 1, 2 * tx)

    out = torch.empty((ncz, nty * ty, ntx * tx))
    for k0 in range(0, ncz, zc):
        lo = window(2 * k0 - 1) if k0 > 0 and carry else zeros
        for k in range(k0, min(k0 + zc, ncz)):
            a, c = window(2 * k), window(2 * k + 1)
            if k == 0:
                z = a
            elif k == ncz - 1:
                z = a if nz % 2 else zeros
            else:
                z = _fw(lo, a, c)
            lo = c
            ym = z[:, :, 1:2 * ty:2]
            y_last = ym if ny % 2 else torch.zeros_like(ym)
            yf = torch.where(
                cy == 0, ym,
                torch.where(cy == ncy - 1, y_last,
                            _fw(z[:, :, 0:2 * ty:2], ym,
                                z[:, :, 2:2 * ty + 1:2])))
            xm = yf[..., 1:2 * tx:2]
            x_last = xm if nx % 2 else torch.zeros_like(xm)
            v = torch.where(
                cx == 0, xm,
                torch.where(cx == ncx - 1, x_last,
                            _fw(yf[..., 0:2 * tx:2], xm,
                                yf[..., 2:2 * tx + 1:2])))
            out[k] = v.permute(0, 2, 1, 3).reshape(nty * ty, ntx * tx)
    return out[:, :ncy, :ncx]


def emulate_prolong(e, u, after_chunk=True):
    """One launch of the prolong-add's march (``after_chunk`` False reads
    e's plane after each chunk as 0)."""
    nz, ny, nx = u.shape
    ncz, ncy, ncx = e.shape
    tx, ty, zc, _ahead = c3.prolong3d_tile(u.shape)
    ntx, nty = -(-nx // tx), -(-ny // ty)
    hx, hy = tx // 2, ty // 2
    zeros = torch.zeros((nty, ntx, hy + 1, hx + 1))

    def window(p):  # coarse plane p as the tiles' windows, 0 outside
        pad = F.pad(e[p], (0, hx * ntx + 1 - ncx, 0, hy * nty + 1 - ncy))
        return pad.unfold(0, hy + 1, hy).unfold(1, hx + 1, hx)

    def tiles(x):  # a fine plane as (nty, ntx, ty, tx) tiles
        pad = F.pad(x, (0, tx * ntx - nx, 0, ty * nty - ny))
        return pad.unfold(0, ty, ty).unfold(1, tx, tx)

    ly, lx = torch.arange(ty), torch.arange(tx)
    ypair = ((ly % 2 == 1)[None, None, :, None]
             & ((torch.arange(nty) * hy)[:, None, None, None]
                + (ly // 2)[None, None, :, None] + 1 < ncy))
    xpair = ((lx % 2 == 1)[None, None, None, :]
             & ((torch.arange(ntx) * hx)[None, :, None, None]
                + (lx // 2)[None, None, None, :] + 1 < ncx))

    def corner(w, dy, dx):  # (nty, ntx, ty, tx): each column's corner
        return w[:, :, (ly // 2 + dy)[:, None], (lx // 2 + dx)[None, :]]

    out = torch.empty((nz, nty * ty, ntx * tx))
    for i0 in range(0, ncz, zc):
        i1 = min(i0 + zc, ncz)
        for i in range(i0, i1):
            e0 = window(i)
            pair = i + 1 < ncz
            e1 = (window(i + 1) if pair and (i + 1 < i1 or after_chunk)
                  else zeros)
            for h in (0, 1):
                if 2 * i + h >= nz:
                    continue
                w = _mid(e0, e1) if h and pair else e0
                z00, z01 = corner(w, 0, 0), corner(w, 0, 1)
                y0 = torch.where(ypair, _mid(z00, corner(w, 1, 0)), z00)
                y1 = torch.where(ypair, _mid(z01, corner(w, 1, 1)), z01)
                v = torch.where(xpair, _mid(y0, y1), y0)
                out[2 * i + h] = (tiles(u[2 * i + h]) + v).permute(
                    0, 2, 1, 3).reshape(nty * ty, ntx * tx)
    return out[:, :ny, :nx]


def _coarse(shape):
    return tuple((n + 1) // 2 for n in shape)


@pytest.mark.parametrize("shape", SHAPES)
def test_restrict_march_equals_twin(shape):
    """The restriction's march equals ``restrict_full_weighting`` bit for
    bit: injected edges, the zeroed fake high edge of an even axis, and
    chunks that divide the coarse planes or leave a short last one."""
    r = _array(shape, seed=sum(shape))
    want = tr.restrict_full_weighting(r)
    assert tuple(want.shape) == _coarse(shape)
    assert torch.equal(emulate_restrict(r), want)


@pytest.mark.parametrize("shape", MULTI_CHUNK)
def test_restrict_without_the_carried_plane_fails(shape):
    """With the fine plane before each chunk read as 0 (one carried plane
    less), the chunks' first coarse planes differ: the tests above have
    teeth."""
    assert c3.restrict3d_tile(shape)[2] < _coarse(shape)[0] - 1
    r = _array(shape, seed=5)
    assert not torch.equal(emulate_restrict(r, carry=False),
                           tr.restrict_full_weighting(r))


@pytest.mark.parametrize("shape", SHAPES)
def test_prolong_march_equals_twin(shape):
    """The prolong-add's march equals ``u + prolong(e, u.shape)`` bit for
    bit on odd (2 nc - 1) and even (2 nc, the last node repeated) axes."""
    u = _array(shape, seed=sum(shape) + 1)
    e = _array(_coarse(shape), seed=sum(shape) + 2)
    want = c3.prolong_add3d_plain(e, u)
    assert torch.equal(want, u + tr.prolong(e, u.shape))
    assert torch.equal(emulate_prolong(e, u), want)


@pytest.mark.parametrize("shape", MULTI_CHUNK)
def test_prolong_without_the_plane_after_the_chunk_fails(shape):
    """With e's plane after each chunk read as 0 (one carried plane less),
    the chunks' last odd fine planes differ."""
    assert c3.prolong3d_tile(shape)[2] < _coarse(shape)[0] - 1
    u = _array(shape, seed=6)
    e = _array(_coarse(shape), seed=7)
    assert not torch.equal(emulate_prolong(e, u, after_chunk=False),
                           c3.prolong_add3d_plain(e, u))


@pytest.mark.parametrize("shape,rz,rblocks,pz,pblocks", [
    ((257, 257, 257), 8, 1445, 8, 2805), ((129, 129, 129), 4, 459, 7, 510),
    ((65, 65, 65), 1, 330, 2, 306), ((33, 33, 33), 1, 51, 1, 85),
    ((513, 513, 513), 8, 9801, 8, 19305)])
def test_chunk_rule_keeps_every_sm_busy(shape, rz, rblocks, pz, pblocks):
    """The chunk of each level of the 3D paths and the blocks it launches:
    the restriction's 256-thread blocks at least 2 per SM of an H100 (132
    SMs) down to 65^3, the prolong-add's 512-thread ones likewise; a chunk
    re-reads one fine plane of 2 zc + 1 (one coarse plane of zc + 1)."""
    ncz, ncy, ncx = _coarse(shape)
    tx, ty, zc = c3.restrict3d_tile(shape)
    assert (tx, ty, zc) == (32, 8, rz)
    assert -(-ncx // tx) * -(-ncy // ty) * -(-ncz // zc) == rblocks
    tx, ty, zc, ahead = c3.prolong3d_tile(shape)
    assert (tx, ty, zc, ahead) == (64, 8, pz, 3)
    assert -(-shape[2] // tx) * -(-shape[1] // ty) * -(-ncz // zc) == pblocks


def test_geometry_and_the_c_source_agree():
    """The tiles, the planes in flight and the chunk rule the wrappers pass
    are the ones the CUDA source compiles (its entry points refuse
    others), and the prolong-add's ring fits static shared memory."""
    src = _build.SOURCES[1].read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)
                   .group(1))

    assert (const("kT3CX"), const("kT3CY")) == c3._T3_TILE
    assert (const("kP3X"), const("kP3Y")) == c3._P3_TILE
    assert const("kP3Ahead") == c3._P3_AHEAD
    assert const("kX3MaxChunk") == c3._X3_MAX_CHUNK
    assert const("kX3TargetBlocks") == c3._X3_TARGET_BLOCKS
    tx, ty = c3._P3_TILE
    slot = (tx // 2 + 1) * (ty // 2 + 1) + 2 * tx * ty
    assert (c3._P3_AHEAD + 2) * slot * 4 <= 48 * 1024
    for name in ("mg_restrict_fw3d", "mg_prolong_add3d"):
        assert name in _build._SIGNATURES and f"int {name}(" in src


def test_cpu_wrappers_run_the_twins_and_launch_nothing():
    """On the CPU the wrappers run their twins: no kernel is counted."""
    u = _array((17, 33, 8), seed=11)
    e = _array((9, 17, 4), seed=12)
    cs.reset_launch_counts()
    got_r, got_p = c3.restrict_fw3d(u), c3.prolong_add3d(e, u)
    assert all(v == 0 for v in cs.LAUNCHES.values())
    assert {"restrict_fw3d", "prolong_add3d"} <= set(cs.LAUNCHES)
    assert torch.equal(got_r, tr.restrict_full_weighting(u))
    assert torch.equal(got_p, u + tr.prolong(e, u.shape))


def test_routes_choose_the_transfers_by_dimension():
    """The 3D kernel route takes the exact-layout transfer kernels; the
    plain route and the 2D kernel route keep the plain exact-layout
    transfers, and every route keeps its padded ones."""
    k3 = routes.kernel_route(3, "gs", 1.0, False, 1.0)
    assert k3.exact_restrict is c3.restrict_fw3d
    assert k3.exact_prolong_add is c3.prolong_add3d
    assert k3.padded_restrict is tr.restrict_fw_padded
    assert k3.prolong_add is None
    for route in (routes.plain_route("gs", 1.0),
                  routes.kernel_route(2, "gs", 1.0, True, 1.0)):
        assert route.exact_restrict is tr.restrict_full_weighting
        assert route.exact_prolong_add is tr.prolong_add


@pytest.mark.parametrize("pad_align,expected", [(None, 1), ((8, 8, 128), 0)])
def test_v_cycle_takes_the_route_transfers_at_exact_levels(pad_align,
                                                           expected):
    """A 3D refined solve on the CPU's kernel route calls the route's
    exact-layout restriction and prolong-add once per exact level and
    iteration, and none at padded levels; with the plain functions in their
    place the solve is the same bit for bit."""
    from multigrid_prj_tpu_torch.gmg import GMGSolver
    from multigrid_prj_tpu_torch.models.poisson import assemble_rhs

    kw = dict(shape=(17, 17, 17), length=1.0, alpha=1.0, num_levels=3,
              cycle="v", nu=2, tol=1e-6, maxit=20, pad_align=pad_align,
              device="cpu", use_pallas=True)
    calls = {"restrict": 0, "prolong_add": 0}
    s = GMGSolver(**kw)
    route = s._route(torch.float32)

    def restrict(r):
        calls["restrict"] += 1
        return route.exact_restrict(r)

    def prolong_add(e, u):
        calls["prolong_add"] += 1
        return route.exact_prolong_add(e, u)

    s._f32_route = route._replace(exact_restrict=restrict,
                                  exact_prolong_add=prolong_add)
    b = assemble_rhs(
        s.levels[0], 1.0, device="cpu",
        f=lambda x, y, z: torch.sin(3.0 * x) * torch.cos(2.0 * y) + z,
        g=lambda x, y, z: torch.exp(x) * torch.exp(-2.0 * y) * z)
    got = s.solve_refined(b)
    exact = sum(lev.padded_shape is None for lev in s.levels[:-1])
    assert exact == expected * (len(s.levels) - 1)
    assert calls == {"restrict": exact * got.iterations,
                     "prolong_add": exact * got.iterations}
    plain = GMGSolver(**kw)
    plain._f32_route = plain._f32_route._replace(
        exact_restrict=tr.restrict_full_weighting,
        exact_prolong_add=tr.prolong_add)
    want = plain.solve_refined(b)
    np.testing.assert_array_equal(got.history, want.history)
    assert torch.equal(got.u, want.u)
