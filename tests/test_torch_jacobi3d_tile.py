"""The two launch shapes of the 3D Jacobi smoother's kernels of
``csrc/stencil3d.cu``, emulated in plain torch on the CPU and held to the
kernels' twin ``jacobi_3d_plain`` bit for bit.

The z-chunked multi-sweep march (``jacobi3d_march_kernel<S>``): the
emulation reads its geometry from ``ops/cuda_stencil_3d.jacobi3d_tile`` and
its groups from ``ops/cuda_stencil._groups``, the values the CUDA wrapper
hands the kernel.  Every block (an x-y tile with a halo of S cells, and a
chunk of output planes) loads its input planes, S beyond each end of the
chunk (cells outside the array load as 0 and count as boundary cells),
and runs stage k (sweep k) out of place on the planes it needs, on the
cells at least k from the tile's edge only; a cell no stage wrote reads as
NaN, a plane a stage did not run as 0 (the kernel's register window).  As
in the kernel, ``b / c`` is divided once per cell, boundary cells take b,
and the last stage's core is stitched into the result.  Equal to the twin
on odd, padded and non-cubic shapes, with chunks that divide nz and chunks
that do not, at 0-9 sweeps (5-9: launches of 4 + 1 .. 4 + 4 + 1) and omega
0.8 / 1, it shows that the halo and the planes a chunk reads are enough;
with one ring of halo less, or one plane less at each end of the chunk, it
differs.

The grid-resident route (``jacobi3d_resident_kernel``): the array flat in
two ping-pong buffers and ``b / c``, neighbours at offsets +-1, +-nx and
+-nx ny, interior points from one mask, every sweep in one launch; equal to
the twin at the 17^3 bottom's 100 sweeps.  The card holds both kernels to
the same twin and to the per-sweep kernel they replaced in
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
from multigrid_prj_tpu_torch.ops.stencil import boundary_mask

torch.set_num_threads(1)

ALPHA = 10.0
# (physical, logical or None, chunk or None for the wrapper's): config 4's
# 17^3 bottom, a padded non-cubic shape, an unpadded one whose x-y extents
# are no multiple of the tile core, with a chunk that divides its 19 planes
# (1: every chunk reads planes beyond both ends) and one that does not (5),
# and one with many chunks of the wrapper's own length (4)
CASES = [((17, 17, 17), None, None), ((20, 24, 136), (17, 21, 129), None),
         ((19, 23, 41), None, 1), ((19, 23, 41), None, 5),
         ((131, 40, 40), None, None)]


def _inputs(shape, logical, seed):
    rng = np.random.default_rng(seed)
    u, b = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for _ in range(2))
    h = 1.0 / ((logical or shape)[0] - 1)
    return u, b, h


def _launch(u, b, c, omega, sweeps, logical, chunk, halo_short, z_short):
    """One launch of ``sweeps`` sweeps: every x-y tile at once, chunk after
    chunk (``halo_short`` rings of halo fewer, ``z_short`` input planes
    fewer beyond each end of a chunk)."""
    nz, ny, nx = u.shape
    nzl, nyl, nxl = logical or u.shape
    tx, ty, halo, zc, _ahead = c3.jacobi3d_tile(u.shape, sweeps)
    assert halo == sweeps
    zc = chunk or zc
    halo -= halo_short
    cw, ch = tx - 2 * halo, ty - 2 * halo
    nty, ntx = -(-ny // ch), -(-nx // cw)
    gy = (torch.arange(nty) * ch - halo)[:, None, None, None] \
        + torch.arange(ty)[None, None, :, None]
    gx = (torch.arange(ntx) * cw - halo)[None, :, None, None] \
        + torch.arange(tx)[None, None, None, :]
    yx_in = (gy > 0) & (gy < nyl - 1) & (gx > 0) & (gx < nxl - 1)
    r = torch.arange(ty)[:, None]
    q = torch.arange(tx)[None, :]
    dist = torch.minimum(torch.minimum(r, ty - 1 - r),
                         torch.minimum(q, tx - 1 - q))
    pad = (halo, ntx * cw + halo - nx, halo, nty * ch + halo - ny)

    def tiles(a):  # (nz, ny, nx) -> (nz, nty, ntx, ty, tx), zeros outside
        return F.pad(a, pad).unfold(1, ty, ch).unfold(2, tx, cw)

    ut, bt = tiles(u), tiles(b)
    bc = c3._b_over_c(bt, c)
    zz = torch.arange(nz)[:, None, None, None, None]
    bnd = ~(yx_in & (zz > 0) & (zz < nzl - 1))
    out = torch.empty_like(u)
    for z0 in range(0, nz, zc):
        z1 = min(z0 + zc, nz)
        lo0 = max(z0 - sweeps + z_short, 0)
        hi0 = min(z1 - 1 + sweeps - z_short, nz - 1)
        prev = torch.zeros_like(ut)  # planes not loaded read as 0
        prev[lo0:hi0 + 1] = ut[lo0:hi0 + 1]
        for k in range(1, sweeps + 1):
            lo = max(z0 - sweeps + k, 0)
            hi = min(z1 - 1 + sweeps - k, nz - 1)
            zr = torch.arange(lo, hi + 1)
            x = prev[zr]
            zn = prev[(zr - 1).clamp(min=0)]
            zs = prev[(zr + 1).clamp(max=nz - 1)]
            nb = (torch.roll(x, 1, 3) + torch.roll(x, -1, 3)
                  + torch.roll(x, -1, 4) + torch.roll(x, 1, 4) + zn + zs)
            jac = (bc[zr] + nb) * c3._INV6
            if omega != 1.0:
                jac = (1.0 - omega) * x + omega * jac
            v = torch.where(bnd[zr], bt[zr], jac)
            cur = torch.zeros_like(ut)  # planes the stage did not run: 0
            cur[zr] = torch.where(dist >= k, v, torch.nan)
            prev = cur
        core = prev[z0:z1, :, :, halo:halo + ch, halo:halo + cw]
        out[z0:z1] = core.permute(0, 1, 3, 2, 4).reshape(
            z1 - z0, nty * ch, ntx * cw)[:, :ny, :nx]
    return out


def emulate_march(u, b, alpha, h, omega, sweeps, logical=None, chunk=None,
                  halo_short=0, z_short=0):
    """The smoother's launches on the march: one group of <= 4 sweeps per
    launch, out of place (``sweeps == 0``: a copy)."""
    x = u.clone() if sweeps < 1 else u
    for s in cs._groups(sweeps, c3._MAX_FUSED_JACOBI3D):
        x = _launch(x, b, alpha / (h * h), omega, s, logical, chunk,
                    halo_short, z_short)
    return x


def emulate_resident(u, b, alpha, h, omega, sweeps, logical=None):
    """Every sweep as the resident kernel runs it: flat buffers, b / c at
    the interior points, b at the boundary, neighbours by offset."""
    nz, ny, nx = u.shape
    plane = ny * nx
    inner = ~boundary_mask(u.shape, logical).reshape(-1)
    idx = torch.nonzero(inner).reshape(-1)
    sbc = torch.where(inner, c3._b_over_c(b.reshape(-1), alpha / (h * h)),
                      b.reshape(-1))
    src = u.reshape(-1).clone()
    for _ in range(sweeps):
        nb = (src[idx - nx] + src[idx + nx] + src[idx + 1] + src[idx - 1]
              + src[idx - plane] + src[idx + plane])
        v = (sbc[idx] + nb) * c3._INV6
        if omega != 1.0:
            v = (1.0 - omega) * src[idx] + omega * v
        dst = sbc.clone()
        dst[idx] = v
        src = dst
    return src.reshape(u.shape)


@pytest.mark.parametrize("shape,logical,chunk", CASES)
@pytest.mark.parametrize("omega", [0.8, 1.0])
@pytest.mark.parametrize("sweeps", range(10))
def test_march_equals_twin(shape, logical, chunk, omega, sweeps):
    """0-9 sweeps (5-9: launches of 4 + 1 .. 4 + 4 + 1) on the march equal
    the twin bit for bit; the chunk divides nz or leaves a short last
    chunk."""
    u, b, h = _inputs(shape, logical, seed=sweeps + sum(shape))
    got = emulate_march(u, b, ALPHA, h, omega, sweeps, logical, chunk)
    want = c3.jacobi_3d_plain(u, b, ALPHA, h, omega, sweeps, logical)
    assert torch.isfinite(want).all()
    assert torch.equal(got, want)


@pytest.mark.parametrize("sweeps", [1, 2, 4])
@pytest.mark.parametrize("short", ["halo", "z"])
def test_one_short_is_not_enough(sweeps, short):
    """With one ring of x-y halo less, or one input plane less beyond each
    end of a chunk, the emulation differs from the twin: the tests above
    have teeth."""
    shape, logical, chunk = CASES[3]
    u, b, h = _inputs(shape, logical, seed=20)
    kw = {"halo_short": 1} if short == "halo" else {"z_short": 1}
    got = emulate_march(u, b, ALPHA, h, 0.8, sweeps, logical, chunk, **kw)
    want = c3.jacobi_3d_plain(u, b, ALPHA, h, 0.8, sweeps, logical)
    assert not torch.equal(got, want)


@pytest.mark.parametrize("shape,logical", [((17, 17, 17), None),
                                           ((18, 18, 32), (17, 17, 17))])
@pytest.mark.parametrize("omega", [0.8, 1.0])
def test_resident_route_equals_twin_at_the_bottom(shape, logical, omega):
    """The 17^3 bottom's 100 sweeps (and a padded 17^3) in one resident
    launch equal the twin bit for bit; both shapes take that route."""
    assert c3.jacobi3d_route(shape) == "resident"
    u, b, h = _inputs(shape, logical, seed=5)
    got = emulate_resident(u, b, ALPHA, h, omega, 100, logical)
    want = c3.jacobi_3d_plain(u, b, ALPHA, h, omega, 100, logical)
    assert torch.isfinite(want).all()
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape,sweeps,zc,blocks", [
    ((513, 513, 513), 2, 32, 3978), ((257, 257, 257), 2, 32, 585),
    ((129, 129, 129), 2, 6, 462), ((65, 65, 65), 2, 4, 136),
    ((33, 33, 33), 2, 4, 18), ((257, 257, 257), 4, 32, 765),
    ((257, 257, 257), 1, 30, 540), ((264, 264, 384), 2, 32, 882)])
def test_chunk_rule_keeps_every_sm_busy(shape, sweeps, zc, blocks):
    """The chunk of each level of the 3D paths and the blocks of 512
    threads it launches: at 257^3 and above at least ~4 per SM of an H100
    (132 SMs); a chunk re-reads 2 x sweeps planes."""
    nz, ny, nx = shape
    tx, ty, halo, got, ahead = c3.jacobi3d_tile(shape, sweeps)
    assert (tx, ty, halo, ahead) == (64, 24, sweeps, 3) and got == zc
    assert -(-nx // (tx - 2 * sweeps)) * -(-ny // (ty - 2 * sweeps)) \
        * -(-nz // zc) == blocks


def test_geometry_route_and_the_c_source_agree():
    """The tile, halo, planes in flight, chunk rule, sweeps per launch and
    resident cap the wrapper passes are the ones the CUDA source compiles
    (its entry points refuse others); the shared memory of every sweep
    count fits a block."""
    src = _build.SOURCES[1].read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)
                   .group(1))

    assert (const("kJ3W"), const("kJ3H")) == c3._J3_TILE
    assert const("kJ3Ahead") == c3._J3_AHEAD
    assert const("kJ3MinChunk") == c3._J3_MIN_CHUNK
    assert const("kJ3MaxChunk") == c3._J3_MAX_CHUNK
    assert const("kJ3TargetBlocks") == c3._J3_TARGET_BLOCKS
    assert const("kJ3MaxSweeps") == c3._MAX_FUSED_JACOBI3D
    assert const("kResidentMaxPoints") == c3.RESIDENT_MAX_POINTS
    tx, ty = c3._J3_TILE
    threads = const("kJ3Threads")
    assert threads % tx == 0 and ty % (threads // tx) == 0
    for s in range(1, c3._MAX_FUSED_JACOBI3D + 1):
        rings = (c3._J3_AHEAD + 2) + (c3._J3_AHEAD + 1) + 2 * (s - 1)
        assert rings * tx * ty * 4 <= 227 * 1024
    assert 3 * c3.RESIDENT_MAX_POINTS * 4 <= 227 * 1024
    assert c3.jacobi3d_route((17, 17, 17)) == "resident"
    assert c3.jacobi3d_route((33, 33, 33)) == "march"
    assert cs._groups(9, c3._MAX_FUSED_JACOBI3D) == [4, 4, 1]
    for s in (0, 5):
        with pytest.raises(ValueError, match="1 .. 4 sweeps"):
            c3.jacobi3d_tile((33, 33, 33), s)


@pytest.mark.parametrize("sweeps", [0, 3, 9])
def test_cpu_wrapper_runs_the_twin_and_launches_nothing(sweeps):
    """On the CPU the smoother runs its twin: ``u`` stays as it was and no
    kernel is counted; the per-sweep oracle launches CUDA kernels only."""
    shape, logical, _ = CASES[1]
    u, b, h = _inputs(shape, logical, seed=30)
    u0 = u.clone()
    cs.reset_launch_counts()
    got = cs.jacobi(u, b, ALPHA, h, omega=0.8, sweeps=sweeps,
                    logical_shape=logical)
    assert all(v == 0 for v in cs.LAUNCHES.values())
    assert torch.equal(u, u0)
    assert torch.equal(got, c3.jacobi_3d_plain(u, b, ALPHA, h, 0.8, sweeps,
                                               logical))
    with pytest.raises(ValueError, match="CUDA kernels only"):
        c3._jacobi3d_per_sweep(u, b, ALPHA, h, 0.8, sweeps, logical)


def test_tile_probe_needs_the_card(monkeypatch, capsys):
    """The march's tile probe (``benchmarks/jacobi3d_tile_probe.py``)
    builds and times CUDA kernels only: without a card it exits non-zero,
    builds nothing and names the reason; the constants it rewrites are in
    the source."""
    from multigrid_prj_tpu_torch.benchmarks import jacobi3d_tile_probe \
        as probe

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert probe.main(["64:24"]) == 1
    assert "needs a CUDA device" in capsys.readouterr().err
    src = probe._build.SOURCES[1].read_text()
    assert all(anchor in src for anchor in probe._ANCHORS)
