"""The z-chunked march of the 3D residual kernel of ``csrc/stencil3d.cu``
(``residual3d_march_kernel``), emulated in plain torch on the CPU and held
to the kernel's twin ``poisson_residual_3d_plain`` bit for bit.

The emulation reads its geometry from ``ops/cuda_stencil_3d.
residual3d_tile``, the values the CUDA wrapper hands the kernel: every
block (an x-y tile of the array and a chunk of planes) starts from u at
the plane before its chunk (its own column only, 0 before plane 0), and
walks the chunk's planes as a block does: plane z as a copy of the tile
with a one-cell ring (cells outside the array are 0), the column's u at
z - 1 carried from the step before, its u at z + 1 from the copy of the
next plane (0 past the array).  Equal to the twin on odd, padded and
non-cubic shapes, with chunks that divide nz and chunks that do not, it
shows that the planes a chunk reads beyond its own are the ones it needs;
with those two planes dropped it differs.  The card holds the kernel to the
same twin and to the one-thread-per-point kernel it replaced in
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

torch.set_num_threads(1)

ALPHA = 10.0
# (physical, logical or None, chunk or None for the wrapper's):
# config 4's 17^3 bottom, a padded non-cubic shape, an unpadded one whose
# x-y extents are no multiple of the tile, with a chunk that does not divide
# nz, and one whose own chunk (2) does not divide its 131 planes
CASES = [((17, 17, 17), None, None), ((20, 24, 136), (17, 21, 129), None),
         ((19, 23, 41), None, 4), ((19, 23, 41), None, None),
         ((131, 40, 40), None, None)]


def _inputs(shape, logical, seed):
    rng = np.random.default_rng(seed)
    u, b = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for _ in range(2))
    h = 1.0 / ((logical or shape)[0] - 1)
    return u, b, h


def emulate_march(u, b, alpha, h, logical=None, chunk=None,
                  drop_outer=False):
    """One launch of the march: every x-y tile at once, chunk after chunk
    (``chunk`` overrides the wrapper's; ``drop_outer`` reads 0 for the
    planes just outside each chunk)."""
    nz, ny, nx = u.shape
    nzl, nyl, nxl = logical or u.shape
    tx, ty, zc, _ahead = c3.residual3d_tile(u.shape)
    zc = chunk or zc
    nty, ntx = -(-ny // ty), -(-nx // tx)
    gy = (torch.arange(nty) * ty)[:, None, None, None] \
        + torch.arange(ty)[None, None, :, None]
    gx = (torch.arange(ntx) * tx)[None, :, None, None] \
        + torch.arange(tx)[None, None, None, :]
    yx_in = (gy > 0) & (gy < nyl - 1) & (gx > 0) & (gx < nxl - 1)
    pad = (1, ntx * tx + 1 - nx, 1, nty * ty + 1 - ny)
    c = alpha / (h * h)

    def copy(z):  # plane z as (nty, ntx, ty + 2, tx + 2) tiles with a ring
        return F.pad(u[z], pad).unfold(0, ty + 2, ty).unfold(1, tx + 2, tx)

    def tiles(x):  # (ny, nx) -> (nty, ntx, ty, tx), zeros past the array
        return F.pad(x, (0, ntx * tx - nx, 0, nty * ty - ny)) \
            .unfold(0, ty, ty).unfold(1, tx, tx)

    r = torch.empty_like(u)
    for z0 in range(0, nz, zc):
        z1 = min(z0 + zc, nz)
        outer = torch.zeros((nty, ntx, ty, tx))
        zn = tiles(u[z0 - 1]) if z0 > 0 and not drop_outer else outer
        uc = copy(z0)[:, :, 1:-1, 1:-1]
        for z in range(z0, z1):
            p = copy(z)
            if z + 1 >= nz or (z + 1 == z1 and drop_outer):
                zs = outer
            else:
                zs = copy(z + 1)[:, :, 1:-1, 1:-1]
            nb = (p[:, :, :-2, 1:-1] + p[:, :, 2:, 1:-1]
                  + p[:, :, 1:-1, 2:] + p[:, :, 1:-1, :-2] + zn + zs)
            inside = yx_in & (0 < z < nzl - 1)
            a = torch.where(inside, c * (6.0 * uc - nb), uc)
            rt = tiles(b[z]) - a
            r[z] = rt.permute(0, 2, 1, 3).reshape(nty * ty,
                                                  ntx * tx)[:ny, :nx]
            zn, uc = uc, zs
    return r


@pytest.mark.parametrize("shape,logical,chunk", CASES)
def test_march_equals_twin(shape, logical, chunk):
    """The march equals the twin bit for bit; the chunk either divides nz
    or leaves a short last chunk."""
    u, b, h = _inputs(shape, logical, seed=sum(shape))
    got = emulate_march(u, b, ALPHA, h, logical, chunk)
    want = c3.poisson_residual_3d_plain(u, b, ALPHA, h, logical)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape,logical,chunk",
                         [CASES[1], CASES[2], CASES[4]])
def test_dropping_the_outer_planes_fails(shape, logical, chunk):
    """With the planes just before and after each chunk read as 0, the
    points at the chunk's first and last planes differ from the twin: the
    tests above have teeth."""
    u, b, h = _inputs(shape, logical, seed=7)
    zc = chunk or c3.residual3d_tile(shape)[2]
    assert zc < shape[0]  # more than one chunk
    got = emulate_march(u, b, ALPHA, h, logical, chunk, drop_outer=True)
    want = c3.poisson_residual_3d_plain(u, b, ALPHA, h, logical)
    assert not torch.equal(got, want)


@pytest.mark.parametrize("shape,zc,blocks", [
    ((513, 513, 513), 32, 9945), ((257, 257, 257), 32, 1485),
    ((129, 129, 129), 13, 510), ((65, 65, 65), 3, 396),
    ((33, 33, 33), 1, 165), ((17, 17, 17), 1, 51),
    ((264, 264, 384), 32, 1782), ((72, 72, 128), 3, 432)])
def test_chunk_rule_keeps_every_sm_busy(shape, zc, blocks):
    """The chunk of each level of the 3D paths, and the blocks of 512
    threads it launches: at least 3 per SM of an H100 (132 SMs, 4 blocks
    resident on each) down to 65^3; a chunk costs 2 / zc of re-read
    planes."""
    nz, ny, nx = shape
    tx, ty, got, ahead = c3.residual3d_tile(shape)
    assert (tx, ty, ahead) == (64, 8, 4) and got == zc
    assert -(-nx // tx) * -(-ny // ty) * -(-nz // zc) == blocks


def test_geometry_and_the_c_source_agree():
    """The tile, the planes in flight and the chunk rule the wrapper passes
    are the ones the CUDA source compiles (its entry point refuses
    others)."""
    src = _build.SOURCES[1].read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)
                   .group(1))

    assert (const("kR3X"), const("kR3Y")) == c3._R3_TILE
    assert const("kR3Ahead") == c3._R3_AHEAD
    assert const("kR3MaxChunk") == c3._R3_MAX_CHUNK
    assert const("kR3TargetBlocks") == c3._R3_TARGET_BLOCKS
    # slots: the plane computed, the next one and those in flight, with b
    tx, ty = c3._R3_TILE
    assert (c3._R3_AHEAD + 2) * ((tx + 2) * (ty + 2) + tx * ty) * 4 \
        <= 48 * 1024


def test_cpu_wrapper_runs_the_twin_and_launches_nothing():
    """On the CPU the residual runs its twin: no kernel is counted."""
    shape, logical, _ = CASES[1]
    u, b, h = _inputs(shape, logical, seed=3)
    cs.reset_launch_counts()
    got = cs.poisson_residual(u, b, ALPHA, h, logical)
    assert all(v == 0 for v in cs.LAUNCHES.values())
    assert torch.equal(got, c3.poisson_residual_3d_plain(u, b, ALPHA, h,
                                                         logical))


def test_march_probe_needs_the_card(monkeypatch, capsys):
    """The march's depth and tile-height probe
    (``benchmarks/residual3d_march_probe.py``) builds and times CUDA
    kernels only: without a card it exits non-zero, builds nothing and
    names the reason."""
    from multigrid_prj_tpu_torch.benchmarks import residual3d_march_probe \
        as probe

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert probe.main(["4:8"]) == 1
    assert "needs a CUDA device" in capsys.readouterr().err
    src = probe._build.SOURCES[1].read_text()
    assert all(anchor in src for anchor in probe._ANCHORS)
