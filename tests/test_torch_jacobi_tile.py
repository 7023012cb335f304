"""The tile decomposition of the fused Jacobi smoother's kernel of
``csrc/stencil2d.cu`` (``jacobi_fused_kernel<S>``), emulated in plain torch
on the CPU and held to the kernel's twin ``jacobi_plain``.

The emulation reads its geometry from ``ops/cuda_stencil.jacobi_tile`` and
its groups from ``ops/cuda_stencil._groups``, the values the CUDA wrapper
hands the kernel.  Each block loads its halo box of u and of b (a core plus
one ring of halo per sweep; cells outside the array load as 0 and count as
boundary cells) and runs sweep k out of place, from one buffer into the
other, on its rows k .. rows-1-k only (every column: the edge columns read
neighbours from outside the tile, as the kernel's lanes do).  As in the
kernel, ``b * (1/c)`` is formed once per cell, a boundary cell takes b in
the first sweep and keeps its value after that, and the last sweep's core
rows are stitched into the result.  Equal to the twin bit for bit on
padded, exact and ragged shapes at 0-11 sweeps and omega 0.8 / 1, it shows
that the halo the kernel gets is enough; with one ring of row halo less it
is not.  The card holds the kernel to the same twin and to the per-sweep
kernel in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multigrid_prj_tpu_torch.kernels import _build
from multigrid_prj_tpu_torch.ops import cuda_stencil as cs

torch.set_num_threads(1)

ALPHA = 10.0
# (physical, logical or None): padded non-square, an exact odd layout, and
# one whose extents are no multiple of any core
SHAPES = [((256, 384), (201, 329)), ((129, 129), None), ((150, 250), None)]


def _inputs(shape, logical, seed):
    rng = np.random.default_rng(seed)
    u, b = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for _ in range(2))
    h = 10.0 / ((logical or shape)[0] - 1)
    return u, b, h


def _tiles(a, hr, hc, ch, cw, nty, ntx, rows, cols):
    n, m = a.shape
    pad = (hc, ntx * cw + hc - m, hr, nty * ch + hr - n)
    return F.pad(a, pad).unfold(0, rows, ch).unfold(1, cols, cw)


def _launch(u, b, c, omega, sweeps, logical, ring_short=0):
    """One launch of ``sweeps`` sweeps: every block at once, as a batch of
    tiles (``ring_short`` rings fewer of row halo)."""
    n, m = u.shape
    nl, ml = logical or (n, m)
    hr, hc, rows, cols = cs.jacobi_tile(sweeps)
    hr -= ring_short
    ch, cw = rows - 2 * hr, cols - 2 * hc
    nty, ntx = -(-n // ch), -(-m // cw)
    gi = (torch.arange(nty) * ch - hr)[:, None, None, None] \
        + torch.arange(rows)[None, None, :, None]
    gj = (torch.arange(ntx) * cw - hc)[None, :, None, None] \
        + torch.arange(cols)[None, None, None, :]
    bnd = (gi <= 0) | (gi >= nl - 1) | (gj <= 0) | (gj >= ml - 1)
    r = torch.arange(rows)[None, None, :, None]
    geo = (hr, hc, ch, cw, nty, ntx, rows, cols)
    bt = _tiles(b, *geo)
    bc = bt * (1.0 / c)  # once per cell, in the first sweep
    buf = [_tiles(u, *geo).clone(), bt.clone()]
    for k in range(1, sweeps + 1):
        x = buf[(k - 1) & 1]
        north, south = torch.roll(x, 1, 2), torch.roll(x, -1, 2)
        east, west = torch.roll(x, -1, 3), torch.roll(x, 1, 3)
        jac = (bc + north + south + east + west) * 0.25
        if omega != 1.0:
            jac = (1.0 - omega) * x + omega * jac
        y = torch.where(bnd, bt if k == 1 else x, jac)
        rk = (r >= k) & (r <= rows - 1 - k)
        buf[k & 1] = torch.where(rk, y, buf[k & 1])
    core = buf[sweeps & 1][:, :, hr:hr + ch, hc:hc + cw]
    return core.permute(0, 2, 1, 3).reshape(nty * ch, ntx * cw)[:n, :m]


def emulate_jacobi(u, b, alpha, h, omega, sweeps, logical=None,
                   ring_short=0):
    """The smoother's launches as tiles: one group of <= 8 sweeps per
    launch, out of place (``sweeps == 0``: a copy)."""
    x = u.clone() if sweeps < 1 else u
    for s in cs._groups(sweeps, cs._MAX_FUSED_JACOBI):
        x = _launch(x, b, alpha / (h * h), omega, s, logical, ring_short)
    return x


@pytest.mark.parametrize("shape,logical", SHAPES)
@pytest.mark.parametrize("omega", [0.8, 1.0])
@pytest.mark.parametrize("sweeps", range(12))
def test_jacobi_tiles_equal_twin(shape, logical, omega, sweeps):
    """0-11 sweeps (9-11: launches of 8 + 1 .. 3) on the row-walking tiles
    equal the twin bit for bit."""
    u, b, h = _inputs(shape, logical, seed=sweeps)
    got = emulate_jacobi(u, b, ALPHA, h, omega, sweeps, logical)
    want = cs.jacobi_plain(u, b, ALPHA, h, omega, sweeps, logical)
    assert torch.isfinite(want).all()
    assert torch.equal(got, want)


@pytest.mark.parametrize("sweeps", [1, 2, 5, 8])
def test_one_ring_less_is_not_enough(sweeps):
    """With a row halo of sweeps - 1 the stale ring reaches the core: the
    emulation then differs from the twin, so the tests above have teeth."""
    shape, logical = SHAPES[0]
    u, b, h = _inputs(shape, logical, seed=20)
    got = emulate_jacobi(u, b, ALPHA, h, 0.8, sweeps, logical, ring_short=1)
    want = cs.jacobi_plain(u, b, ALPHA, h, 0.8, sweeps, logical)
    assert not torch.equal(got, want)


def test_tile_geometry_and_the_c_source_agree():
    """The geometry the wrapper passes is the one the CUDA source compiles
    (the C entry point refuses others): one ring of halo per sweep, the
    column halo rounded up to 4, 128 columns by 64 rows; sweeps run in
    groups of at most 8 (11 -> 8 + 3); a warp owns 8 rows.  It is the apply
    chain's tile."""
    assert cs.jacobi_tile(2) == (2, 4, 64, 128)  # V(2,2)
    assert cs.jacobi_tile(8) == (8, 8, 64, 128)
    for s in range(1, 9):
        hr, hc, rows, cols = cs.jacobi_tile(s)
        assert hr == s and hc % 4 == 0 and s <= hc < s + 4
        assert (cols - 2 * hc) % 4 == 0 and rows - 2 * hr > 0
        assert 2 * rows * cols * 4 <= 227 * 1024 // 3  # 3 blocks per SM
        assert cs.jacobi_tile(s) == cs.apply_tile(s)
    assert cs._groups(11, cs._MAX_FUSED_JACOBI) == [8, 3]
    assert cs._groups(0, cs._MAX_FUSED_JACOBI) == []
    for s in (0, 9):
        with pytest.raises(ValueError, match="1 .. 8 sweeps"):
            cs.jacobi_tile(s)
    src = _build.SOURCES[0].read_text()
    assert f"constexpr int kApRows = {cs._AP_TILE_ROWS};" in src
    assert f"constexpr int kApCols = {cs._AP_TILE_COLS};" in src
    assert "constexpr int kJacStrip = kApRows / kApWarps;" in src
    assert "constexpr int kApWarps = kApThreads / 32;" in src
    assert "using T = ApTile<S>;" in src


@pytest.mark.parametrize("sweeps", [0, 3, 11])
def test_cpu_wrapper_runs_the_twin_and_launches_nothing(sweeps):
    """On the CPU the smoother runs its twin: ``u`` stays as it was and no
    kernel is counted; the per-sweep oracle launches CUDA kernels only."""
    shape, logical = SHAPES[0]
    u, b, h = _inputs(shape, logical, seed=30)
    u0 = u.clone()
    cs.reset_launch_counts()
    got = cs.jacobi(u, b, ALPHA, h, omega=0.8, sweeps=sweeps,
                    logical_shape=logical)
    assert all(v == 0 for v in cs.LAUNCHES.values())
    assert torch.equal(u, u0)
    assert torch.equal(got, cs.jacobi_plain(u, b, ALPHA, h, 0.8, sweeps,
                                            logical))
    with pytest.raises(ValueError, match="CUDA kernels only"):
        cs._jacobi_per_sweep(u, b, ALPHA, h, 0.8, sweeps, logical)

