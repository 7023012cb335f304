"""The tile decomposition of the apply chain's kernel of
``csrc/stencil2d.cu`` (``apply_chain_kernel<A>``), emulated in plain torch
on the CPU and held to the kernel's twin ``poisson_apply_chain_plain``.

The emulation reads its geometry from ``ops/cuda_stencil.apply_tile`` and
its groups from ``ops/cuda_stencil._groups``, the values the CUDA wrapper
hands the kernel.  Each block loads its halo box (a core plus one ring of
halo per apply; cells outside the array load as 0 and count as boundary
cells) into the first of two buffers and runs apply k out of place, from
one buffer into the other, on its rows k .. rows-1-k only (every column:
the edge columns read neighbours from outside the tile, as the kernel's
lanes do: that ring is stale after the first apply anyway); the last apply
covers exactly the core rows, which are stitched into the result.  Equal to
the twin bit for bit on padded, exact and ragged shapes at 0-11 applies, it
shows that the halo the kernel gets is enough; with one ring of row halo
less it is not.  The card holds the kernel to the same twin, to single
applies and to the 48 x 48 tile it replaced in ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multigrid_prj_tpu_torch.kernels import _build
from multigrid_prj_tpu_torch.ops import cuda_stencil as cs

torch.set_num_threads(1)

# (physical, logical or None): padded non-square, an exact odd layout, and
# one whose extents are no multiple of any core
SHAPES = [((256, 384), (201, 329)), ((129, 129), None), ((150, 250), None)]


def _inputs(shape, logical, seed):
    rng = np.random.default_rng(seed)
    u = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    h = 10.0 / ((logical or shape)[0] - 1)
    return u, h


def _launch(u, c, applies, logical, ring_short=0):
    """One launch of ``applies`` applies: every block at once, as a batch
    of tiles (``ring_short`` rings fewer of row halo)."""
    n, m = u.shape
    nl, ml = logical or (n, m)
    hr, hc, rows, cols = cs.apply_tile(applies)
    hr -= ring_short
    ch, cw = rows - 2 * hr, cols - 2 * hc
    nty, ntx = -(-n // ch), -(-m // cw)
    gi = (torch.arange(nty) * ch - hr)[:, None, None, None] \
        + torch.arange(rows)[None, None, :, None]
    gj = (torch.arange(ntx) * cw - hc)[None, :, None, None] \
        + torch.arange(cols)[None, None, None, :]
    bnd = (gi <= 0) | (gi >= nl - 1) | (gj <= 0) | (gj >= ml - 1)
    r = torch.arange(rows)[None, None, :, None]
    pad = (hc, ntx * cw + hc - m, hr, nty * ch + hr - n)
    tiles = F.pad(u, pad).unfold(0, rows, ch).unfold(1, cols, cw)
    buf = [tiles.clone(), torch.zeros_like(tiles)]
    for k in range(1, applies + 1):
        x = buf[(k - 1) & 1]
        north, south = torch.roll(x, 1, 2), torch.roll(x, -1, 2)
        east, west = torch.roll(x, -1, 3), torch.roll(x, 1, 3)
        y = torch.where(bnd, x, c * (4.0 * x - north - south - east - west))
        rk = (r >= k) & (r <= rows - 1 - k)
        buf[k & 1] = torch.where(rk, y, buf[k & 1])
    core = buf[applies & 1][:, :, hr:hr + ch, hc:hc + cw]
    return core.permute(0, 2, 1, 3).reshape(nty * ch, ntx * cw)[:n, :m]


def emulate_chain(u, alpha, h, applies, logical=None, ring_short=0):
    """The chain's launches as tiles: one group of <= 8 applies per launch,
    out of place (``applies == 0``: a copy)."""
    x = u.clone() if applies < 1 else u
    for s in cs._groups(applies, cs._MAX_FUSED_APPLIES):
        x = _launch(x, alpha / (h * h), s, logical, ring_short)
    return x


@pytest.mark.parametrize("shape,logical", SHAPES)
@pytest.mark.parametrize("applies", range(12))
def test_apply_tiles_equal_twin(shape, logical, applies):
    """0-11 applies (11: launches of 8 + 3) on the row-walking tiles equal
    the twin bit for bit; alpha = h^2 (c = 1) keeps 11 applies finite."""
    u, h = _inputs(shape, logical, seed=applies)
    got = emulate_chain(u, h * h, h, applies, logical)
    want = cs.poisson_apply_chain_plain(u, h * h, h, applies, logical)
    assert torch.isfinite(want).all()
    assert torch.equal(got, want)


@pytest.mark.parametrize("applies", [1, 2, 5, 8])
def test_one_ring_less_is_not_enough(applies):
    """With a row halo of applies - 1 the stale ring reaches the core: the
    emulation then differs from the twin, so the tests above have teeth."""
    shape, logical = SHAPES[0]
    u, h = _inputs(shape, logical, seed=20)
    got = emulate_chain(u, h * h, h, applies, logical, ring_short=1)
    want = cs.poisson_apply_chain_plain(u, h * h, h, applies, logical)
    assert not torch.equal(got, want)


def test_tile_geometry_and_the_c_source_agree():
    """The geometry the wrapper passes is the one the CUDA source compiles
    (the C entry point refuses others): one ring of halo per apply, the
    column halo rounded up to 4, 128 columns by 64 rows; applies run in
    groups of at most 8 (11 -> 8 + 3)."""
    assert cs.apply_tile(8) == (8, 8, 64, 128)  # bench.py's A^8 u
    assert cs.apply_tile(1) == (1, 4, 64, 128)
    for a in range(1, 9):
        hr, hc, rows, cols = cs.apply_tile(a)
        assert hr == a and hc % 4 == 0 and a <= hc < a + 4
        assert (cols - 2 * hc) % 4 == 0 and rows - 2 * hr > 0
        assert 2 * rows * cols * 4 <= 227 * 1024  # two buffers
    assert cs._groups(11, cs._MAX_FUSED_APPLIES) == [8, 3]
    assert cs._groups(0, cs._MAX_FUSED_APPLIES) == []
    for a in (0, 9):
        with pytest.raises(ValueError, match="1 .. 8 applies"):
            cs.apply_tile(a)
    src = _build.SOURCES[0].read_text()
    assert f"constexpr int kApRows = {cs._AP_TILE_ROWS};" in src
    assert f"constexpr int kApCols = {cs._AP_TILE_COLS};" in src
    assert "static constexpr int HC = (A + 3) & ~3;" in src


@pytest.mark.parametrize("applies", [0, 3, 11])
def test_cpu_wrapper_runs_the_twin_and_launches_nothing(applies):
    """On the CPU the chain runs its twin: ``u`` stays as it was, the
    result is a new tensor and no kernel is counted."""
    shape, logical = SHAPES[0]
    u, h = _inputs(shape, logical, seed=30)
    u0 = u.clone()
    cs.reset_launch_counts()
    got = cs.poisson_apply_chain(u, h * h, h, applies, logical)
    assert all(v == 0 for v in cs.LAUNCHES.values())
    assert torch.equal(u, u0) and got.data_ptr() != u.data_ptr()
    assert torch.equal(got, cs.poisson_apply_chain_plain(u, h * h, h,
                                                         applies, logical))


def test_tile_rows_probe_needs_the_card(monkeypatch, capsys):
    """The tile-height probe (``benchmarks/apply_tile_rows.py``) builds and
    times CUDA kernels only: without a card it exits non-zero, builds
    nothing and names the reason."""
    from multigrid_prj_tpu_torch.benchmarks import apply_tile_rows as probe

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert probe.main(["96"]) == 1
    assert "needs a CUDA device" in capsys.readouterr().err
    assert probe._ANCHOR in probe._build.SOURCES[0].read_text()
