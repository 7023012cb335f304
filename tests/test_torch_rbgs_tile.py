"""The tile decomposition of the fused red-black kernels of
``csrc/stencil2d.cu`` (``rbgs_fused_kernel``, ``rbgs_resfilter_kernel``),
emulated in plain torch on the CPU and held to the kernels' twins.

The emulation reads its geometry from ``ops/cuda_stencil.rbgs_tile`` and
its sweep groups from ``ops/cuda_stencil._groups``, the values the CUDA
wrapper hands the kernels: cut the array into tiles of a core plus a halo of
one ring per dependent pass (cells outside the array load as 0 and count as
boundary cells), run pass k of the tile on its rows k .. rows-1-k (the edge
columns read neighbours from outside the tile, as the kernels' do: that
ring is stale after the first pass anyway), then stitch the cores (and, for
the down-leg, the coarse points whose fine point lies in a core).  Equal to the twins bit for bit on
odd, padded and ragged shapes, it shows that the halo the kernels get is
enough; with one ring less it is not.  The card holds each kernel to the
same twins in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from multigrid_prj_tpu_torch.ops import cuda_stencil as cs

torch.set_num_threads(1)

ALPHA = 10.0
# (physical, logical or None): padded (the 1025^2 path's 129^2 level), odd
# and unpadded, ragged in a non-square buffer, smaller than one tile
SMOOTHER_SHAPES = [((160, 160), (129, 129)), ((131, 253), None),
                   ((200, 380), (161, 333)), ((40, 40), (33, 33))]
# the down-leg needs even buffers
DOWNLEG_SHAPES = [((160, 160), (129, 129)), ((256, 384), (201, 329)),
                  ((200, 250), (161, 201))]


def _inputs(shape, logical, seed):
    rng = np.random.default_rng(seed)
    u, b = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for _ in range(2))
    h = 10.0 / ((logical or shape)[0] - 1)
    return u, b, h


def _tiles(n, m, geom):
    """(i0, j0) of every tile's cell (0, 0) for tiles of ``geom``."""
    hr, hc, rows, cols = geom
    ch, cw = rows - 2 * hr, cols - 2 * hc
    return [(by * ch - hr, bx * cw - hc) for by in range(-(-n // ch))
            for bx in range(-(-m // cw))]


def _load(x, i0, j0, rows, cols):
    """The tile of ``x`` at (i0, j0), zeros outside the array."""
    n, m = x.shape
    t = torch.zeros((rows, cols), dtype=x.dtype)
    r0, r1 = max(i0, 0), min(i0 + rows, n)
    c0, c1 = max(j0, 0), min(j0 + cols, m)
    if r1 > r0 and c1 > c0:
        t[r0 - i0:r1 - i0, c0 - j0:c1 - j0] = x[r0:r1, c0:c1]
    return t


def _neighbours(t):
    """(north, south, east, west); the wrapped edge values are only read at
    the tile's edge ring, which is stale after one pass."""
    return (torch.roll(t, 1, 0), torch.roll(t, -1, 0), torch.roll(t, -1, 1),
            torch.roll(t, 1, 1))


class _Tile:
    """One tile: its global indices, boundary cells and pass regions."""

    def __init__(self, i0, j0, geom, nl, ml):
        self.hr, self.hc, self.rows, self.cols = geom
        gi = torch.arange(self.rows)[:, None] + i0
        gj = torch.arange(self.cols)[None, :] + j0
        self.i0, self.j0 = i0, j0
        self.bnd = (gi <= 0) | (gi >= nl - 1) | (gj <= 0) | (gj >= ml - 1)
        self.parity = (gi + gj) & 1
        self.r = torch.arange(self.rows)[:, None]

    def region(self, k):
        """Pass k's cells: rows k .. rows-1-k."""
        return (self.r >= k) & (self.r <= self.rows - 1 - k)

    def colour_passes(self, tu, tb, inv_c, passes):
        for k in range(1, passes + 1):
            north, south, east, west = _neighbours(tu)
            gs = (tb * inv_c + north + south + east + west) * 0.25
            upd = self.region(k) & (self.parity == ((k - 1) & 1))
            tu = torch.where(upd, torch.where(self.bnd, tb, gs), tu)
        return tu

    def core(self, n, m):
        """(tile slice, array slice) of the core, cropped to the array."""
        ch, cw = self.rows - 2 * self.hr, self.cols - 2 * self.hc
        i, j = self.i0 + self.hr, self.j0 + self.hc
        ni, nj = min(ch, n - i), min(cw, m - j)
        return ((slice(self.hr, self.hr + ni), slice(self.hc, self.hc + nj)),
                (slice(i, i + ni), slice(j, j + nj)))


def emulate_smoother(u, b, alpha, h, sweeps, logical_shape=None,
                     ring_short=0):
    """The fused smoother's launches as tiles: one group of <= 4 sweeps per
    launch, each on tiles of ``rbgs_tile(2 * s)`` (``ring_short`` rings
    fewer of row halo, to show that the halo is tight)."""
    if sweeps < 1:
        return u.clone()
    n, m = u.shape
    nl, ml = logical_shape or (n, m)
    inv_c = 1.0 / (alpha / (h * h))
    x = u
    for s in cs._groups(sweeps):
        hr, hc, rows, cols = cs.rbgs_tile(2 * s)
        geom = (hr - ring_short, hc, rows, cols)
        out = torch.empty_like(x)
        for i0, j0 in _tiles(n, m, geom):
            t = _Tile(i0, j0, geom, nl, ml)
            tu = t.colour_passes(_load(x, i0, j0, rows, cols),
                                 _load(b, i0, j0, rows, cols), inv_c, 2 * s)
            src, dst = t.core(n, m)
            out[dst] = tu[src]
        x = out
    return x


def emulate_downleg(u, b, alpha, h, sweeps, logical_shape):
    """The down-leg launch as tiles of ``rbgs_tile(2 * sweeps + 2)``: the
    colour passes, the residual on rows 2 sweeps + 1 .., and the restriction
    of each coarse point whose fine point lies in the core."""
    n, m = u.shape
    nl, ml = logical_shape
    c = alpha / (h * h)
    geom = cs.rbgs_tile(2 * sweeps + 2)
    hr, hc, rows, cols = geom
    ch, cw = rows - 2 * hr, cols - 2 * hc
    nc_r, nc_c = (nl + 1) // 2, (ml + 1) // 2
    u2 = torch.empty_like(u)
    rc = torch.empty((n // 2, m // 2), dtype=u.dtype)
    for i0, j0 in _tiles(n, m, geom):
        t = _Tile(i0, j0, geom, nl, ml)
        tb = _load(b, i0, j0, rows, cols)
        tu = t.colour_passes(_load(u, i0, j0, rows, cols), tb, 1.0 / c,
                             2 * sweeps)
        north, south, east, west = _neighbours(tu)
        a = torch.where(t.bnd, tu, c * (4.0 * tu - north - south - east
                                        - west))
        tr = torch.where(t.region(2 * sweeps + 1), tb - a, tb)
        src, dst = t.core(n, m)
        u2[dst] = tu[src]
        # coarse (k, q) <- fine local (hr + 2 kk, hc + 2 qq)
        k0, q0 = (i0 + hr) // 2, (j0 + hc) // 2
        nk, nq = min(ch // 2, n // 2 - k0), min(cw // 2, m // 2 - q0)
        k = torch.arange(k0, k0 + nk)[:, None]
        q = torch.arange(q0, q0 + nq)[None, :]
        lr = hr + 2 * torch.arange(nk)[:, None]
        lc = hc + 2 * torch.arange(nq)[None, :]

        def rows_pass(col):
            up, mid, down = tr[lr - 1, col], tr[lr, col], tr[lr + 1, col]
            filt = (0.25 * up + 0.5 * mid) + 0.25 * down
            return torch.where((k == 0) | (k == nc_r - 1), mid, filt)

        ce = rows_pass(lc)
        west, east = rows_pass(lc - 1), rows_pass(lc + 1)
        filt = (0.25 * west + 0.5 * ce) + 0.25 * east
        out = torch.where((q == 0) | (q == nc_c - 1), ce, filt)
        rc[k0:k0 + nk, q0:q0 + nq] = torch.where(
            (k >= nc_r) | (q >= nc_c), torch.zeros((), dtype=rc.dtype), out)
    return u2, rc


@pytest.mark.parametrize("shape,logical", SMOOTHER_SHAPES)
@pytest.mark.parametrize("sweeps", range(10))
def test_smoother_tiles_equal_twin(shape, logical, sweeps):
    """Sweeps 0-9 (9: groups of 4 + 4 + 1) on the fused smoother's tiles
    equal the twin bit for bit."""
    u, b, h = _inputs(shape, logical, seed=sweeps)
    got = emulate_smoother(u, b, ALPHA, h, sweeps, logical)
    want = cs.red_black_gauss_seidel_plain(u, b, ALPHA, h, sweeps, logical)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape,logical", DOWNLEG_SHAPES)
@pytest.mark.parametrize("sweeps", range(4))
def test_downleg_tiles_equal_twin(shape, logical, sweeps):
    """Sweeps 0-3 on the down-leg's tiles: u2 and the coarse residual equal
    the twin (smoother, residual, restriction) bit for bit."""
    u, b, h = _inputs(shape, logical, seed=10 + sweeps)
    u2, rc = emulate_downleg(u, b, ALPHA, h, sweeps, logical)
    tu, trc = cs.rbgs_residual_restrict_plain(u, b, ALPHA, h, sweeps, logical)
    assert rc.shape == (shape[0] // 2, shape[1] // 2)
    assert torch.equal(u2, tu) and torch.equal(rc, trc)


@pytest.mark.parametrize("sweeps", [1, 2, 3, 4])
def test_one_ring_less_is_not_enough(sweeps):
    """With a row halo of 2 sweeps - 1 the stale ring reaches the core: the
    emulation then differs from the twin, so the tests above have teeth."""
    shape, logical = SMOOTHER_SHAPES[2]
    u, b, h = _inputs(shape, logical, seed=20)
    got = emulate_smoother(u, b, ALPHA, h, sweeps, logical, ring_short=1)
    want = cs.red_black_gauss_seidel_plain(u, b, ALPHA, h, sweeps, logical)
    assert not torch.equal(got, want)


def test_tile_geometry_and_groups():
    """The geometry the kernels are compiled for: one ring per pass, the
    column halo rounded up to 4, 128 columns by 64 rows; sweeps run in
    groups of at most 4 (9 -> 4 + 4 + 1)."""
    assert cs.rbgs_tile(4) == (4, 4, 64, 128)  # the 2-sweep smoother
    assert cs.rbgs_tile(6) == (6, 8, 64, 128)  # the 2-sweep down-leg
    assert [cs.rbgs_tile(p)[1] for p in range(1, 9)] == [4] * 4 + [8] * 4
    for p in range(1, 9):
        hr, hc, rows, cols = cs.rbgs_tile(p)
        assert (rows - 2 * hr) % 2 == 0 and (cols - 2 * hc) % 4 == 0
    assert cs._groups(9) == [4, 4, 1] and cs._groups(4) == [4]
    assert cs._groups(0) == [] and cs._groups(6) == [4, 2]
    for p in (0, 9):
        with pytest.raises(ValueError, match="1 .. 8 passes"):
            cs.rbgs_tile(p)


@pytest.mark.parametrize("sweeps", [0, 2, 9])
def test_cpu_wrappers_neither_mutate_nor_clone(monkeypatch, sweeps):
    """On the CPU the smoother and the down-leg run their twins: ``u`` and
    ``b`` stay as they were, and no tensor is cloned for the result."""
    shape, logical = DOWNLEG_SHAPES[0]
    u, b, h = _inputs(shape, logical, seed=30)
    u0, b0 = u.clone(), b.clone()
    clones = []
    clone = torch.Tensor.clone
    monkeypatch.setattr(torch.Tensor, "clone",
                        lambda self, *a, **k: clones.append(1)
                        or clone(self, *a, **k))
    cs.reset_launch_counts()
    got = cs.red_black_gauss_seidel(u, b, ALPHA, h, sweeps=sweeps,
                                    logical_shape=logical)
    u2, _ = cs.rbgs_residual_restrict(u, b, ALPHA, h, min(sweeps, 3),
                                      logical)
    monkeypatch.undo()
    assert not clones and all(v == 0 for v in cs.LAUNCHES.values())
    assert torch.equal(u, u0) and torch.equal(b, b0)
    if sweeps:
        assert got.data_ptr() != u.data_ptr()
        assert u2.data_ptr() != u.data_ptr()


def test_tile_rows_probe_needs_the_card(monkeypatch, capsys):
    """The tile-height probe (``benchmarks/rbgs_tile_rows.py``) builds and
    times CUDA kernels only: without a card it exits non-zero, builds
    nothing and names the reason."""
    from multigrid_prj_tpu_torch.benchmarks import rbgs_tile_rows as probe

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert probe.main(["64:64"]) == 1
    assert "needs a CUDA device" in capsys.readouterr().err
    assert probe._ANCHOR in probe._build.SOURCES[0].read_text()
