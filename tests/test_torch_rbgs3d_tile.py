"""The two launch shapes of the fused 3D red-black smoother of
``csrc/stencil3d.cu`` (``rbgs3d_zmarch_kernel``, ``rbgs3d_resident_kernel``),
emulated in plain torch on the CPU and held to the twin
``red_black_gauss_seidel_3d_plain`` bit for bit.

The z-march emulation reads its geometry, the z-chunk included, from
``ops/cuda_stencil_3d.rbgs3d_tile`` and its sweep groups from
``ops/cuda_stencil._groups``, the values the CUDA wrapper hands the kernel.
Every x-y tile (a core plus one ring of halo per dependent pass; cells
outside the array load as 0 and count as boundary cells) walks each chunk
z0 .. z1 - 1 of z as one block does: its ring starts as NaN (shared memory
holds whatever it held), it loads planes z0 - P .. z1 + P - 1 (clamped to
the array), at step t its copies of plane t + 3 land in their ring slots
if it loads that plane, it stores the core of plane t - 2P if the chunk
owns it, and runs colour pass k on plane t + 1 - 2k, k = 1 .. P, wherever
that plane lies in the array, all at once, in place in the ring (a pass's
rows k .. rows-1-k; the edge columns read neighbours from outside the
tile, as the kernel's do: that ring is stale after the first pass
anyway).  Equal to the twin on odd, padded and non-cubic shapes, with the
rule's chunk, a chunk of one plane, chunks whose edges fall inside the
array and a chunk of nz planes (one march over every plane), it shows that
the halo, the z-halo, the two-plane lag and the ring sizes the kernel gets
are enough, and that what the passes leave on the planes a chunk does not
load never reaches a stored plane; with one ring of halo less, one plane
of z-halo less, one plane of lag less, or one ring plane less, it is
not.

The resident emulation walks the kernel's sites (z, y, column pair), whose
cell of colour c is column 2p + ((z + y + c) & 1), pass by pass over the
whole array.  The card holds both kernels to the same twin in
``tests/test_torch_cuda.py``.
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
# (physical, logical or None): config 4's 17^3 bottom, a padded non-cubic
# shape (the 2D kernels' alignment, logical extents odd), an unpadded
# non-cubic shape whose x-y extents are not multiples of the tile core, and
# a padded one of several tiles on both axes
SHAPES = [((17, 17, 17), None), ((20, 24, 136), (17, 21, 129)),
          ((19, 23, 41), None), ((12, 70, 44), (11, 67, 41))]
# arrays the resident route takes: the 17^3 bottom, exact and padded
RESIDENT_SHAPES = [((17, 17, 17), None), ((18, 18, 32), (17, 17, 17))]
# several tiles on both axes and more planes than the longest ring holds
TEETH_SHAPE = ((30, 70, 44), (29, 67, 41))


def _inputs(shape, logical, seed):
    rng = np.random.default_rng(seed)
    u, b = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for _ in range(2))
    h = 1.0 / ((logical or shape)[0] - 1)
    return u, b, h


def _zmarch_launch(u, b, c, sweeps, logical, chunk=None, halo_short=0,
                   zhalo_short=0, lag_short=0, ring_short=0):
    """One z-marching launch of ``sweeps`` sweeps: every block of a chunk
    at once, as a batch of tiles, chunk after chunk (each reads only ``u``
    and ``b`` and stores only its own planes); ``chunk`` planes per chunk
    in place of the geometry's, ``halo_short`` rings fewer of row halo,
    ``zhalo_short`` planes fewer loaded beyond each end of a chunk,
    ``lag_short`` planes fewer between passes, ``ring_short`` planes fewer
    in the u ring.  The passes of a step run at once, as the kernel's do
    between two barriers: each reads the ring as the step found it."""
    nz, ny, nx = u.shape
    nzl, nyl, nxl = logical or u.shape
    npass = 2 * sweeps
    hr, hc, ty, tx, ru, rb, zc = c3.rbgs3d_tile(npass, u.shape)
    zc = chunk or zc
    hr -= halo_short
    hz = npass - zhalo_short
    ru -= ring_short
    lag, ahead = c3._RB3_LAG - lag_short, c3._RB3_AHEAD
    ch, cw = ty - 2 * hr, tx - 2 * hc
    nty, ntx = -(-ny // ch), -(-nx // cw)
    gy = (torch.arange(nty) * ch - hr)[:, None, None, None] \
        + torch.arange(ty)[None, None, :, None]
    gx = (torch.arange(ntx) * cw - hc)[None, :, None, None] \
        + torch.arange(tx)[None, None, None, :]
    yx_bnd = (gy <= 0) | (gy >= nyl - 1) | (gx <= 0) | (gx >= nxl - 1)
    yx_par = (gy + gx) & 1
    rows = torch.arange(ty)[None, None, :, None]
    pad = (hc, ntx * cw + hc - nx, hr, nty * ch + hr - ny)
    c_t = torch.full((), c, dtype=u.dtype)
    # a chunk's ring holds whatever shared memory held: NaN
    garbage = torch.full((nty, ntx, ty, tx), float("nan"))
    ring_u, ring_b = [garbage] * ru, [garbage] * rb
    out = torch.empty_like(u)

    def tiles(plane):  # (ny, nx) -> (nty, ntx, ty, tx), zeros outside
        return F.pad(plane, pad).unfold(0, ty, ch).unfold(1, tx, cw).clone()

    def load(z):
        ring_u[z % ru], ring_b[z % rb] = tiles(u[z]), tiles(b[z])

    def store(z):
        core = ring_u[z % ru][:, :, hr:hr + ch, hc:hc + cw]
        out[z] = core.permute(0, 2, 1, 3).reshape(nty * ch,
                                                  ntx * cw)[:ny, :nx]

    def colour_pass(k, z):
        """Pass k on plane z, from the ring as it stands: the new plane."""
        x, bt = ring_u[z % ru], ring_b[z % rb]
        upd = (rows >= k) & (rows <= ty - 1 - k) \
            & (((z + yx_par) & 1) == ((k - 1) & 1))
        if z == 0 or z >= nzl - 1:  # a boundary plane reads no neighbour
            return torch.where(upd, bt, x)
        nb = (torch.roll(x, 1, 2) + torch.roll(x, -1, 2)
              + torch.roll(x, -1, 3) + torch.roll(x, 1, 3)
              + ring_u[(z - 1) % ru] + ring_u[(z + 1) % ru])
        gs = (bt / c_t + nb) * c3._INV6
        return torch.where(upd, torch.where(yx_bnd, bt, gs), x)

    span = lag * (npass - 1)
    for z0 in range(0, nz, zc):
        z1 = min(z0 + zc, nz)
        p0, pe = max(z0 - hz, 0), min(z1 + hz, nz) - 1
        ring_u[:], ring_b[:] = [garbage] * ru, [garbage] * rb
        for z in range(p0, min(p0 + ahead, pe + 1)):
            load(z)
        for t in range(p0, z1 + span + 2):
            # the copies of plane t + ahead land while the step runs
            if t + ahead <= pe:
                load(t + ahead)
            if z0 <= t - 2 - span < z1:
                store(t - 2 - span)
            planes = [(k, t - 1 - lag * (k - 1))
                      for k in range(1, npass + 1)]
            new = {z: colour_pass(k, z) for k, z in planes if 0 <= z < nz}
            for z, x in new.items():
                ring_u[z % ru] = x
    return out


def emulate_zmarch(u, b, alpha, h, sweeps, logical=None, **short):
    """The z-marching launches of ``sweeps`` sweeps: one group of <= 4 per
    launch, out of place (``sweeps == 0``: a copy)."""
    x = u.clone() if sweeps < 1 else u
    for s in cs._groups(sweeps):
        x = _zmarch_launch(x, b, alpha / (h * h), s, logical, **short)
    return x


def resident_sites(shape):
    """(z, y, pair) of every site of the resident kernel, in site order."""
    nz, ny, nx = shape
    s = torch.arange(nz * ny * ((nx + 1) // 2))
    p, zy = s % ((nx + 1) // 2), s // ((nx + 1) // 2)
    return zy // ny, zy % ny, p


def emulate_resident(u, b, alpha, h, sweeps, logical=None):
    """The resident launch: all 2 x sweeps passes over the kernel's sites,
    each pass computing its colour from the other colour's values."""
    nz, ny, nx = u.shape
    nzl, nyl, nxl = logical or u.shape
    c_t = torch.full((), alpha / (h * h), dtype=u.dtype)
    z, y, p = resident_sites(u.shape)
    x, bf = u.clone().reshape(-1), b.reshape(-1)
    for k in range(2 * sweeps):
        col = 2 * p + ((z + y + (k & 1)) & 1)
        ok = col < nx
        zz, yy, xx = z[ok], y[ok], col[ok]
        i = (zz * ny + yy) * nx + xx
        bnd = ((zz == 0) | (yy == 0) | (xx == 0) | (zz >= nzl - 1)
               | (yy >= nyl - 1) | (xx >= nxl - 1))
        j = i[~bnd]
        nb = (x[j - nx] + x[j + nx] + x[j + 1] + x[j - 1] + x[j - ny * nx]
              + x[j + ny * nx])
        new = bf[i].clone()
        new[~bnd] = (bf[j] / c_t + nb) * c3._INV6
        x[i] = new
    return x.reshape(u.shape)


@pytest.mark.parametrize("shape,logical", SHAPES)
@pytest.mark.parametrize("sweeps", range(10))
def test_zmarch_tiles_equal_twin(shape, logical, sweeps):
    """Sweeps 0-9 (9: launches of 4 + 4 + 1) on the z-marching tiles equal
    the twin bit for bit."""
    u, b, h = _inputs(shape, logical, seed=sweeps)
    got = emulate_zmarch(u, b, ALPHA, h, sweeps, logical)
    want = c3.red_black_gauss_seidel_3d_plain(u, b, ALPHA, h, sweeps, logical)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape,logical", SHAPES)
@pytest.mark.parametrize("sweeps", [1, 2, 3, 4, 9])
@pytest.mark.parametrize("chunk", ["one plane", "edges inside", "nz"])
def test_zmarch_chunks_equal_twin(shape, logical, sweeps, chunk):
    """Chunks of one plane, of 3 or 5 planes (edges inside the array, the
    last chunk shorter), and of nz planes (one march over every plane, the
    march before the z-split) equal the twin bit for bit at 1-4 and 9
    sweeps."""
    u, b, h = _inputs(shape, logical, seed=70 + sweeps)
    zc = {"one plane": 1, "edges inside": 3 if shape[0] % 3 else 5,
          "nz": shape[0]}[chunk]
    got = emulate_zmarch(u, b, ALPHA, h, sweeps, logical, chunk=zc)
    want = c3.red_black_gauss_seidel_3d_plain(u, b, ALPHA, h, sweeps, logical)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape,logical", RESIDENT_SHAPES)
@pytest.mark.parametrize("sweeps", list(range(10)) + [100])
def test_resident_equals_twin(shape, logical, sweeps):
    """Sweeps 0-9, and the 17^3 bottom's 100, on the resident route equal
    the twin bit for bit."""
    u, b, h = _inputs(shape, logical, seed=40 + sweeps)
    assert c3.rbgs3d_route(shape) == "resident"
    got = emulate_resident(u, b, ALPHA, h, sweeps, logical)
    want = c3.red_black_gauss_seidel_3d_plain(u, b, ALPHA, h, sweeps, logical)
    assert torch.equal(got, want)


# one march over every plane: the ring wraps around, the lag is exercised
_WHOLE = TEETH_SHAPE[0][0]


@pytest.mark.parametrize("short", [dict(halo_short=1, chunk=_WHOLE),
                                   dict(lag_short=1, chunk=_WHOLE),
                                   dict(ring_short=1, chunk=_WHOLE),
                                   dict(zhalo_short=1, chunk=7)],
                         ids=["one ring of halo less",
                              "one plane of lag less",
                              "one ring plane less",
                              "one plane of z-halo less"])
@pytest.mark.parametrize("sweeps", [1, 2, 4])
def test_less_than_the_kernel_gets_fails(short, sweeps):
    """With a row halo of 2 sweeps - 1, passes one plane apart in a step,
    or a u ring of one plane less (one march over every plane), or chunks
    of 7 planes that read 2 sweeps - 1 planes beyond each end, the
    emulation differs from the twin: the tests above have teeth."""
    shape, logical = TEETH_SHAPE
    u, b, h = _inputs(shape, logical, seed=50)
    got = emulate_zmarch(u, b, ALPHA, h, sweeps, logical, **short)
    want = c3.red_black_gauss_seidel_3d_plain(u, b, ALPHA, h, sweeps, logical)
    assert not torch.equal(got, want)


@pytest.mark.parametrize("shape", [(17, 17, 17), (9, 9, 3), (4, 64, 64),
                                   (2, 2, 4096), (25, 25, 26)])
def test_resident_sites_cover_each_colour_once(shape):
    """Each colour's cells are the sites' cells, once each, and the sites
    of an array within the cap fit the kernel's per-thread registers (1024
    threads, at most 2/3 of the points: nx >= 2)."""
    nz, ny, nx = shape
    z, y, p = resident_sites(shape)
    for colour in (0, 1):
        col = 2 * p + ((z + y + colour) & 1)
        ok = col < nx
        cells = ((z * ny + y) * nx + col)[ok]
        zz, yy, xx = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx),
                                 indexing="ij")
        want = np.flatnonzero(((zz + yy + xx) & 1) == colour)
        assert sorted(cells.tolist()) == want.tolist()
    if nz * ny * nx <= c3.RESIDENT_MAX_POINTS:
        per_thread = (2 * c3.RESIDENT_MAX_POINTS // 3 + 1023) // 1024
        assert 3 * z.numel() <= 2 * nz * ny * nx
        assert z.numel() <= 1024 * per_thread


def test_geometry_route_and_the_c_source_agree():
    """The geometry and the cap the wrapper passes are the ones the CUDA
    source compiles (it refuses others): one ring of halo per pass, 32
    columns, passes two planes apart, three planes loaded ahead, rings of
    2 passes + 4 and 2 passes + 3 planes, as many z-chunks per tile as one
    wave of 132 blocks holds (config 4's levels: chunks of 257, 43, 5 and 1
    planes, 121, 108, 117 and 132 blocks; 513^3 one chunk); the resident
    route up to RESIDENT_MAX_POINTS points."""
    cube = (257, 257, 257)
    # the 2-sweep smoother at 257^3
    assert c3.rbgs3d_tile(4, cube) == (4, 4, 32, 32, 12, 11, 257)
    for p in (2, 4, 6, 8):
        hr, hc, rows, cols, ru, rb, zc = c3.rbgs3d_tile(p, cube)
        assert (hr, hc, ru, rb) == (p, p, 2 * p + 4, 2 * p + 3)
        assert 4 * (ru + rb) * rows * cols <= 227 * 1024
        assert rows - 2 * hr > 0 and cols - 2 * hc > 0 and rows % 2 == 0
        assert 2 * rows * cols // 2 <= 1024  # a thread per row, pair, colour
    for n, zc, blocks in ((257, 257, 121), (129, 43, 108), (65, 5, 117),
                          (33, 1, 132), (513, 513, 484)):
        tile = c3.rbgs3d_tile(4, (n, n, n))
        assert tile[6] == zc
        assert (-(-n // 24)) ** 2 * -(-n // zc) == blocks
    assert c3.rbgs3d_tile(4, (5, 1000, 1000))[6] == 5  # tiles fill a wave
    for p in (0, 3, 10):
        with pytest.raises(ValueError, match="passes"):
            c3.rbgs3d_tile(p, cube)
    src = _build.SOURCES[1].read_text()
    lo, hi = c3._RB3_TILE_ROWS
    assert f"static constexpr int TY = P <= 4 ? {lo} : {hi};" in src
    assert f"constexpr int kZmCols = {c3._RB3_TILE_COLS};" in src
    assert f"constexpr int kZmLag = {c3._RB3_LAG};" in src
    assert f"constexpr int kZmAhead = {c3._RB3_AHEAD};" in src
    assert (f"constexpr int kZmTargetBlocks = {c3._RB3_TARGET_BLOCKS};"
            in src)
    assert f"constexpr int kZmMinChunk = {c3._RB3_MIN_CHUNK};" in src
    # the benchmark's trace reader still finds the kernel among the port's
    from portbench import trace

    assert {"rbgs3d_zmarch_kernel", "rbgs3d_resident_kernel"} \
        <= trace.port_kernel_names()
    cap = re.search(r"constexpr int kResidentMaxPoints = (\d+);", src)
    assert int(cap.group(1)) == c3.RESIDENT_MAX_POINTS
    assert c3.rbgs3d_route((17, 17, 17)) == "resident"
    assert c3.rbgs3d_route((18, 18, 32)) == "resident"
    assert c3.rbgs3d_route((33, 33, 33)) == "zmarch"
    assert c3.rbgs3d_route((1, 1, c3.RESIDENT_MAX_POINTS)) == "resident"
    assert c3.rbgs3d_route((1, 1, c3.RESIDENT_MAX_POINTS + 1)) == "zmarch"


@pytest.mark.parametrize("sweeps", [0, 2, 9])
def test_cpu_wrapper_neither_mutates_nor_clones(monkeypatch, sweeps):
    """On the CPU the 3D smoother runs its twin on both routes' shapes:
    ``u`` and ``b`` stay as they were, no tensor is cloned and nothing is
    launched."""
    for shape, logical in (SHAPES[1], RESIDENT_SHAPES[0]):
        u, b, h = _inputs(shape, logical, seed=60)
        u0, b0 = u.clone(), b.clone()
        clones = []
        clone = torch.Tensor.clone
        monkeypatch.setattr(torch.Tensor, "clone",
                            lambda self, *a, **k: clones.append(1)
                            or clone(self, *a, **k))
        cs.reset_launch_counts()
        got = cs.red_black_gauss_seidel(u, b, ALPHA, h, sweeps=sweeps,
                                        logical_shape=logical)
        monkeypatch.undo()
        assert not clones and all(v == 0 for v in cs.LAUNCHES.values())
        assert torch.equal(u, u0) and torch.equal(b, b0)
        if sweeps:
            assert got.data_ptr() != u.data_ptr()


def test_tile_rows_probe_needs_the_card(monkeypatch, capsys):
    """The 3D tile-height probe (``benchmarks/rbgs3d_tile_rows.py``) builds
    and times CUDA kernels only: without a card it exits non-zero, builds
    nothing and names the reason."""
    from multigrid_prj_tpu_torch.benchmarks import rbgs3d_tile_rows as probe

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert probe.main(["32:32"]) == 1
    assert "needs a CUDA device" in capsys.readouterr().err
    assert probe._ANCHOR in probe._build.SOURCES[1].read_text()


def test_chunk_probe_needs_the_card(monkeypatch, capsys):
    """The 3D z-chunk probe (``benchmarks/rbgs3d_chunk_probe.py``) builds
    and times CUDA kernels only: without a card it exits non-zero, builds
    nothing and names the reason; the constants it rewrites are the ones
    the source declares."""
    from multigrid_prj_tpu_torch.benchmarks import rbgs3d_chunk_probe as probe

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert probe.main(["264:1"]) == 1
    assert "needs a CUDA device" in capsys.readouterr().err
    src = probe._build.SOURCES[1].read_text()
    assert all(anchor in src for anchor in probe._ANCHORS)
