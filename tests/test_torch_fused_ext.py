"""Twin of the extended-slab RB-GS kernel
(``ops/cuda_stencil.rbgs_fused_extended``, the sharded solver's smoother)
against the JAX ``rbgs_fused_extended`` in Pallas interpret mode, as
tests/test_sharded_gmg.py runs it, and against colour sweeps on the global
grid; and the kernel's tile decomposition (``rbgs_fused_ext_kernel``: the
colour-split tile of ``rbgs_tile`` at a global row offset), emulated in
plain torch and held to the twin.  The CUDA kernel is held to this twin in
tests/test_torch_cuda.py.

Inputs are made with a seeded numpy generator and handed to both sides.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from multigrid_prj_tpu.ops import pallas_stencil as ps
from multigrid_prj_tpu_torch.ops import cuda_stencil as cs

torch.set_num_threads(1)

ALPHA = 10.0
EXT_SHAPE = (80, 128)  # a 64-row slab with its two 8-row halos
# global logical shapes: the slab's rows inside, the buffer's columns
# (ragged in the second), and one whose last row falls inside the slab
LOGICAL = [(200, 128), (100, 120)]


def _rand(shape, count, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(dtype) for _ in range(count)]


@pytest.mark.parametrize("row0", [-8, 56, 120])
@pytest.mark.parametrize("sweeps", [1, 2, 3, 4])
@pytest.mark.parametrize("logical", LOGICAL)
def test_twin_matches_pallas_interpret(row0, sweeps, logical):
    """The twin against the JAX kernel in interpret mode, f32: within 2 ulp
    of the field's largest value (XLA contracts ``b * (1/c) + N`` into an
    FMA; torch never contracts)."""
    ue, be = _rand(EXT_SHAPE, 2, seed=sweeps)
    h = 10.0 / (logical[0] - 1)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ps.rbgs_fused_extended(
            jnp.asarray(ue), jnp.asarray(be), row0, logical, ALPHA, h, sweeps))
    cs.reset_launch_counts()
    got = cs.rbgs_fused_extended(torch.from_numpy(ue), torch.from_numpy(be),
                                 row0, logical, ALPHA, h, sweeps).numpy()
    assert all(v == 0 for v in cs.LAUNCHES.values())  # the twin on the CPU
    assert got.shape == want.shape == (EXT_SHAPE[0] - 16, EXT_SHAPE[1])
    assert np.abs(got - want).max() <= 2 * np.spacing(np.abs(want).max())


@pytest.mark.parametrize("row0", [-8, 0, 40, 56])
@pytest.mark.parametrize("sweeps", [1, 2, 3, 4])
def test_twin_equals_colour_sweeps_on_the_global_grid(row0, sweeps):
    """The core rows equal ``2 * sweeps`` colour sweeps of the global grid,
    cropped, exactly in f64: the halo rows outside the domain hold zeros
    (the edge exchange's) and stay pinned (row0 56: the slab's last rows lie
    past the domain's).  c = alpha / h^2 is a power of
    two (alpha 1, h 1/2), so ``b * (1/c)`` and the colour sweep's ``b / c``
    round alike."""
    nl, m = 96, 40
    u, b = _rand((nl, m), 2, seed=7, dtype=np.float64)
    alpha, h = 1.0, 0.5
    x = torch.from_numpy(u)
    bt = torch.from_numpy(b)
    for _ in range(sweeps):
        for color in (0, 1):
            x = cs.rbgs_color_sweep(x, bt, alpha, h, color)
    ne = 48 + 16
    ue = np.zeros((ne, m))
    be = np.zeros((ne, m))
    lo, hi = max(row0, 0), min(row0 + ne, nl)
    ue[lo - row0:hi - row0] = u[lo:hi]
    be[lo - row0:hi - row0] = b[lo:hi]
    got = cs.rbgs_fused_extended(torch.from_numpy(ue), torch.from_numpy(be),
                                 row0, (nl, m), alpha, h, sweeps)
    inside = min(ne - 16, nl - (row0 + 8))  # core rows inside the domain
    assert torch.equal(got[:inside], x[row0 + 8:row0 + 8 + inside])
    assert not got[inside:].any()  # rows past the domain: pinned to 0


def emulate_ext_tiles(ue, be, row0, logical, alpha, h, sweeps,
                      ring_short=0):
    """The kernel's launch as tiles of ``rbgs_tile(2 * sweeps)``: each
    tile's core covers output rows (slab rows 8 .. ne - 9), its halo starts
    at slab row 8 - 2 sweeps, cells past the slab load as 0; pass k updates
    rows k .. rows-1-k of the colour whose parity is taken from the global
    row ``row0 + slab row``, pinning the global boundary to ``be``
    (``ring_short`` rings fewer of row halo)."""
    ne, m = ue.shape
    nl, ml = logical
    hr, hc, rows, cols = cs.rbgs_tile(2 * sweeps)
    hr -= ring_short
    ch, cw = rows - 2 * hr, cols - 2 * hc
    inv_c = 1.0 / (alpha / (h * h))
    out = torch.empty((ne - 16, m), dtype=ue.dtype)
    r = torch.arange(rows)[:, None]
    for ty in range(-(-(ne - 16) // ch)):
        for tx in range(-(-m // cw)):
            i0, j0 = 8 + ty * ch - hr, tx * cw - hc
            tu = torch.zeros((rows, cols), dtype=ue.dtype)
            tb = torch.zeros((rows, cols), dtype=ue.dtype)
            r1, c0, c1 = min(i0 + rows, ne), max(j0, 0), min(j0 + cols, m)
            tu[:r1 - i0, c0 - j0:c1 - j0] = ue[i0:r1, c0:c1]
            tb[:r1 - i0, c0 - j0:c1 - j0] = be[i0:r1, c0:c1]
            gi = row0 + i0 + r
            gj = j0 + torch.arange(cols)[None, :]
            bnd = (gi <= 0) | (gi >= nl - 1) | (gj <= 0) | (gj >= ml - 1)
            for k in range(1, 2 * sweeps + 1):
                gs = (tb * inv_c + torch.roll(tu, 1, 0) + torch.roll(tu, -1, 0)
                      + torch.roll(tu, -1, 1) + torch.roll(tu, 1, 1)) * 0.25
                upd = ((r >= k) & (r <= rows - 1 - k)
                       & (((gi + gj) & 1) == ((k - 1) & 1)))
                tu = torch.where(upd, torch.where(bnd, tb, gs), tu)
            k0, k1 = ty * ch, min(ty * ch + ch, ne - 16)  # output rows
            q0, q1 = j0 + hc, min(j0 + hc + cw, m)
            out[k0:k1, q0:q1] = tu[hr:hr + k1 - k0, hc:hc + q1 - q0]
    return out


EMULATED = [(rows, m, ml) for rows in (8, 64) for m, ml in ((128, 128),
                                                            (200, 193))]


@pytest.mark.parametrize("row0", [-8, -7, 0, 57, 4088])
@pytest.mark.parametrize("rows,m,ml", EMULATED)
def test_ext_tiles_equal_twin(row0, rows, m, ml):
    """Sweeps 1-4 on the kernel's tiles equal the twin bit for bit: the
    first shard (row0 -8) and an odd one (-7), interior slabs at even and
    odd rows, one crossing the domain's last rows (4088: global 4096 ..
    4159 against 4150 rows), full and ragged widths (200 columns, logical
    193: no multiple of a tile core)."""
    ue, be = _rand((rows + 16, m), 2, seed=row0 + rows)
    h = 10.0 / (4150 - 1)
    for sweeps in (1, 2, 3, 4):
        got = emulate_ext_tiles(torch.from_numpy(ue), torch.from_numpy(be),
                                row0, (4150, ml), ALPHA, h, sweeps)
        want = cs.rbgs_fused_extended_plain(
            torch.from_numpy(ue), torch.from_numpy(be), row0, (4150, ml),
            ALPHA, h, sweeps)
        assert torch.equal(got, want), sweeps


@pytest.mark.parametrize("sweeps", [1, 2, 3, 4])
def test_ext_tiles_one_ring_less_is_not_enough(sweeps):
    """With a row halo of 2 sweeps - 1 the stale ring reaches the core of
    the tiles below the first: the emulation differs from the twin."""
    ue, be = _rand((256 + 16, 128), 2, seed=11)
    h = 10.0 / (4150 - 1)
    args = (torch.from_numpy(ue), torch.from_numpy(be), 57, (4150, 128),
            ALPHA, h, sweeps)
    assert not torch.equal(emulate_ext_tiles(*args, ring_short=1),
                           cs.rbgs_fused_extended_plain(*args))


def test_wrapper_checks():
    ue = torch.zeros((24, 16))
    with pytest.raises(ValueError, match="at most 4"):
        cs.rbgs_fused_extended(ue, ue, -8, (64, 16), 1.0, 1.0, 5)
    with pytest.raises(ValueError, match=">= 16 rows"):
        cs.rbgs_fused_extended(ue[:15], ue[:15], -8, (64, 16), 1.0, 1.0, 1)
    with pytest.raises(ValueError, match="does not fit"):
        cs.rbgs_fused_extended(ue, ue, -8, (64, 17), 1.0, 1.0, 1)
    assert cs.fused_extended_supported((8, 330), torch.float32)
    assert not cs.fused_extended_supported((8, 330), torch.float64)
    assert not cs.fused_extended_supported((8, 8, 8), torch.float32)
