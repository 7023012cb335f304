"""Twin of the extended-slab RB-GS kernel
(``ops/cuda_stencil.rbgs_fused_extended``, the sharded solver's smoother)
against the JAX ``rbgs_fused_extended`` in Pallas interpret mode, as
tests/test_sharded_gmg.py runs it, and against colour sweeps on the global
grid.  The CUDA kernel is held to this twin in tests/test_torch_cuda.py.

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
