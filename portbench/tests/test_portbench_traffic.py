"""The right-hand side pool: made from the seed, the same for a seed and
different across seeds, noise on interior nodes only."""

from __future__ import annotations

import pytest
import torch

from portbench import registry, traffic
from portbench.tests._small import SMALL  # noqa: F401  (sets threads)

MIX = {"loop": "closed", "callers": 1, "pool": 3, "noise_rel": 1e-3}


@pytest.mark.parametrize("problem,shape,length", [
    ("poisson2d_test1", (33, 33), 10.0),
    ("poisson3d_smooth", (9, 9, 9), 1.0)])
def test_pool_follows_the_seed(problem, shape, length):
    prob = registry.load_module("problems", problem)
    big = 2 ** 31 + 12345  # drivers' seeds pass 32 signed bits
    a = traffic.make_pool(prob, shape, length, MIX, big, "cpu")
    b = traffic.make_pool(prob, shape, length, MIX, big, "cpu")
    c = traffic.make_pool(prob, shape, length, MIX, big + 1, "cpu")
    assert len(a) == 3 and all(x.dtype == torch.float32 for x in a)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not any(torch.equal(x, y) for x, y in zip(a, c))
    assert not torch.equal(a[0], a[1])
    bnd = traffic.boundary(shape, "cpu")
    coords = traffic.grid_coords(shape, length, "cpu")
    g = prob.g(*coords).to(torch.float32)
    f = prob.f(*coords)
    for x in a:
        assert torch.equal(x[bnd], g[bnd])
        noise = x.double()[~bnd] - f[~bnd]
        scale = 1e-3 * float(f[~bnd].abs().max())
        assert 0.3 * scale < float(noise.std()) < 3 * scale


def test_coordinates_match_the_program():
    from multigrid_prj_tpu_torch.models.poisson import grid_coords

    for shape, length in (((5, 7), 10.0), ((5, 6, 7), 1.0)):
        ours = traffic.grid_coords(shape, length, "cpu")
        theirs = grid_coords(shape, length, dtype=torch.float64, device="cpu")
        assert all(torch.allclose(a, b, rtol=0, atol=1e-12)
                   for a, b in zip(ours, theirs))
