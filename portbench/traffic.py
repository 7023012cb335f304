"""The general generator of right-hand sides.

A traffic file (``traffic/<name>.json``) gives the loop, the pool size and
the noise: ``{"loop": "closed", "callers": 1, "pool": 16, "noise_rel":
0.001}``.  The pool holds ``pool`` right-hand sides on the device, each the
configuration's forcing ``f`` on interior nodes and boundary values ``g``
(``problems/<problem>.py``), plus white noise of ``noise_rel * max|f|``
on the interior nodes, drawn from ``--seed``.  Solves take the pool's
entries in turn.
"""

from __future__ import annotations

import torch

SEED_MOD = 2 ** 63  # torch generators take seeds below 2^64


def grid_coords(shape, length, device):
    """Node coordinates in float64: 2D ``x = j h``, ``y = L - i h``; 3D
    ``x = i h`` (last axis), ``y = L - j h``, ``z = L - k h`` (first)."""
    shape = tuple(int(n) for n in shape)
    h = float(length) / (shape[0] - 1)

    def iota(ax):
        view = [1] * len(shape)
        view[ax] = shape[ax]
        idx = torch.arange(shape[ax], device=device, dtype=torch.float64)
        return idx.view(view).expand(shape)

    if len(shape) == 2:
        return iota(1) * h, length - iota(0) * h
    if len(shape) == 3:
        return iota(2) * h, length - iota(1) * h, length - iota(0) * h
    raise ValueError(f"no coordinates for rank {len(shape)}")


def boundary(shape, device):
    """Boolean mask of the nodes with an index 0 or n - 1."""
    mask = None
    for ax, n in enumerate(shape):
        idx = torch.arange(n, device=device)
        edge = ((idx == 0) | (idx == n - 1)).view(
            [n if a == ax else 1 for a in range(len(shape))])
        mask = edge if mask is None else mask | edge
    return mask.expand(tuple(shape))


def make_pool(problem, shape, length, traffic, seed, device,
              dtype=torch.float32):
    """``traffic["pool"]`` right-hand sides of ``shape`` in ``dtype``."""
    coords = grid_coords(shape, length, device)
    bnd = boundary(shape, device)
    f = problem.f(*coords)
    base = torch.where(bnd, problem.g(*coords), f)
    scale = float(traffic["noise_rel"]) * float(f[~bnd].abs().max())
    del f, coords
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % SEED_MOD)
    pool = []
    for _ in range(int(traffic["pool"])):
        noise = torch.randn(base.shape, generator=gen, device=device,
                            dtype=torch.float32)
        noise.masked_fill_(bnd, 0.0)
        pool.append((base + scale * noise.to(torch.float64)).to(dtype))
    return pool
