"""The smooth 3D pair of BASELINE config 4 (``bench.py:462-465``):
``f = sin(3x) cos(2y) + z`` on interior nodes, ``g = e^x e^{-2y} z`` on
boundary nodes, with node (k, j, i) of a ``(nz, ny, nx)`` array at
``x = i h``, ``y = L - j h``, ``z = L - k h``.  Plain torch."""

import torch


def f(x, y, z):
    return torch.sin(3.0 * x) * torch.cos(2.0 * y) + z


def g(x, y, z):
    return torch.exp(x) * torch.exp(-2.0 * y) * z
