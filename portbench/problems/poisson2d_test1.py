"""Test 1 of the reference CLI (``gmg_main -test 1``): ``f = -5 e^x e^{-2y}``
on interior nodes, ``g = e^x e^{-2y}`` on boundary nodes, with node (i, j)
at ``x = j h``, ``y = L - i h``.  Plain torch, a copy of the forcing the
port's ``models/poisson.py`` registers as test 1."""

import torch


def f(x, y):
    return -5.0 * torch.exp(x) * torch.exp(-2.0 * y)


def g(x, y):
    return torch.exp(x) * torch.exp(-2.0 * y)
