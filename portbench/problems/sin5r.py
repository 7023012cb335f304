"""The reference's AMG problem (``AMG/src/Utilities.cpp:3-27``): ``g =
sin(5 r)`` on boundary nodes and ``f = -5 (cos(5 r) / r - 5 sin(5 r))``
(that is ``-lap g``) on interior nodes, ``r = sqrt(x^2 + y^2)``, with node
(i, j) at ``x = j h``, ``y = L - i h``.  ``f`` is 0 at ``r = 0``, as the
port's ``models/fem.default_forcing_term`` has it; that node, the corner
(n - 1, 0), is on the boundary.  Plain torch."""

import torch


def f(x, y):
    r = torch.sqrt(x * x + y * y)
    at_origin = r == 0.0
    r_safe = torch.where(at_origin, torch.ones_like(r), r)
    val = -5.0 * (torch.cos(5.0 * r) / r_safe - 5.0 * torch.sin(5.0 * r))
    return torch.where(at_origin, torch.zeros_like(val), val)


def g(x, y):
    return torch.sin(5.0 * torch.sqrt(x * x + y * y))
