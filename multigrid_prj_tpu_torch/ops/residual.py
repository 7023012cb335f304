"""Residual norms (port of ``multigrid_prj_tpu/ops/residual.py``).

The monitored quantity is the relative 2-norm ``sqrt(||b - A u||^2 /
||b||^2)``, accumulated over every row including the identity boundary rows.
"""

from __future__ import annotations

import torch

from multigrid_prj_tpu_torch.ops.stencil import poisson_residual


def norm2(x: torch.Tensor) -> torch.Tensor:
    """Squared 2-norm (sum of squares over all nodes)."""
    return torch.sum(x * x)


def rel_residual_norm(u: torch.Tensor, b: torch.Tensor, alpha: float, h: float,
                      logical_shape=None) -> torch.Tensor:
    """``||b - A u||_2 / ||b||_2``."""
    r = poisson_residual(u, b, alpha, h, logical_shape)
    return torch.sqrt(norm2(r) / norm2(b))
