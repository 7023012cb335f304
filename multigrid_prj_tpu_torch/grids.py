"""Structured-grid descriptors and the geometric multigrid hierarchy
(copied from ``multigrid_prj_tpu/grids.py``, which is jax-free).

Capability parity with the reference's ``SquareDomain``
(``GeometricMultigrid/include/domain.hpp:44-96``, ``src/domain.cpp``): an
``n^d`` node grid on ``[0, L]^d`` where a level-``l`` grid is the stride-``2^l``
subset of the finest grid's index space (``domain.cpp:9-12`` halves the width
per level, ``domain.hpp:78-80`` maps coarse index -> fine index).

TPU-native design: a level is *metadata only* (shape + spacing) — solution /
rhs / residual vectors live as dense ``(n, n)`` (2D) or ``(n, n, n)`` (3D)
arrays per level, so every stencil op is a fused XLA/Pallas array pass instead
of the reference's per-row index arithmetic.  The reference's ``mask`` trick
(coarse index -> fine index, ``domain.hpp:78-80``) becomes ``[::2]`` striding.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class GridLevel:
    """One level of a structured-grid hierarchy.

    Attributes:
      shape: LOGICAL node counts per axis, e.g. ``(n, n)`` for 2D.
      h: grid spacing at this level.  Matches the reference's
        ``SquareDomain::h() = m_h * step`` (``domain.hpp:90``): the finest
        spacing times ``2^level`` — independent of rounding in the coarse
        node count.
      level: 0 = finest.
      padded_shape: physical buffer shape for the tile-aligned layout
        (``None`` = arrays are exactly ``shape``).  The live grid occupies
        ``[0, shape)``; the dead zone holds zeros pinned by the masked
        operators (see ``ops/transfer.py`` aligned-layout notes).
    """

    shape: Tuple[int, ...]
    h: float
    level: int
    padded_shape: Tuple[int, ...] | None = None

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def physical(self) -> Tuple[int, ...]:
        return self.padded_shape if self.padded_shape is not None else self.shape

    @property
    def num_nodes(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def coarsen_shape(shape: Sequence[int]) -> Tuple[int, ...]:
    """Stride-2 coarse node count per axis: ``(n + 1) // 2``.

    Mirrors the reference's ``width = (width + 1) / 2`` per level
    (``domain.cpp:10-12``).  For odd ``n`` the coarse grid contains both
    endpoints of the fine grid; hierarchies built from ``n = k * 2^L + 1``
    stay odd at every level.
    """
    return tuple((int(s) + 1) // 2 for s in shape)


def build_hierarchy(
    shape: Sequence[int],
    length: float,
    num_levels: int,
    min_size: int = 3,
    pad_align: int | None = None,
) -> list[GridLevel]:
    """Build the level metadata list, finest first.

    Mirrors ``main.cpp:32-35`` (one ``SquareDomain`` per level).  Raises if a
    requested level would drop below ``min_size`` nodes per axis.

    ``pad_align``: enable the tile-aligned layout — the finest physical
    buffer rounds ``n + 1`` up to a multiple of ``pad_align`` (e.g. 256 for
    Pallas (8, 128) tiling with headroom), and each coarser padded buffer is
    exactly half, until the slack runs out (``P < n + 1``) after which levels
    store exact (unpadded) arrays.  A per-axis tuple is accepted — the
    natural 3D choice aligns only the lane axis to 128 and the others to 8
    (e.g. ``(8, 8, 128)``), avoiding the cubic blow-up of a uniform 128/256
    alignment.
    """
    shape = tuple(int(s) for s in shape)
    if any(s < 2 for s in shape):
        raise ValueError(f"grid shape must be >= 2 per axis, got {shape}")
    if num_levels < 1:
        raise ValueError("num_levels must be >= 1")
    h0 = float(length) / (shape[0] - 1)

    padded: Tuple[int, ...] | None = None
    if pad_align is not None:
        aligns = (pad_align if isinstance(pad_align, (tuple, list))
                  else (pad_align,) * len(shape))
        if len(aligns) != len(shape):
            raise ValueError(f"pad_align {pad_align} does not match "
                             f"grid rank {len(shape)}")
        padded = tuple(-((-(s + 1)) // a) * a
                       for s, a in zip(shape, aligns))

    def check(pp, lshape):
        # a padded level needs headroom (P >= n + 1) and halvability
        if pp is None or any(p < s + 1 or p % 2 for p, s in zip(pp, lshape)):
            return None
        return pp

    padded = check(padded, shape)
    levels = [GridLevel(shape=shape, h=h0, level=0, padded_shape=padded)]
    for l in range(1, num_levels):
        cshape = coarsen_shape(levels[-1].shape)
        if min(cshape) < min_size:
            raise ValueError(
                f"level {l} would have shape {cshape}; grid {shape} supports "
                f"fewer than {num_levels} levels (min coarse size {min_size})"
            )
        # once a level drops to the exact layout, all deeper levels do too
        padded = check(
            None if padded is None else tuple(p // 2 for p in padded), cshape
        )
        levels.append(
            GridLevel(shape=cshape, h=h0 * (2**l), level=l, padded_shape=padded)
        )
    return levels


def max_levels(shape: Sequence[int], min_size: int = 3) -> int:
    """Largest usable hierarchy depth for ``shape``."""
    n = 1
    cur = tuple(int(s) for s in shape)
    while min(coarsen_shape(cur)) >= min_size:
        cur = coarsen_shape(cur)
        n += 1
    return n
