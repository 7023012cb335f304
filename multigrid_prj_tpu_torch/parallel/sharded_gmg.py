"""Multi-rank geometric multigrid: block-slab sharding with halo exchange,
for 2D and 3D grids (port of ``multigrid_prj_tpu/parallel/sharded_gmg.py``
on ``torch.distributed``).

* The fine grid (``(n, m)`` or ``(n, m, k)``) is block-sharded on its
  leading axis over the ranks of a :class:`~.distributed.Mesh` (``("x",)``
  or ``("dcn", "x")``, slabs dcn-major): every rank holds ``n / P``
  consecutive rows (2D) or planes (3D) and runs the same program on them.
* Each stencil or smoother pass exchanges halo slabs with the neighbour
  ranks (:meth:`Mesh.post_halo`); edge ranks receive zero slabs, which are
  the global Dirichlet boundary every op pins.  ``rbgs_local(overlap=True)``
  posts the exchange, updates the interior rows, then waits and finishes
  the two edge rows: the arithmetic of ``overlap=False``.
* Norms and the convergence test are ``all_reduce`` sums, so every rank
  takes the same loop decisions.
* Levels stay sharded while the local slab count is even; the deeper levels
  are ``all_gather``-ed and run replicated on every rank (they are tiny).
* Schedules: per colour (one exchange per colour pass), grouped (one wide
  exchange per group of <= 4 sweeps, with the residual and restriction
  fused behind it), or the kernel route (``use_pallas``): one 8-row
  exchange per group of <= 4 sweeps and the hand-written CUDA kernel
  ``ops/cuda_stencil.rbgs_fused_extended`` on the extended slab (its twin
  on a CPU tensor).

Every local op is the JAX function op for op, in plain torch (``b / c`` a
true division by a 0-dim tensor; neighbour sums ``(N + S) + E + W``), so
the schedules that JAX calls bitwise equal are bitwise equal here too.
Inputs and outputs of :class:`ShardedGMGSolver` are the rank's own slab;
:func:`scatter_slabs` and :func:`gather_slabs` convert whole grids.
"""

from __future__ import annotations

import time
from typing import Sequence, Tuple

import numpy as np
import torch

from multigrid_prj_tpu_torch.gmg import SolveResult, _np_dtype, _tol_in
from multigrid_prj_tpu_torch.gmg import v_cycle as replicated_v_cycle
from multigrid_prj_tpu_torch.grids import build_hierarchy
from multigrid_prj_tpu_torch.ops import cuda_stencil as _cs
from multigrid_prj_tpu_torch.ops.smoothers import make_smoother
from multigrid_prj_tpu_torch.ops.stencil import shift_fill_zero
from multigrid_prj_tpu_torch.ops.transfer import _fw_axis, _refine_axis
from multigrid_prj_tpu_torch.parallel.distributed import Mesh
from multigrid_prj_tpu_torch.utils.config import on_cuda_flag

AXIS = "x"  # the fast axis; an optional "dcn" axis majors it


def row_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Mesh axes the leading grid axis is sharded over (dcn-major)."""
    return ("dcn", AXIS) if "dcn" in mesh.axis_names else (AXIS,)


def global_shard_index(mesh: Mesh) -> int:
    """Linear slab index of this rank, the minor axis fastest."""
    return mesh.index


def _halo_slabs(u, mesh: Mesh, w: int = 1):
    """(top, bottom) neighbour halo slabs of ``w`` rows; zeros at the global
    ends."""
    return mesh.post_halo(u, w).wait()


def norm2_psum(x, mesh: Mesh):
    return mesh.all_reduce(torch.sum(x * x))


def _true_div(x, c: float):
    """``x / c`` as a true division on every device (torch on CUDA divides
    by a Python scalar through its rounded reciprocal)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# Local (per-shard) building blocks -- rank-generic (2D / 3D)
# ---------------------------------------------------------------------------


def _coords(shape, offset: int, device):
    """Per-axis global index tensors (broadcastable), the leading axis
    offset by ``offset``."""
    coords = []
    for ax, n in enumerate(shape):
        view = [1] * len(shape)
        view[ax] = n
        c = torch.arange(n, device=device)
        if ax == 0:
            c = c + offset
        coords.append(c.view(view))
    return coords


def _global_coords(shape_local, mesh: Mesh, device=None):
    """Per-point global index tensors (leading axis globalised)."""
    return _coords(shape_local, global_shard_index(mesh) * shape_local[0],
                   device)


def _edge_mask(coords, global_shape, shape):
    m = None
    for c, n in zip(coords, global_shape):
        this = (c == 0) | (c == n - 1)
        m = this if m is None else (m | this)
    return m.expand(tuple(shape))


def _boundary_mask_local(shape_local, global_shape, mesh: Mesh, device=None):
    return _edge_mask(_global_coords(shape_local, mesh, device),
                      global_shape, shape_local)


def _parity(coords, shape):
    return (sum(coords) % 2).expand(tuple(shape))


_shift_local = shift_fill_zero  # zero-filled shift along a local axis


def _neighbor_sum_local(u, top, bot):
    """Sum of the 2*ndim neighbours, halos supplying the leading-axis
    edges."""
    north = torch.cat([top, u[:-1]])
    south = torch.cat([u[1:], bot])
    s = north + south
    for ax in range(1, u.ndim):
        s = s + _shift_local(u, ax, +1) + _shift_local(u, ax, -1)
    return s


def _neighbor_sum_inner(u):
    """Neighbour sum of the interior slabs ``u[1:-1]`` only: needs no halo,
    so it runs while the exchange is in flight."""
    s = u[:-2] + u[2:]
    inner = u[1:-1]
    for ax in range(1, u.ndim):
        s = s + _shift_local(inner, ax, +1) + _shift_local(inner, ax, -1)
    return s


def poisson_apply_local(u, alpha, h, global_shape, mesh: Mesh):
    c = alpha / (h * h)
    top, bot = _halo_slabs(u, mesh)
    bmask = _boundary_mask_local(u.shape, global_shape, mesh, u.device)
    diag = 2.0 * u.ndim
    interior = c * (diag * u - _neighbor_sum_local(u, top, bot))
    return torch.where(bmask, u, interior)


def residual_local(u, b, alpha, h, global_shape, mesh: Mesh):
    return b - poisson_apply_local(u, alpha, h, global_shape, mesh)


def rbgs_local_pallas(u, b, alpha, h, global_shape, mesh: Mesh,
                      sweeps: int = 1):
    """Red-black GS on the local shard through the extended-slab kernel:
    ``b``'s 8-row halos are exchanged once, ``u``'s once per group of up to
    4 sweeps, and ``ops/cuda_stencil.rbgs_fused_extended`` replays the halo
    rows' updates locally (``row0`` = this slab's first global row - 8).
    Equal to :func:`rbgs_local` up to the smoother's operation order
    (``b * (1/c)``, neighbours ``N + S + E + W``)."""
    R = u.shape[0]
    row0 = global_shard_index(mesh) * R - 8
    bt, bb = _halo_slabs(b, mesh, 8)  # b is loop-constant: exchange once
    be = torch.cat([bt, b, bb])
    full, rem = divmod(sweeps, 4)
    for s in [4] * full + ([rem] if rem else []):
        ut, ub = _halo_slabs(u, mesh, 8)
        ue = torch.cat([ut, u, ub])
        u = _cs.rbgs_fused_extended(ue, be, row0, global_shape, alpha, h, s)
    return u


def rbgs_local(u, b, alpha, h, global_shape, mesh: Mesh, sweeps: int = 1,
               overlap: bool = True, pallas: bool = False):
    """Red-black GS, one halo exchange per colour pass.

    ``overlap=True`` posts the exchange, computes the interior rows, then
    waits and computes the two edge rows; ``overlap=False`` waits first and
    computes the whole block.  Both are the same arithmetic (bitwise equal).
    ``pallas=True`` sends 2D float32 shards of >= 8 rows to
    :func:`rbgs_local_pallas`.
    """
    if pallas and u.shape[0] >= 8 and _cs.fused_extended_supported(
            u.shape, u.dtype):
        return rbgs_local_pallas(u, b, alpha, h, global_shape, mesh, sweeps)
    c = alpha / (h * h)
    coords = _global_coords(u.shape, mesh, u.device)
    bmask = _edge_mask(coords, global_shape, u.shape)
    parity = _parity(coords, u.shape)
    inv_diag = 1.0 / (2.0 * u.ndim)
    b_over_c = _true_div(b, c)

    def one_color(u, color):
        pending = mesh.post_halo(u)
        if overlap:
            gs_inner = (b_over_c[1:-1] + _neighbor_sum_inner(u)) * inv_diag
            top, bot = pending.wait()
            first, last = u[:1], u[-1:]
            ns_first = top + u[1:2]
            ns_last = u[-2:-1] + bot
            for ax in range(1, u.ndim):
                ns_first = (ns_first + _shift_local(first, ax, +1)
                            + _shift_local(first, ax, -1))
                ns_last = (ns_last + _shift_local(last, ax, +1)
                           + _shift_local(last, ax, -1))
            gs_first = (b_over_c[:1] + ns_first) * inv_diag
            gs_last = (b_over_c[-1:] + ns_last) * inv_diag
            gs = torch.cat([gs_first, gs_inner, gs_last])
        else:
            top, bot = pending.wait()
            gs = (b_over_c + _neighbor_sum_local(u, top, bot)) * inv_diag
        u = torch.where((parity == color) & ~bmask, gs, u)
        return torch.where(bmask, b, u)

    for _ in range(sweeps):
        u = one_color(u, 0)
        u = one_color(u, 1)
    return u


# ---------------------------------------------------------------------------
# Wide-halo grouped sweeps: one halo exchange per sweep group (and the
# residual and restriction fused behind it).  rbgs_local exchanges per
# colour pass; here one exchange ships w = 2*sweeps + extra slabs of u (b's
# come once per level visit), the sweeps run exchange-free on the extended
# block (its outer rows go stale by one slab per colour pass; the centre
# stays exact while 2*sweeps + extra <= w), and the residual and
# restriction read the still-valid +-1 halo rows.
# ---------------------------------------------------------------------------

_MAX_GROUP_SWEEPS = 4


def _split_groups(sweeps: int):
    full, rem = divmod(sweeps, _MAX_GROUP_SWEEPS)
    return [_MAX_GROUP_SWEEPS] * full + ([rem] if rem else [])


def group_supported(R: int, sweeps: int, extra: int = 2) -> bool:
    """Every group's halo width must fit the local slab count (a w-slab halo
    only reaches the nearest neighbour shard)."""
    w_max = 2 * min(max(sweeps, 1), _MAX_GROUP_SWEEPS) + extra
    return R % 2 == 0 and w_max <= R


def group_max_w(sweeps: int, tail_extra: int) -> int:
    """Widest halo any group of a ``sweeps``-sweep run requests (the shared
    ``b_halos`` exchange must cover it)."""
    groups = _split_groups(sweeps) or [0]
    return max(2 * s + (tail_extra if i == len(groups) - 1 else 0)
               for i, s in enumerate(groups))


def _ext_masks(shape_ext, row0, global_shape, device):
    """(boundary, parity) of an extended block whose first row is global
    row ``row0``: rows outside the domain are boundary too."""
    coords = _coords(shape_ext, row0, device)
    lead = coords[0]
    bmask = (lead < 0) | (lead > global_shape[0] - 1)
    for cc, n in zip(coords, global_shape):
        bmask = bmask | (cc == 0) | (cc == n - 1)
    return bmask.expand(tuple(shape_ext)), _parity(coords, shape_ext)


def _rbgs_sweeps_ext(ue, be, row0, global_shape, alpha, h, sweeps: int):
    """``sweeps`` whole-block RB-GS sweeps on a halo-extended block, with no
    exchange, in the operation order of ``rbgs_local(overlap=False)``.  Rows
    outside the domain are pinned to ``be`` (zeros from the edge
    exchange)."""
    c = alpha / (h * h)
    bmask, parity = _ext_masks(ue.shape, row0, global_shape, ue.device)
    inv_diag = 1.0 / (2.0 * ue.ndim)
    b_over_c = _true_div(be, c)

    def nsum(u):
        z = torch.zeros_like(u[:1])
        s = torch.cat([z, u[:-1]]) + torch.cat([u[1:], z])
        for ax in range(1, u.ndim):
            s = s + _shift_local(u, ax, +1) + _shift_local(u, ax, -1)
        return s

    u = ue
    for _ in range(sweeps):
        for color in (0, 1):
            gs = (b_over_c + nsum(u)) * inv_diag
            u = torch.where((parity == color) & ~bmask, gs, u)
            u = torch.where(bmask, be, u)
    return u


def _residual_ext(ue, be, row0, global_shape, alpha, h):
    """Residual on the interior rows ``ue[1:-1]`` of an extended block, with
    no exchange, in :func:`residual_local`'s order.  ``row0`` is the global
    row of ``ue[0]``."""
    c = alpha / (h * h)
    inner = ue[1:-1]
    ns = ue[:-2] + ue[2:]
    for ax in range(1, ue.ndim):
        ns = ns + _shift_local(inner, ax, +1) + _shift_local(inner, ax, -1)
    bmask, _ = _ext_masks(inner.shape, row0 + 1, global_shape, ue.device)
    diag = 2.0 * ue.ndim
    Au = torch.where(bmask, inner, c * (diag * inner - ns))
    return be[1:-1] - Au


def _grouped_sweeps(u, b, alpha, h, global_shape, mesh: Mesh, sweeps: int,
                    tail_extra: int, b_halos=None):
    """Grouped wide-halo sweeps; returns ``(u, ue, be, w_last)``, ``ue`` /
    ``be`` the last group's extended blocks (halo width
    ``w_last = 2*s + tail_extra``, so ``tail_extra`` rows each side are
    still valid for a fused residual).  ``b_halos = (bt_W, bb_W, W)``:
    ``b``'s halos, exchanged once per level visit at a width ``W`` that
    covers every group."""
    R = u.shape[0]
    gsi = global_shard_index(mesh)
    groups = _split_groups(sweeps) or [0]
    ue = be = None
    w = 0
    for gi, s in enumerate(groups):
        last = gi == len(groups) - 1
        w = 2 * s + (tail_extra if last else 0)
        ut, ub = _halo_slabs(u, mesh, w)
        if b_halos is not None:
            bt_w, bb_w, W = b_halos
            bt, bb = bt_w[W - w:], bb_w[:w]
        else:
            bt, bb = _halo_slabs(b, mesh, w)
        ue = torch.cat([ut, u, ub])
        be = torch.cat([bt, b, bb])
        if s:
            ue = _rbgs_sweeps_ext(ue, be, gsi * R - w, global_shape,
                                  alpha, h, s)
        u = ue[w: w + R]
    return u, ue, be, w


def downleg_group_local(u, b, alpha, h, global_shape, mesh: Mesh,
                        sweeps: int, b_halos=None):
    """Fused down-leg (grouped sweeps + residual + full-weighting restrict):
    one exchange of ``u`` per group (and ``b``'s unless shared).  Returns
    ``(u_smoothed, r_coarse)``."""
    R = u.shape[0]
    gsi = global_shard_index(mesh)
    u, ue, be, w = _grouped_sweeps(u, b, alpha, h, global_shape, mesh,
                                   sweeps, tail_extra=2, b_halos=b_halos)
    # residual on rows gsi*R - 1 .. gsi*R + R (the restriction's rp)
    rp = _residual_ext(ue[w - 2: w + R + 2], be[w - 2: w + R + 2],
                       gsi * R - 2, global_shape, alpha, h)
    return u, _restrict_from_rp(rp, global_shape, mesh)


def postsmooth_group_local(u, b, alpha, h, global_shape, mesh: Mesh,
                           sweeps: int, resnorm: bool = False, b_halos=None):
    """Grouped post-smoothing; with ``resnorm`` also the local residual sum
    of squares (no extra exchange; the caller sums it over the mesh)."""
    R = u.shape[0]
    gsi = global_shard_index(mesh)
    u, ue, be, w = _grouped_sweeps(u, b, alpha, h, global_shape, mesh,
                                   sweeps, tail_extra=1 if resnorm else 0,
                                   b_halos=b_halos)
    if not resnorm:
        return u
    r = _residual_ext(ue[w - 1: w + R + 1], be[w - 1: w + R + 1],
                      gsi * R - 1, global_shape, alpha, h)
    return u, torch.sum(r * r)


def _restrict_from_rp(rp, global_shape, mesh: Mesh):
    """Full-weighting restriction given the halo-extended residual ``rp``
    (``R + 2`` slabs: 1 top halo, R local, 1 bottom halo), with no exchange;
    the trailing axes are local (``ops/transfer._fw_axis``)."""
    R = rp.shape[0] - 2
    n_global = global_shape[0]
    rows = 0.25 * rp[0:R:2] + 0.5 * rp[1: R + 1: 2] + 0.25 * rp[2: R + 2: 2]
    Rc = R // 2
    nc = (n_global + 1) // 2
    grow = _coords(rows.shape, global_shard_index(mesh) * Rc, rp.device)[0]
    # the global low edge is injected (the Dirichlet slab); the high edge is
    # injected for odd n and zero for even n (a fake coarse boundary carries
    # no residual; see ops/transfer._fw_axis)
    rows = torch.where(grow == 0, rp[1: R + 1: 2], rows)
    if n_global % 2 == 0:
        rows = torch.where(grow == nc - 1, torch.zeros((), dtype=rows.dtype,
                                                       device=rows.device),
                           rows)
    else:
        rows = torch.where(grow == nc - 1, rp[1: R + 1: 2], rows)
    for ax in range(1, rp.ndim):
        rows = _fw_axis(rows, ax)
    return rows


def restrict_fw_local(r, global_shape, mesh: Mesh):
    """Full-weighting restriction of a leading-axis shard (R slabs ->
    R/2)."""
    top, bot = _halo_slabs(r, mesh)
    return _restrict_from_rp(torch.cat([top, r, bot]), global_shape, mesh)


def prolong_local(e, fine_slabs: int, fine_trailing: Tuple[int, ...],
                  mesh: Mesh):
    """Linear prolongation of a coarse shard (Rc slabs) to its fine shard
    (R = 2 Rc slabs), pulling one coarse halo slab from the next shard (the
    only direction it reads); the trailing axes refine locally."""
    _, bot = mesh.post_halo(e, top=False).wait()
    # the last shard clamps to its own last slab (general-n edge handling)
    if global_shard_index(mesh) == mesh.size - 1:
        bot = e[-1:]
    nxt = torch.cat([e[1:], bot])
    mid = 0.5 * (e + nxt)
    Rc = e.shape[0]
    inter = torch.stack([e, mid], dim=1).reshape(
        (2 * Rc,) + tuple(e.shape[1:]))
    out = inter[:fine_slabs]
    for ax, target in enumerate(fine_trailing, start=1):
        out = _refine_axis(out, ax, int(target))
    return out


# ---------------------------------------------------------------------------
# Whole grids <-> slabs
# ---------------------------------------------------------------------------


def scatter_slabs(x, mesh: Mesh, device=None):
    """This rank's slab of a global array every rank holds (numpy or
    tensor): rows ``index * R .. (index + 1) * R`` of the leading axis, on
    ``device`` (default: where ``x`` is), contiguous."""
    x = torch.as_tensor(x)
    R = x.shape[0] // mesh.size
    if R * mesh.size != x.shape[0]:
        raise ValueError(f"leading extent {x.shape[0]} does not split over "
                         f"{mesh.size} ranks")
    k = global_shard_index(mesh)
    return x[k * R:(k + 1) * R].to(device or x.device).contiguous()


def gather_slabs(u, mesh: Mesh):
    """The global array from every rank's slab, on every rank."""
    return mesh.all_gather_rows(u)


# ---------------------------------------------------------------------------
# The sharded solver
# ---------------------------------------------------------------------------


class ShardedGMGSolver:
    """Block-slab-sharded GMG V-cycle solver over a ``("x",)`` or
    ``("dcn", "x")`` rank mesh, for 2D and 3D Poisson problems.

    ``num_sharded`` levels run distributed with halo exchange; deeper
    levels are gathered and run replicated.  Requires the leading extent
    divisible by ``2 * P`` on every sharded level.  Arguments are the JAX
    solver's, plus ``device`` (the card unless the caller names another).
    ``use_pallas``: ``True`` / ``False``, or ``"auto"`` / ``None`` for "on
    CUDA": 2D float32 slabs of >= 8 rows smooth through
    ``rbgs_fused_extended`` (the CUDA kernel on the card, its twin on a CPU
    tensor).  ``use_grouped``: ``True`` / ``False``, ``"auto"`` (grouped on
    CUDA, per colour on the CPU, as the JAX package on TPU / CPU) or
    ``"measure"`` (time one chain of cycles per schedule at construction
    and keep the faster; recorded in ``schedule_decision``).
    """

    def __init__(
        self,
        shape: Sequence[int],
        mesh: Mesh,
        length: float = 10.0,
        alpha: float = 10.0,
        num_levels: int = 4,
        nu1: int = 2,
        nu2: int = 2,
        coarse_sweeps: int = 100,
        tol: float = 1e-6,
        maxit: int = 100,
        min_rows_per_shard: int = 8,
        use_pallas: bool | str | None = "auto",
        use_grouped: bool | str = "auto",
        device="cuda",
    ):
        if len(shape) not in (2, 3):
            raise ValueError("sharded solver supports 2D and 3D grids")
        self.device = torch.device(device)
        self.use_pallas = on_cuda_flag(use_pallas, self.device, "use_pallas")
        measure = use_grouped == "measure"
        if use_grouped in ("auto", "measure"):
            self.use_grouped = self.device.type == "cuda"
            decision_mode = "device-heuristic"
        else:
            self.use_grouped = on_cuda_flag(use_grouped, self.device,
                                            "use_grouped")
            decision_mode = "explicit"
        self.schedule_decision = {
            "mode": decision_mode,
            "chosen": "grouped" if self.use_grouped else "per_color",
        }
        self.mesh = mesh
        self.p = mesh.size
        if mesh.index < 0:
            raise ValueError("this rank holds no slab of the mesh")
        self.levels = build_hierarchy(shape, length, num_levels)
        self.alpha = float(alpha)
        self.nu1, self.nu2 = nu1, nu2
        self.coarse_sweeps = coarse_sweeps
        self.tol, self.maxit = float(tol), int(maxit)

        # a sharded level restricts R -> R/2 slabs locally, so it needs n
        # divisible by 2*P and enough slabs per shard to be worth it
        ls = 0
        for lev in self.levels[:-1]:
            n = lev.shape[0]
            if n % (2 * self.p) == 0 and n // self.p >= min_rows_per_shard:
                ls += 1
            else:
                break
        if ls == 0:
            raise ValueError(
                f"leading extent {shape[0]} not shardable over {self.p} "
                f"shards (need divisibility and >= {min_rows_per_shard} "
                "slabs/shard)"
            )
        self.num_sharded = min(ls, len(self.levels))
        self.smoother = make_smoother("gs")
        if measure:
            self._measure_schedule()

    def local_shape(self) -> Tuple[int, ...]:
        """Shape of this rank's slab of the finest grid."""
        shape = self.levels[0].shape
        return (shape[0] // self.p,) + tuple(shape[1:])

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _measure_schedule(self, chain: int = 8, reps: int = 3) -> None:
        """Time ``chain`` cycles per sweep schedule on this mesh and keep
        the faster (each rank's best wall, the slowest rank's counts, so
        every rank decides alike); recorded in ``schedule_decision``."""
        b = torch.ones(self.local_shape(), dtype=torch.float32,
                       device=self.device)
        u0 = torch.zeros_like(b)
        times = {}
        prev = self.use_grouped
        try:
            for name, g in (("grouped", True), ("per_color", False)):
                self.use_grouped = g

                def run():
                    u = u0
                    for _ in range(chain):
                        u = self._v_local(u, b, 0)
                    self._sync()

                run()  # warm-up
                best = float("inf")
                for _ in range(reps):
                    self._sync()
                    t0 = time.perf_counter()
                    run()
                    best = min(best, time.perf_counter() - t0)
                t = torch.tensor(best / chain, dtype=torch.float64)
                times[name] = float(self.mesh.all_reduce(t, op="max"))
        finally:
            self.use_grouped = prev
        self.use_grouped = times["grouped"] <= times["per_color"]
        self.schedule_decision = {
            "mode": "measured",
            "chosen": "grouped" if self.use_grouped else "per_color",
            "grouped_cycle_s": times["grouped"],
            "per_color_cycle_s": times["per_color"],
        }

    # -- sharded V-cycle -----------------------------------------------------

    def _pallas_ok(self, u) -> bool:
        return (self.use_pallas and u.shape[0] >= 8
                and _cs.fused_extended_supported(u.shape, u.dtype))

    def _downleg(self, u, b, gshape, h, b_halos=None):
        """Pre-smooth + residual + restrict with the fewest exchanges the
        shard shape allows."""
        a, mesh = self.alpha, self.mesh
        if self._pallas_ok(u):
            u = rbgs_local_pallas(u, b, a, h, gshape, mesh, self.nu1)
        elif self.use_grouped and group_supported(u.shape[0], self.nu1,
                                                  extra=2):
            return downleg_group_local(u, b, a, h, gshape, mesh, self.nu1,
                                       b_halos=b_halos)
        else:
            u = rbgs_local(u, b, a, h, gshape, mesh, self.nu1)
        r = residual_local(u, b, a, h, gshape, mesh)
        return u, restrict_fw_local(r, gshape, mesh)

    def _postsmooth(self, u, b, gshape, h, resnorm: bool = False,
                    b_halos=None):
        a, mesh = self.alpha, self.mesh
        if self._pallas_ok(u):
            u = rbgs_local_pallas(u, b, a, h, gshape, mesh, self.nu2)
        elif self.use_grouped and group_supported(
                u.shape[0], self.nu2, extra=1 if resnorm else 0):
            return postsmooth_group_local(u, b, a, h, gshape, mesh,
                                          self.nu2, resnorm=resnorm,
                                          b_halos=b_halos)
        else:
            u = rbgs_local(u, b, a, h, gshape, mesh, self.nu2)
        if not resnorm:
            return u
        r = residual_local(u, b, a, h, gshape, mesh)
        return u, torch.sum(r * r)

    def _shared_b_halos(self, u, b, resnorm: bool):
        """Exchange ``b``'s halos once per level visit when both grouped legs
        run (``b`` is constant between them), at the widest width either
        requests."""
        if not self.use_grouped or self._pallas_ok(u):
            return None
        R = u.shape[0]
        if not (group_supported(R, self.nu1, extra=2)
                and group_supported(R, self.nu2,
                                    extra=1 if resnorm else 0)):
            return None
        W = max(group_max_w(self.nu1, 2),
                group_max_w(self.nu2, 1 if resnorm else 0))
        if W > R:
            return None
        bt, bb = _halo_slabs(b, self.mesh, W)
        return bt, bb, W

    def _v_local(self, u, b, level: int, resnorm: bool = False):
        lev = self.levels[level]
        gshape = lev.shape
        h = lev.h
        b_halos = self._shared_b_halos(u, b, resnorm)
        u, rc = self._downleg(u, b, gshape, h, b_halos=b_halos)
        nlev = self.levels[level + 1]
        if level + 1 < self.num_sharded:
            ec = self._v_local(torch.zeros_like(rc), rc, level + 1)
        else:
            # gather the coarse residual, run the remaining levels replicated
            r_full = self.mesh.all_gather_rows(rc)
            e_full = replicated_v_cycle(
                torch.zeros_like(r_full), r_full, self.levels[level + 1:],
                self.alpha, self.smoother, nu1=self.nu1, nu2=self.nu2,
                coarse_sweeps=self.coarse_sweeps,
            )
            rc_rows = nlev.shape[0] // self.p
            i = global_shard_index(self.mesh)
            ec = e_full[i * rc_rows:(i + 1) * rc_rows]
        u = u + prolong_local(ec, u.shape[0], gshape[1:], self.mesh)
        return self._postsmooth(u, b, gshape, h, resnorm=resnorm,
                                b_halos=b_halos)

    def _solve_local(self, u, b):
        lev0 = self.levels[0]
        gshape = lev0.shape
        a, h = self.alpha, lev0.h
        mesh = self.mesh
        b2 = norm2_psum(b, mesh)
        tol = _tol_in(self.tol, b.dtype)

        def rel(rn2):
            return float(torch.sqrt(rn2 / b2))

        hist = [rel(norm2_psum(residual_local(u, b, a, h, gshape, mesh),
                               mesh))]
        k = 0
        while k < self.maxit and hist[k] > tol:
            # the convergence residual comes fused out of the level-0
            # post-smoothing (no extra exchange on the grouped path)
            u, rn2_local = self._v_local(u, b, 0, resnorm=True)
            hist.append(rel(mesh.all_reduce(rn2_local)))
            k += 1
        return u, k, np.asarray(hist, dtype=_np_dtype(b.dtype))

    # -- public API ----------------------------------------------------------

    def _input(self, x, name):
        x = torch.as_tensor(x, device=self.device) if isinstance(
            x, np.ndarray) else x
        if x.device.type != self.device.type:
            raise ValueError(f"{name} is on {x.device}, the solver on "
                             f"{self.device}")
        if tuple(x.shape) != self.local_shape():
            raise ValueError(f"{name} has shape {tuple(x.shape)}; this rank's "
                             f"slab is {self.local_shape()} (see "
                             "scatter_slabs)")
        return x.contiguous()

    def solve(self, b, u0=None) -> SolveResult:
        """Solve from this rank's slab of ``b`` (and ``u0``); returns this
        rank's slab of ``u`` and the global history (equal on every
        rank)."""
        b = self._input(b, "b")
        u0 = torch.zeros_like(b) if u0 is None else self._input(u0, "u0")
        u, k, hist = self._solve_local(u0, b)
        return SolveResult(u=u, history=hist, iterations=k,
                           converged=bool(hist[k] <= _tol_in(self.tol,
                                                             b.dtype)))

    def step(self, u, b):
        """One sharded V-cycle on this rank's slabs."""
        return self._v_local(self._input(u, "u"), self._input(b, "b"), 0)
