"""Process-group bring-up and the rank layout of the sharded solvers
(port of ``multigrid_prj_tpu/parallel/distributed.py``).

Bring-up is env-driven and a no-op in a plain single process, so the same
entry points work everywhere.  ``torchrun`` (or any launcher) sets
``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and
``LOCAL_RANK``; :func:`maybe_initialize_distributed` then joins the process
group: NCCL when CUDA is present, gloo otherwise.

:func:`make_mesh` returns a :class:`Mesh`, the counterpart of the JAX
``("x",)`` / ``("dcn", "x")`` device mesh: the ranks that hold the grid's
slabs, in slab order (dcn-major, so consecutive slabs sit on neighbouring
ranks), and the collectives the sharded solvers use on them: the halo
exchange of the leading axis (``batch_isend_irecv`` to the global ranks
+-1, zero slabs at the global ends), ``all_reduce`` and ``all_gather``.
Routing a group's edge slab across the slow axis is a topology choice of
the JAX version; the values received are the same, so here every slab goes
straight to its neighbour rank.  Without an initialised process group the
mesh is the one-rank mesh and every collective is the identity, as on the
JAX package's one-device mesh; in a process group of one rank the
reductions and gathers still go through the backend.

Transport: under NCCL the tensors stay on the card.  gloo moves CPU tensors
only, so under gloo a CUDA tensor's halo slabs and reduction operands are
staged through host memory (that is how several ranks share one card, where
NCCL refuses two ranks on one GPU); the compute stays on the card.  The
branch is chosen by the group's backend, never taken under NCCL, and is no
fallback.
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch
import torch.distributed as dist


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def maybe_initialize_distributed() -> bool:
    """Join the process group when the environment asks for it.

    With ``WORLD_SIZE`` set (``torchrun`` sets it with ``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK`` and ``LOCAL_RANK``), initialise
    ``torch.distributed`` from those variables: NCCL when CUDA is present,
    on ``cuda:LOCAL_RANK``, gloo otherwise.  Returns True when the world has
    more than one rank.  Without the variables it does nothing and returns
    False; calling it again is safe.
    """
    if _initialized():
        return dist.get_world_size() > 1
    if "WORLD_SIZE" not in os.environ:
        return False
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ.get("RANK", "0"))
    if torch.cuda.is_available():
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method="env://", world_size=world,
                            rank=rank)
    return world > 1


class _PendingHalo:
    """An exchange in flight: :meth:`wait` returns ``(top, bottom)``."""

    def __init__(self, reqs, top, bottom, device):
        self._reqs, self._top, self._bottom = reqs, top, bottom
        self._device = device

    def wait(self):
        for req in self._reqs:
            req.wait()
        return tuple(None if t is None else t.to(self._device)
                     for t in (self._top, self._bottom))


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks that hold the slabs of a leading-axis-sharded grid.

    ``axis_names`` is ``("x",)`` or ``("dcn", "x")`` with ``axis_sizes``;
    ``ranks`` are the global ranks in slab order (``ranks[k]`` holds slab
    ``k``); ``index`` is this process's slab (``lax.axis_index`` over
    ``row_axes``), -1 on a rank outside the mesh; ``group`` is the process
    group of the collectives (None: the default group, or no group at all
    on the one-rank mesh).  ``counts`` tallies the collectives issued on
    this rank: ``halo`` counts one per direction of each exchange (the JAX
    version's ``collective_permute`` count), ``all_reduce`` and
    ``all_gather`` one per call.
    """

    axis_names: tuple
    axis_sizes: tuple
    ranks: tuple
    index: int
    group: object = None
    backend: str | None = None
    counts: dict = dataclasses.field(
        default_factory=lambda: {"halo": 0, "all_reduce": 0, "all_gather": 0},
        compare=False, repr=False)

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    def reset_counts(self) -> None:
        for k in self.counts:
            self.counts[k] = 0

    def _on_host(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.is_cuda

    def _copy_out(self, t: torch.Tensor) -> torch.Tensor:
        """A copy of ``t`` where the backend moves it (host memory under
        gloo)."""
        return t.cpu() if self._on_host(t) else t.clone()

    def _buffer(self, like: torch.Tensor, shape) -> torch.Tensor:
        return torch.empty(shape, dtype=like.dtype,
                           device="cpu" if self._on_host(like)
                           else like.device)

    def post_halo(self, u: torch.Tensor, w: int = 1, top: bool = True,
                  bottom: bool = True) -> _PendingHalo:
        """Start the exchange of ``w``-row halo slabs of ``u``'s leading
        axis: ``top`` receives the previous slab's last ``w`` rows, ``bottom``
        the next slab's first ``w`` rows (zeros at the global ends).  The
        rows this rank sends are copied before it returns, so ``u`` may be
        used at once; the halos come from :meth:`_PendingHalo.wait`."""
        self.counts["halo"] += int(top) + int(bottom)
        shape = (w,) + tuple(u.shape[1:])
        k, p = self.index, self.size
        ops = []
        recv_top = recv_bot = None
        if top and k > 0:
            recv_top = self._buffer(u, shape)
            ops.append(dist.P2POp(dist.irecv, recv_top, self.ranks[k - 1],
                                  self.group))
        if top and k < p - 1:
            ops.append(dist.P2POp(dist.isend, self._copy_out(u[-w:]),
                                  self.ranks[k + 1], self.group))
        if bottom and k < p - 1:
            recv_bot = self._buffer(u, shape)
            ops.append(dist.P2POp(dist.irecv, recv_bot, self.ranks[k + 1],
                                  self.group))
        if bottom and k > 0:
            ops.append(dist.P2POp(dist.isend, self._copy_out(u[:w]),
                                  self.ranks[k - 1], self.group))
        reqs = dist.batch_isend_irecv(ops) if ops else []
        if top and recv_top is None:
            recv_top = u.new_zeros(shape)
        if bottom and recv_bot is None:
            recv_bot = u.new_zeros(shape)
        return _PendingHalo(reqs, recv_top, recv_bot, u.device)

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``x`` summed (or maximised, ``op="max"``) over the mesh."""
        self.counts["all_reduce"] += 1
        if self.backend is None:
            return x
        y = self._copy_out(x)
        dist.all_reduce(y, {"sum": dist.ReduceOp.SUM,
                            "max": dist.ReduceOp.MAX}[op], group=self.group)
        return y.to(x.device)

    def all_gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` concatenated along the leading axis, in slab
        order (``lax.all_gather(..., tiled=True)``)."""
        self.counts["all_gather"] += 1
        if self.backend is None:
            return x
        y = self._copy_out(x)
        parts = [torch.empty_like(y) for _ in self.ranks]
        dist.all_gather(parts, y, group=self.group)
        if self.group is not None:  # list order is the group's rank order
            order = [dist.get_group_rank(self.group, r) for r in self.ranks]
        else:
            order = list(self.ranks)
        return torch.cat([parts[g] for g in order]).to(x.device)


def make_mesh(n_ici: int | None = None, n_dcn: int = 1,
              devices=None) -> Mesh:
    """The rank layout of the sharded solvers.

    ``n_dcn == 1``: a 1D ``("x",)`` mesh.  ``n_dcn > 1``: a 2D
    ``("dcn", "x")`` mesh, slabs dcn-major.  ``devices``: the global ranks
    to use, in slab order (default: every rank of the initialised process
    group, in rank order; without one, the single process).  A mesh on
    fewer ranks than the world creates a process group for them, which
    every rank must call ``make_mesh`` for.
    """
    world = dist.get_world_size() if _initialized() else 1
    ranks = list(range(world)) if devices is None else [int(r)
                                                        for r in devices]
    if n_ici is None:
        n_ici = len(ranks) // n_dcn
    need = n_ici * n_dcn
    if need < 1 or len(ranks) < need:
        raise ValueError(f"need {need} ranks, have {len(ranks)}")
    ranks = tuple(ranks[:need])
    if any(not 0 <= r < world for r in ranks) or len(set(ranks)) != need:
        raise ValueError(f"ranks {ranks} are not distinct ranks of a world "
                         f"of {world}")
    group = backend = None
    index = 0
    if _initialized():
        if need < world:  # created with the default group's backend
            group = dist.new_group(list(ranks))
        me = dist.get_rank()
        index = ranks.index(me) if me in ranks else -1
        backend = str(dist.get_backend())
    if n_dcn == 1:
        return Mesh(("x",), (n_ici,), ranks, index, group, backend)
    return Mesh(("dcn", "x"), (n_dcn, n_ici), ranks, index, group, backend)
