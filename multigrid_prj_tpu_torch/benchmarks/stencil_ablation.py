"""Ablation microbench for the 2D stencil kernels on the card: isolates which
piece (the streaming pipeline, east/west neighbours, north/south halos, the
boundary mask, read-once row marching) costs bandwidth.

Counterpart of ``benchmarks/stencil_ablation.py`` (the TPU's Pallas probes):
the same variants, names and output, with hand-written CUDA kernels in
``csrc/ablation.cu`` (``probe_copy`` ... ``probe_carry``; the table there
says what each computes).  Each ``v_*(r, device)`` returns a callable on an
(N, M) f32 tensor that launches its kernel for a CUDA tensor and runs the
plain twin ``v_*_plain`` (the kernel's operation order, each step a
separate torch op) for a CPU tensor; ``r`` is the TPU probe's block height,
here the rows one CUDA block covers.  There is no fallback: a failed build
or launch raises.

    python -m multigrid_prj_tpu_torch.benchmarks.stencil_ablation [-device cpu]

Prints ms per apply and GB/s of *effective* traffic (read u once + write y
once = 8 B/point) for each variant, so numbers are directly comparable.
On the card each chain is one CUDA graph (``benchmarks/program.py``), as
the JAX harness jits its chain into one program.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from multigrid_prj_tpu_torch.benchmarks.program import Program
from multigrid_prj_tpu_torch.ops.cuda_stencil import (
    LAUNCHES,
    _lib,
    _ptr,
    _raise_on,
    _stream,
)

N = 8192
M = 8192


ITERS = 24

# kernel kinds of csrc/ablation.cu's mg_probe_neighbour
_NEIGHBOUR = {"rolls": 0, "shifts": 1, "halo": 2, "full": 3}


def timeit(mk_chain, u, iters=ITERS):
    """Overhead-corrected: time a (5+iters)-chain minus a 5-chain so launch
    and fence latency cancel (the JAX harness's method); best of 4, with
    ``torch.cuda.synchronize()`` fences around the host timers."""
    few, many = (Program(mk_chain(k), u) for k in (5, 5 + iters))
    few()
    many()
    best = float("inf")
    for _i in range(4):
        t0 = time.perf_counter()
        few()
        t1 = time.perf_counter()
        many()
        t2 = time.perf_counter()
        d = (t2 - t1) - (t1 - t0)
        if d > 0:
            best = min(best, d)
    return best / iters


def chain(apply_fn):
    def mk(iters):
        def f(u):
            for _ in range(iters):
                u = apply_fn(u)
            return u

        return f

    return mk


def make_u(device="cuda"):
    i = torch.arange(N, dtype=torch.float32, device=device)[:, None]
    j = torch.arange(M, dtype=torch.float32, device=device)[None, :]
    return (torch.sin(0.01 * i) * torch.cos(0.013 * j)).contiguous()


def report(name, dt):
    eff = 8.0 * N * M / dt / 1e9
    print(f"{name:30s} {dt*1e3:8.3f} ms   {eff:7.1f} GB/s effective")


# -- plain twins ----------------------------------------------------------------


def _boundary(u):
    """Rows 0 and n-1, columns 0 and m-1 (``v_full``'s mask)."""
    n, m = u.shape
    row = torch.arange(n, device=u.device)[:, None]
    col = torch.arange(m, device=u.device)[None, :]
    return (row == 0) | (row >= n - 1) | (col == 0) | (col >= m - 1)


def v_copy_plain(u):
    return u + 1.0


def v_rolls_plain(u):
    """West = u[:, j-1 mod M], east = u[:, j+1 mod M] (``pltpu.roll``)."""
    return (4.0 * u - torch.roll(u, -1, 1)) - torch.roll(u, 1, 1)


def v_shifts_plain(u):
    """As ``v_rolls_plain`` with the columns clamped at the edges."""
    west = torch.cat([u[:, :1], u[:, :-1]], dim=1)
    east = torch.cat([u[:, 1:], u[:, -1:]], dim=1)
    return (4.0 * u - east) - west


def v_halo_plain(u):
    """North/south from the TPU probe's clamped 8-row halo blocks: row 0's
    north is u[7], row n-1's south is u[n-8]."""
    n = u.shape[0]
    north = torch.cat([u[7:8], u[:-1]])
    south = torch.cat([u[1:], u[n - 8:n - 7]])
    return (4.0 * u - north) - south


def v_full_plain(u):
    north = torch.cat([u[:1], u[:-1]])
    south = torch.cat([u[1:], u[-1:]])
    west = torch.roll(u, 1, 1)
    east = torch.roll(u, -1, 1)
    stencil = 0.1 * ((((4.0 * u - north) - south) - east) - west)
    return torch.where(_boundary(u), u, stencil)


def v_carry_plain(u, r):
    """``v_full``'s values the carry kernel's way: segment by segment of
    ``r`` rows, each from its rows plus one halo row above and below."""
    n, m = u.shape
    zero = u.new_zeros((1, m))
    mask = _boundary(u)
    out = torch.empty_like(u)
    for r0 in range(0, n, r):
        r1 = min(r0 + r, n)
        slab = torch.cat([u[r0 - 1:r0] if r0 > 0 else zero, u[r0:r1],
                          u[r1:r1 + 1] if r1 < n else zero])
        c = slab[1:-1]
        west = torch.roll(c, 1, 1)
        east = torch.roll(c, -1, 1)
        s = 0.1 * ((((4.0 * c - slab[:-2]) - slab[2:]) - east) - west)
        out[r0:r1] = torch.where(mask[r0:r1], c, s)
    return out


# -- kernels --------------------------------------------------------------------


def _check(name, u, r, kind):
    if u.dtype != torch.float32 or u.ndim != 2 or not u.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous 2D float32 tensor, got "
                         f"{u.dtype} {tuple(u.shape)}")
    n, m = u.shape
    if r <= 0 or n % r:
        raise ValueError(f"{name}: R={r} must divide the {n} rows (the TPU "
                         "probe's grid of N // R blocks)")
    if kind in ("halo", "full", "carry") and (r % 8 or n < 8):
        raise ValueError(f"{name}: R={r} and the {n} rows must be multiples "
                         "of the 8-row halo blocks")
    if kind == "copy" and (m % 4 or u.data_ptr() % 16):
        raise ValueError(f"{name}: float4 rows need M % 4 == 0, got {m}")


def _launch(kind, u, r):
    name = f"probe_{kind}"
    _check(name, u, r, kind)
    n, m = u.shape
    out = torch.empty_like(u)
    lib = _lib()
    if kind == "copy":
        err = lib.mg_probe_copy(_ptr(u), _ptr(out), n, m, r, _stream())
    elif kind == "carry":
        err = lib.mg_probe_carry(_ptr(u), _ptr(out), n, m, r, _stream())
    else:
        err = lib.mg_probe_neighbour(_ptr(u), _ptr(out), n, m, r,
                                     _NEIGHBOUR[kind], _stream())
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return out


def _variant(kind, plain):
    def make(r, device="cuda"):
        want = torch.device(device).type

        def apply(u):
            if u.device.type != want:
                raise ValueError(f"v_{kind}(R={r}) was made for {want}, got "
                                 f"a tensor on {u.device}")
            if want == "cpu":
                return plain(u, r) if kind == "carry" else plain(u)
            return _launch(kind, u, r)

        return apply

    make.__name__ = f"v_{kind}"
    make.plain = plain
    make.__doc__ = (f"The ``{kind}`` probe with R-row blocks: a callable "
                    f"that launches ``probe_{kind}`` (CUDA) or runs "
                    f"``v_{kind}_plain`` (CPU).")
    return make


# -- variants -------------------------------------------------------------------

v_copy = _variant("copy", v_copy_plain)
v_rolls = _variant("rolls", v_rolls_plain)
v_shifts = _variant("shifts", v_shifts_plain)
v_halo = _variant("halo", v_halo_plain)
v_full = _variant("full", v_full_plain)
v_carry = _variant("carry", v_carry_plain)

VARIANTS = [
    ("copy+1", v_copy, (64, 128, 256)),
    ("rolls(E/W)", v_rolls, (64, 128, 256)),
    ("shifts(E/W concat)", v_shifts, (64, 128, 256)),
    ("halo(N/S)", v_halo, (32, 64)),
    ("full current", v_full, (32, 64)),
    ("carry full", v_carry, (32, 64)),
]


def main(argv=None):
    """Time every variant at every R; returns ``[(name, r, seconds)]``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("stencil_ablation: no CUDA device (use -device cpu for the "
              "plain twins)", file=sys.stderr)
        raise SystemExit(1)
    u = make_u(args.device)
    out = []
    for name, mk, rs in VARIANTS:
        for r in rs:
            dt = timeit(chain(mk(r, args.device)), u)
            report(f"{name} R={r}", dt)
            out.append((name, r, dt))
    return out


if __name__ == "__main__":
    main()
