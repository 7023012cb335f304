#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

Drives the port's main path -- ``GMGSolver(cycle="v", smoother="gs",
pad_align=256).solve_refined`` at 1025^2, 6 levels, V(2,2), to 1e-8 -- and
its CLI on the card, after building the CUDA kernels from
``multigrid_prj_tpu_torch/csrc`` and holding each against its plain torch
twin at the main path's shapes.  Imports nothing of JAX.

Phases (each prints its lines; the first failure exits non-zero):
  1. device   2. build   3. kernel vs twin   4. main path (+ CPU-twin run)
  5. CLI      6. unported features raise       7. times
The line before the last is the kernel table as one JSON object; the last
line is ``{"ok": true, "device": {...}}``.  Without CUDA, or without the
rest of the repository beside it, it exits non-zero and prints no result.

Usage (from the repository root, one card):  python3 chip_smoke.py
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

SHAPE = (1025, 1025)
SOLVER_KW = dict(shape=SHAPE, length=10.0, alpha=10.0, num_levels=6,
                 cycle="v", nu=2, pre_sweeps=2, tol=1e-8, maxit=60,
                 pad_align=256)
TPU_ITERATIONS = 9  # BENCH_r05.json, vcycle_1025_ff32_iters
# the main path's (physical, logical) shapes at 1025^2 / pad 256, plus one
# exact-layout shape
KERNEL_SHAPES = [((1280, 1280), (1025, 1025)), ((640, 640), (513, 513)),
                 ((320, 320), (257, 257)), ((160, 160), (129, 129)),
                 ((80, 80), (65, 65)), ((40, 40), (33, 33)),
                 ((385, 385), None)]
KERNELS = {  # wrapper counter name -> (TPU kernel it replaces)
    "rbgs_color": "multigrid_prj_tpu/ops/pallas_stencil.py:456",
    "residual": "multigrid_prj_tpu/ops/pallas_stencil.py:313",
    "ff_residual": "multigrid_prj_tpu/ops/pallas_stencil.py:792",
}
SOURCE = "multigrid_prj_tpu_torch/csrc/stencil2d.cu"
# CPU twins vs CUDA kernels: the same ops, but the coarse matvec (cuBLAS vs
# the CPU BLAS) and the norms sum in another order on the two devices; the
# f32 cycle carries those roundings into every correction, and the last
# history entries (~1e-9) are ratios of residuals that differ at that
# level.  Measured on an H100: 1.9e-3 relative at most.
HISTORY_RTOL = 1e-2


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def kernel_inputs(torch, shape, logical, seed):
    gen = torch.Generator().manual_seed(seed)
    u, b, u_lo = (torch.randn(shape, generator=gen) for _ in range(3))
    u_lo *= 1e-8
    h = 10.0 / ((logical or shape)[0] - 1)
    return u.cuda(), b.cuda(), u_lo.cuda(), h


def kernel_calls(cs, text, u, b, u_lo, h, logical, alpha=10.0):
    """name -> (kernel call, twin call) on the same inputs."""
    d_hi, d_lo = text.ff_from_div(b, alpha / (h * h))
    ff = (u, u_lo, d_hi, d_lo, b, alpha, h, logical)
    return {
        "rbgs_color": (
            lambda: cs.red_black_gauss_seidel(u, b, alpha, h, sweeps=2,
                                              logical_shape=logical),
            lambda: cs.red_black_gauss_seidel_plain(u, b, alpha, h, 2,
                                                    logical)),
        "residual": (
            lambda: cs.poisson_residual(u, b, alpha, h, logical),
            lambda: cs.poisson_residual_plain(u, b, alpha, h, logical)),
        "ff_residual": (
            lambda: cs.ff_poisson_residual(*ff),
            lambda: cs.ff_poisson_residual_plain(*ff)),
    }


def median_ms(torch, fn, runs=30, warmup=5):
    """Median device time of ``fn`` (CUDA events, synchronised per run)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from multigrid_prj_tpu_torch.gmg import GMGSolver
    from multigrid_prj_tpu_torch.kernels import _build
    from multigrid_prj_tpu_torch.models.poisson import assemble_rhs
    from multigrid_prj_tpu_torch.ops import cuda_stencil as cs
    from multigrid_prj_tpu_torch.ops import extended as text
    from multigrid_prj_tpu_torch.utils.io import load_vector

    t_start = time.perf_counter()
    # 1. device
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(card)
    print(f"[device] {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; {torch.cuda.device_count()} visible")

    # 2. build
    info = _build.build(force=True)
    regs = [ln.strip() for ln in info["log"].splitlines()
            if "registers" in ln or "spill" in ln]
    print(f"[build] nvcc {info['seconds']:.2f} s -> {info['path']}")
    for ln in regs:
        print(f"[build] {ln}")
    _build.library()

    # 3. kernel vs twin (torch.equal at every main-path shape)
    max_err = {k: 0.0 for k in KERNELS}
    for i, (shape, logical) in enumerate(KERNEL_SHAPES):
        u, b, u_lo, h = kernel_inputs(torch, shape, logical, seed=i)
        for kname, (kern, twin) in kernel_calls(cs, text, u, b, u_lo, h,
                                                logical).items():
            got, want = kern(), twin()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            max_err[kname] = max(max_err[kname], err)
            check(torch.equal(got, want),
                  f"{kname} != twin at {shape} logical {logical} "
                  f"(max abs diff {err})")
        print(f"[kernels] {shape} logical {logical}: rbgs_color, residual, "
              f"ff_residual equal to their twins (torch.equal)")

    # 4. main path: 1025^2 ff32-refined V(2,2) solve on the card
    solver = GMGSolver(**SOLVER_KW, device="cuda")
    b = assemble_rhs(solver.levels[0], 10.0, test=1, dtype=torch.float32,
                     device="cuda")
    cs.reset_launch_counts()
    res = solver.solve_refined(b)
    torch.cuda.synchronize()
    launches = dict(cs.LAUNCHES)
    print(f"[main] solve_refined {SHAPE}: {res.iterations} iterations "
          f"(TPU: {TPU_ITERATIONS}), final rel. residual "
          f"{float(res.history[-1]):.3e}, converged={res.converged}")
    print(f"[main] history {[float(x) for x in res.history]}")
    print(f"[main] kernel launches during the solve: {launches}")
    check(res.converged and float(res.history[-1]) <= 1e-8, "not converged")
    check(abs(res.iterations - TPU_ITERATIONS) <= 1,
          f"{res.iterations} iterations, expected {TPU_ITERATIONS} +- 1")
    check(all(launches[k] > 0 for k in KERNELS),
          f"a kernel was not launched on the main path: {launches}")
    check(tuple(res.u.shape) == SHAPE and res.u.device.type == "cuda"
          and bool(torch.isfinite(res.u).all()), "bad solution tensor")

    # the same solve on the CPU through the kernels' twins
    t0 = time.perf_counter()
    ref = GMGSolver(**SOLVER_KW, device="cpu", use_pallas=True) \
        .solve_refined(b.cpu())
    print(f"[main] CPU twins: {ref.iterations} iterations in "
          f"{time.perf_counter() - t0:.1f} s")
    check(ref.iterations == res.iterations, "CPU twin iteration count differs")
    rel = float((abs(res.history - ref.history) / ref.history).max())
    u_diff = float((res.u.cpu() - ref.u).abs().max() / ref.u.abs().max())
    print(f"[main] CUDA vs CPU twins: max rel. history diff {rel:.3e} "
          f"(bound {HISTORY_RTOL}); max |du| / max |u| = {u_diff:.3e}")
    check(rel <= HISTORY_RTOL, f"histories differ beyond rtol {HISTORY_RTOL}")

    # 5. CLI on the card
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m", "multigrid_prj_tpu_torch.cli.gmg_main",
               "-n", "129", "-ml", "4", "-cycle", "v", "-pad", "256",
               "-tol", "1e-3"]
        env = dict(os.environ, PYTHONPATH=REPO)
        out = subprocess.run(cmd, cwd=tmp, env=env, capture_output=True,
                             text=True, timeout=600)
        check(out.returncode == 0, f"CLI failed:\n{out.stdout}{out.stderr}")
        check("not converged" not in out.stdout, f"CLI:\n{out.stdout}")
        hist = load_vector(os.path.join(tmp, "MGGS4.txt"))
        x = load_vector(os.path.join(tmp, "x.mtx"))
        check(hist[-1] <= 1e-3 and x.size == 129 * 129
              and bool(abs(x).max() < float("inf")), "CLI artifacts")
        print(f"[cli] {' '.join(cmd[2:])}: {len(hist) - 1} iterations to "
              f"{hist[-1]:.3e}; wrote MGGS4.txt and x.mtx ({x.size} values)")

    # 6. unported features raise on CUDA
    try:
        GMGSolver(**dict(SOLVER_KW, smoother="jacobi"), device="cuda")
        check(False, "smoother='jacobi' did not raise on CUDA")
    except NotImplementedError as exc:
        print(f"[unported] jacobi: NotImplementedError: {exc}")
    try:
        solver.solve_refined(b, inner_cg=2)
        check(False, "inner_cg=2 did not raise")
    except NotImplementedError as exc:
        print(f"[unported] inner_cg=2: NotImplementedError: {exc}")

    # 7. times at 1280^2 (warm L2: 6.5 MB per operand) and of the solve
    u, bb, u_lo, h = kernel_inputs(torch, (1280, 1280), (1025, 1025), seed=99)
    times = {}
    for kname, (kern, twin) in kernel_calls(cs, text, u, bb, u_lo, h,
                                            (1025, 1025)).items():
        times[kname] = (median_ms(torch, kern), median_ms(torch, twin))
        print(f"[time] {kname} at 1280^2: kernel {times[kname][0] * 1e3:.1f} "
              f"us, twin {times[kname][1] * 1e3:.1f} us  ({card})")
    solver.solve_refined(b)  # warm-up
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = solver.solve_refined(b)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        check(r.iterations == res.iterations, "timed solve differs")
    print(f"[time] solve_refined {SHAPE}: median wall "
          f"{statistics.median(walls) * 1e3:.2f} ms over 3 "
          f"({[round(w * 1e3, 2) for w in walls]} ms), "
          f"{res.iterations} iterations  ({card})")
    print(f"[time] chip_smoke total {time.perf_counter() - t_start:.1f} s")

    print(card)
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCE, "replaces": KERNELS[k],
         "launches": launches[k], "max_abs_err": max_err[k],
         "ms": times[k][0], "plain_ms": times[k][1]} for k in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
