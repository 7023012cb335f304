#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

Drives the port's 2D GMG paths on the card through ``GMGSolver`` and the
``gmg_main`` CLI, after building the CUDA kernels from
``multigrid_prj_tpu_torch/csrc`` and holding each against its plain torch
twin at the paths' shapes.  Imports nothing of JAX.  The paths:

* main: ``solve_refined`` at 1025^2, 6 levels, V(2,2), pad 256, to 1e-8;
* at scale: the same at 8193^2, 8 levels, to 1e-7, plain and with
  ``inner_cg=4`` (``benchmarks/scale_bench.py``'s solve);
* 1025^2 with ``inner_cg=4``, and with the Jacobi smoother (omega 0.8);
* the options that run plain ops on CUDA (``use_pallas=False``, SOR);
* the CLI with ``-smt 0``, ``-smt 1`` and ``-smt 2``.

Phases (each prints its lines and its seconds; the first failure exits
non-zero):
  1. device   2. build   3. kernel vs twin   4. main path (+ CPU-twin run)
  5. 8193^2   6. 1025^2 inner_cg / Jacobi (+ CPU-twin runs)   7. plain ops
  8. CLI      9. unported features raise   10. times
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
SCALE_KW = dict(SOLVER_KW, shape=(8193, 8193), num_levels=8, tol=1e-7,
                maxit=200)
# benchmarks/SCALING_r05.json, single_chip: ff32_8193_plain / ff32_8193
SCALE_ITERATIONS = {0: 9, 4: 4}
# 1025^2 variants: the JAX package on the CPU (XLA order) takes 15
# iterations with Jacobi omega 0.8 and 4 with inner_cg=4
JACOBI_KW = dict(SOLVER_KW, smoother="jacobi", omega=0.8)
JACOBI_ITERATIONS = 15
INNER_CG_ITERATIONS = 4
# (physical, logical) shapes of the 1025^2 / pad 256 path, one exact-layout
# shape, and the levels of the 8193^2 / pad 256 path
KERNEL_SHAPES = [((1280, 1280), (1025, 1025)), ((640, 640), (513, 513)),
                 ((320, 320), (257, 257)), ((160, 160), (129, 129)),
                 ((80, 80), (65, 65)), ((40, 40), (33, 33)),
                 ((385, 385), None),
                 ((8448, 8448), (8193, 8193)), ((4224, 4224), (4097, 4097)),
                 ((2112, 2112), (2049, 2049)), ((1056, 1056), (1025, 1025)),
                 ((528, 528), (513, 513)), ((264, 264), (257, 257)),
                 ((132, 132), (129, 129)), ((66, 66), (65, 65))]
TIME_SHAPES = [((1280, 1280), (1025, 1025)), ((8448, 8448), (8193, 8193))]
_PS = "multigrid_prj_tpu/ops/pallas_stencil.py"
KERNELS = {  # wrapper counter name -> TPU kernel it replaces
    "rbgs_color": f"{_PS}:456",
    "residual": f"{_PS}:313",
    "ff_residual": f"{_PS}:792",
    "apply": f"{_PS}:287",
    "jacobi": f"{_PS}:962",
    "restrict_fw": f"{_PS}:541",
    "prolong_add": f"{_PS}:631",
}
SOURCE = "multigrid_prj_tpu_torch/csrc/stencil2d.cu"
# CPU twins vs CUDA kernels: the same ops, but the coarse matvec (cuBLAS vs
# the CPU BLAS) and the norms and dot products sum in another order on the
# two devices; the f32 cycle carries those roundings into every correction,
# and the last history entries (~1e-9) are ratios of residuals that differ
# at that level.  Measured on an H100: 1.9e-3 relative at most (GS solve).
# Entries near 1e-11 sit at the round-off floor of the extended residual
# (129^2 inner_cg on an H100: 8.7e-12 against 8.4e-12): the absolute term.
HISTORY_RTOL = 1e-2
HISTORY_ATOL = 1e-12
# inner_cg: each refinement step reduces the residual ~1e3x, so the late
# entries are set by the f32 round-off of the inner CG (its dot products sum
# in another order on the two devices) and by the low words of the pair-
# carried solution; measured on an H100 at 1025^2: 2.7e-2 relative at most
# (the cropped f32 solutions were identical)
INNER_CG_HISTORY_RTOL = 1e-1


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
    """name -> [(label, kernel call, twin call)] on the same inputs."""
    d_hi, d_lo = text.ff_from_div(b, alpha / (h * h))
    ff = (u, u_lo, d_hi, d_lo, b, alpha, h, logical)
    calls = {
        "rbgs_color": [(
            "sweeps 2",
            lambda: cs.red_black_gauss_seidel(u, b, alpha, h, sweeps=2,
                                              logical_shape=logical),
            lambda: cs.red_black_gauss_seidel_plain(u, b, alpha, h, 2,
                                                    logical))],
        "residual": [(
            "",
            lambda: cs.poisson_residual(u, b, alpha, h, logical),
            lambda: cs.poisson_residual_plain(u, b, alpha, h, logical))],
        "ff_residual": [(
            "",
            lambda: cs.ff_poisson_residual(*ff),
            lambda: cs.ff_poisson_residual_plain(*ff))],
        "apply": [(
            "",
            lambda: cs.poisson_apply(u, alpha, h, logical),
            lambda: cs.poisson_apply_plain(u, alpha, h, logical))],
        "jacobi": [(
            f"sweeps 2, omega {w}",
            lambda w=w: cs.jacobi(u, b, alpha, h, omega=w, sweeps=2,
                                  logical_shape=logical),
            lambda w=w: cs.jacobi_plain(u, b, alpha, h, w, 2, logical))
            for w in (1.0, 0.8)],
    }
    n, m = u.shape
    if n % 2 == 0 and m % 2 == 0:  # the transfers live on padded levels
        lg = logical or (n, m)
        e = b[: n // 2, : m // 2].contiguous()
        calls["restrict_fw"] = [(
            "",
            lambda: cs.restrict_fw_padded_fast(u, lg),
            lambda: cs.restrict_fw_padded_fast_plain(u, lg))]
        calls["prolong_add"] = [(
            f"from {tuple(e.shape)}",
            lambda: cs.prolong_add_padded_fast(e, u),
            lambda: cs.prolong_add_padded_fast_plain(e, u))]
    return calls


def median_ms(torch, fn, runs=25, warmup=3):
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


def median_wall(torch, fn, runs=3):
    """Median host wall time (s) of ``fn`` over warm runs, and the runs."""
    fn()  # warm-up
    walls = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls), walls, out


class Phases:
    """Prints each phase's wall seconds when the next one starts."""

    def __init__(self):
        self.t_start = self.t0 = time.perf_counter()
        self.name = None

    def next(self, name):
        now = time.perf_counter()
        if self.name is not None:
            print(f"[phase] {self.name}: {now - self.t0:.1f} s")
        self.name, self.t0 = name, now


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

    phases = Phases()
    phases.next("device")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(card)
    print(f"[device] {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; {torch.cuda.device_count()} visible")

    phases.next("build")
    info = _build.build(force=True)
    regs = [ln.strip() for ln in info["log"].splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    print(f"[build] nvcc {info['seconds']:.2f} s -> {info['path']}")
    for ln in regs:
        print(f"[build] {ln}")
    _build.library()

    # 3. kernel vs twin (torch.equal at every path shape)
    phases.next("kernel vs twin")
    max_err = {k: 0.0 for k in KERNELS}
    for i, (shape, logical) in enumerate(KERNEL_SHAPES):
        u, b, u_lo, h = kernel_inputs(torch, shape, logical, seed=i)
        done = []
        for kname, cases in kernel_calls(cs, text, u, b, u_lo, h,
                                         logical).items():
            for label, kern, twin in cases:
                got, want = kern(), twin()
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                max_err[kname] = max(max_err[kname], err)
                check(torch.equal(got, want),
                      f"{kname} ({label}) != twin at {shape} logical "
                      f"{logical} (max abs diff {err})")
                del got, want
            done.append(kname)
        print(f"[kernels] {shape} logical {logical}: {', '.join(done)} equal "
              "to their twins (torch.equal)")
        del u, b, u_lo
    torch.cuda.empty_cache()

    launches = {k: 0 for k in KERNELS}

    def run_path(solver, b, **kw):
        """One solve with the counters set to 0 just before and read just
        after; adds them to ``launches``."""
        cs.reset_launch_counts()
        res = solver.solve_refined(b, **kw)
        torch.cuda.synchronize()
        counts = dict(cs.LAUNCHES)
        for k, v in counts.items():
            launches[k] += v
        return res, counts

    def check_solve(tag, res, shape, tol, expected, counts, need):
        print(f"[{tag}] {res.iterations} iterations (expected {expected} "
              f"+- 1), final rel. residual {float(res.history[-1]):.3e}, "
              f"converged={res.converged}")
        print(f"[{tag}] history {[float(x) for x in res.history]}")
        print(f"[{tag}] kernel launches during the solve: {counts}")
        check(res.converged and float(res.history[-1]) <= tol,
              f"{tag}: not converged")
        check(abs(res.iterations - expected) <= 1,
              f"{tag}: {res.iterations} iterations, expected {expected} +- 1")
        check(all(counts[k] > 0 for k in need),
              f"{tag}: a kernel of {need} was not launched: {counts}")
        check(tuple(res.u.shape) == shape and res.u.device.type == "cuda"
              and bool(torch.isfinite(res.u).all()), f"{tag}: bad solution")

    def check_twins(tag, res, kw, b, rtol=HISTORY_RTOL, **solve_kw):
        t0 = time.perf_counter()
        ref = GMGSolver(**kw, device="cpu", use_pallas=True) \
            .solve_refined(b.cpu(), **solve_kw)
        print(f"[{tag}] CPU twins: {ref.iterations} iterations in "
              f"{time.perf_counter() - t0:.1f} s; history "
              f"{[float(x) for x in ref.history]}")
        check(ref.iterations == res.iterations,
              f"{tag}: CPU twin iteration count differs")
        diff = abs(res.history - ref.history)
        rel = float((diff / ref.history).max())
        u_diff = float((res.u.cpu() - ref.u).abs().max() / ref.u.abs().max())
        print(f"[{tag}] CUDA vs CPU twins: max rel. history diff {rel:.3e}, "
              f"max abs {float(diff.max()):.3e} (bound {rtol} rel. + "
              f"{HISTORY_ATOL} abs.); max |du| / max |u| = {u_diff:.3e}")
        check(bool((diff <= HISTORY_ATOL + rtol * ref.history).all()),
              f"{tag}: histories differ beyond the bound")

    gs_need = ("rbgs_color", "residual", "ff_residual", "restrict_fw",
               "prolong_add")

    # 4. main path: 1025^2 ff32-refined V(2,2) solve on the card
    phases.next("main path 1025^2")
    solver = GMGSolver(**SOLVER_KW, device="cuda")
    b = assemble_rhs(solver.levels[0], 10.0, test=1, dtype=torch.float32,
                     device="cuda")
    res, counts = run_path(solver, b)
    check_solve("main", res, SHAPE, 1e-8, TPU_ITERATIONS, counts, gs_need)
    main_launches = sum(counts.values())
    check_twins("main", res, SOLVER_KW, b)

    # 5. at scale: 8193^2, plain and inner_cg=4
    phases.next("8193^2")
    t0 = time.perf_counter()
    big = GMGSolver(**SCALE_KW, device="cuda")
    big_b = assemble_rhs(big.levels[0], 10.0, test=1, dtype=torch.float32,
                         device="cuda")
    torch.cuda.synchronize()
    print(f"[8193] solver set-up {time.perf_counter() - t0:.1f} s "
          f"(levels {[lev.physical for lev in big.levels]})")
    big_res = {}
    for inner in (0, 4):
        torch.cuda.reset_peak_memory_stats()
        tag = f"8193 inner_cg={inner}"
        res8, counts = run_path(big, big_b, inner_cg=inner)
        check_solve(tag, res8, (8193, 8193), 1e-7, SCALE_ITERATIONS[inner],
                    counts, gs_need + (("apply",) if inner else ()))
        print(f"[{tag}] peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        big_res[inner] = res8
        del res8

    # 6. 1025^2 inner_cg=4 and Jacobi omega 0.8, each against its CPU twins
    phases.next("1025^2 inner_cg / Jacobi")
    res_cg, counts = run_path(solver, b, inner_cg=4)
    check_solve("1025 inner_cg=4", res_cg, SHAPE, 1e-8, INNER_CG_ITERATIONS,
                counts, gs_need + ("apply",))
    check_twins("1025 inner_cg=4", res_cg, SOLVER_KW, b,
                rtol=INNER_CG_HISTORY_RTOL, inner_cg=4)
    jac = GMGSolver(**JACOBI_KW, device="cuda")
    res_jac, counts = run_path(jac, b)
    check_solve("1025 jacobi", res_jac, SHAPE, 1e-8, JACOBI_ITERATIONS, counts,
                ("jacobi", "residual", "ff_residual", "restrict_fw",
                 "prolong_add"))
    check_twins("1025 jacobi", res_jac, JACOBI_KW, b)

    # 7. the options whose JAX meaning is "no kernel" run plain ops on CUDA
    phases.next("plain ops on CUDA")
    cs.reset_launch_counts()
    res_p = GMGSolver(**SOLVER_KW, use_pallas=False, device="cuda") \
        .solve_refined(b)
    torch.cuda.synchronize()
    print(f"[plain] use_pallas=False: {res_p.iterations} iterations to "
          f"{float(res_p.history[-1]):.3e}; launches {dict(cs.LAUNCHES)}")
    check(all(v == 0 for v in cs.LAUNCHES.values()),
          "use_pallas=False launched a kernel")
    check(res_p.converged and abs(res_p.iterations - TPU_ITERATIONS) <= 1,
          "use_pallas=False solve")
    cs.reset_launch_counts()
    res_sor = GMGSolver(**SOLVER_KW, omega=1.2, device="cuda") \
        .solve_refined(b)
    torch.cuda.synchronize()
    print(f"[plain] omega=1.2 (SOR, plain smoother): {res_sor.iterations} "
          f"iterations to {float(res_sor.history[-1]):.3e}; launches "
          f"{dict(cs.LAUNCHES)}")
    check(res_sor.converged and cs.LAUNCHES["rbgs_color"] == 0,
          "omega=1.2 solve")

    # 8. CLI on the card (three runs at once, one process each)
    phases.next("CLI")
    env = dict(os.environ, PYTHONPATH=REPO)
    runs = [["-n", "129", "-ml", "4", "-cycle", "v", "-pad", "256",
             "-tol", "1e-3"],
            ["-n", "129", "-ml", "4", "-smt", "1", "-tol", "1e-3"],
            ["-n", "129", "-ml", "4", "-smt", "2", "-cycle", "v",
             "-tol", "1e-3"]]
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for i, argv in enumerate(runs):
            cwd = os.path.join(tmp, str(i))
            os.mkdir(cwd)
            cmd = [sys.executable, "-m",
                   "multigrid_prj_tpu_torch.cli.gmg_main", *argv]
            procs.append((argv, cwd, subprocess.Popen(
                cmd, cwd=cwd, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
        for argv, cwd, proc in procs:
            out, _ = proc.communicate(timeout=600)
            check(proc.returncode == 0, f"CLI {argv} failed:\n{out}")
            check("not converged" not in out, f"CLI {argv}:\n{out}")
            hist = load_vector(os.path.join(cwd, "MGGS4.txt"))
            x = load_vector(os.path.join(cwd, "x.mtx"))
            check(hist[-1] <= 1e-3 and x.size == 129 * 129
                  and bool(abs(x).max() < float("inf")), f"CLI {argv} files")
            first = [ln for ln in out.splitlines() if "iters" in ln]
            print(f"[cli] {' '.join(argv)}: {first[0] if first else '?'}, "
                  f"{len(hist)} history entries, last {hist[-1]:.3e}; wrote "
                  f"MGGS4.txt and x.mtx ({x.size} values)")

    # 9. unported features raise on CUDA
    phases.next("unported")
    for label, make in [
            ("fuse_downleg", lambda: GMGSolver(**SOLVER_KW, fuse_downleg=True,
                                               device="cuda")),
            ("smoother_dtype", lambda: GMGSolver(
                **SOLVER_KW, smoother_dtype=torch.bfloat16, device="cuda")),
            ("3D", lambda: GMGSolver(shape=(17, 17, 17), num_levels=2,
                                     cycle="v", device="cuda")),
            ("f64 with use_pallas", lambda: solver.solve_refined(b.double()))]:
        try:
            make()
        except NotImplementedError as exc:
            print(f"[unported] {label}: NotImplementedError: {exc}")
        else:
            check(False, f"{label} did not raise on CUDA")

    # 10. times: kernels vs twins at 1280^2 (warm L2) and 8448^2 (HBM), and
    # warm solves
    phases.next("times")
    times = {}
    for shape, logical in TIME_SHAPES:
        u, bb, u_lo, h = kernel_inputs(torch, shape, logical, seed=99)
        for kname, cases in kernel_calls(cs, text, u, bb, u_lo, h,
                                         logical).items():
            label, kern, twin = cases[-1]
            t = (median_ms(torch, kern), median_ms(torch, twin))
            times.setdefault(kname, {})[shape[0]] = t
            print(f"[time] {kname} {label} at {shape[0]}^2: kernel "
                  f"{t[0] * 1e3:.1f} us, twin {t[1] * 1e3:.1f} us  ({card})")
        del u, bb, u_lo
        torch.cuda.empty_cache()
    for tag, fn, iters in [
            ("solve_refined 1025^2", lambda: solver.solve_refined(b),
             res.iterations),
            ("solve_refined 8193^2", lambda: big.solve_refined(big_b),
             big_res[0].iterations),
            ("solve_refined 8193^2 inner_cg=4",
             lambda: big.solve_refined(big_b, inner_cg=4),
             big_res[4].iterations),
            ("solve_refined 1025^2 jacobi", lambda: jac.solve_refined(b),
             res_jac.iterations)]:
        med, walls, out = median_wall(torch, fn)
        check(out.iterations == iters, f"timed {tag} differs")
        print(f"[time] {tag}: median wall {med * 1e3:.2f} ms over 3 "
              f"({[round(w * 1e3, 2) for w in walls]} ms), {iters} "
              f"iterations  ({card})")
    print(f"[time] 1025^2 solve: {main_launches} kernel launches "
          f"(wrapper counts)")
    phases.next(None)
    print(f"[time] chip_smoke total {time.perf_counter() - phases.t_start:.1f}"
          " s")

    small, large = (shape[0] for shape, _ in TIME_SHAPES)
    print(card)
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCE, "replaces": KERNELS[k],
         "launches": launches[k], "max_abs_err": max_err[k],
         "ms": times[k][small][0], "plain_ms": times[k][small][1],
         f"ms_{large}": times[k][large][0],
         f"plain_ms_{large}": times[k][large][1]}
        for k in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
