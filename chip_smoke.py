#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

Drives the port's 2D and 3D GMG paths on the card through ``GMGSolver``
and the ``gmg_main`` CLI, and its AMG path through ``AMGSolver`` and the
``amg_main`` CLI, after building the CUDA kernels from
``multigrid_prj_tpu_torch/csrc`` (every source, compiled in parallel,
into one library) and holding each against its plain torch twin at the
paths' shapes.  Imports nothing of JAX.  The paths:

* main: ``solve_refined`` at 1025^2, 6 levels, V(2,2), pad 256, to 1e-8,
  one fused smoother launch per smoother call, and the same solve on the
  per-colour path (the smoother swapped for the per-colour oracle, the
  path before the fused kernel), equal to it bit for bit;
* at scale: the same at 8193^2, 8 levels, to 1e-7, plain and with
  ``inner_cg=4`` (``benchmarks/scale_bench.py``'s solve), and on the
  per-colour path;
* 1025^2 with ``inner_cg=4``, and with the Jacobi smoother (omega 0.8;
  one fused launch per smoother call), the latter also with the per-sweep
  kernel swapped in, equal to it bit for bit; the 8193^2 solve also with
  the one-thread-per-point prolong-add swapped in, equal bit for bit;
* the options that run plain ops on CUDA (``use_pallas=False``, SOR);
* the CLI with ``-smt 0``, ``-smt 1`` and ``-smt 2``;
* 3D (BASELINE config 4 and around it, ``bench.py``'s ``measure_vcycle3d``
  RHS): A. config 4 verbatim, 257^3, 5 levels, bf16 ``smoother_dtype``,
  ``solve_refined`` to 1e-8, one fused smoother launch per smoother call
  (the 17^3 bottom's 100 sweeps in one resident launch), and the same
  solve on the per-colour path and with the plain exact-layout transfers
  in place of their kernels, each equal to it bit for bit; B. the same with
  ``pad_align=(8, 8, 128)``; C. 513^3, 6 levels, to 1e-8; D. 65^3 with
  ``pad_align=(8, 8, 128)`` (GS, ``inner_cg=4``, Jacobi omega 0.8, and the
  bf16 defect-correction ``.solve``), each against its CPU-twin run; and
  config 4 at its full 257^3 with the Jacobi smoother (omega 0.8: one
  launch of the z-chunked march per smoother call, the 17^3 bottom's 100
  sweeps in one resident launch) and with ``inner_cg=4`` (the apply on
  the residual's march), each also with the kernel it replaced swapped in
  (the per-sweep Jacobi, the point apply), equal to it bit for bit;
* ``smoother_dtype`` (bf16 defect correction) in 2D;
* AMG (BASELINE config 3's FD system, ``benchmarks/amg_bench.py``): the
  1024^2 FD hierarchy (12 levels max, 2000-row bottom, Chebyshev, RCM,
  f32, the ELL kernels from 4096 rows) with ``solve``, ``solve_pcg`` and
  ``solve_refined``, each with the ELL launches its path should make; the
  cycle's fused ELL kernels (``ell_spmv_axpy``, ``ell_cheb_step``) equal
  to their twins on every level's A, P and P^T and on the RCM'd 2049^2 P1
  system; 256^2 and the P1 FEM system of an 81 x 81 mesh against
  their CPU-twin runs; ``amg_main -matrix`` on a MatrixMarket file;
* the fused down-leg (``fuse_downleg=True``): the main path and the 8193^2
  solve again, each equal to its unfused run bit for bit, and 129^2
  against its CPU-twin run;
* f64 with the kernels on (plain ops, as the JAX wrappers run XLA);
* the public ops ``bench.py`` headlines: the apply chain of 8 at 8192^2
  (``measure_stencil_chains``), the ELL SpMM of 4 vectors on
  ``banded_csr(2**20)`` (``measure_ell_spmm``), and a red-black smoother
  written with the public colour-sweep op at 1025^2;
* the sharded GMG path (``parallel/``): README.md's ``ShardedGMGSolver``
  at 8192^2, 6 levels, on one rank through ``maybe_initialize_distributed``
  (NCCL, a world of one), 8 cycles on the extended-slab kernel
  ``rbgs_fused_ext`` against the per-colour and grouped plain schedules, a
  step timed against the unsharded ``GMGSolver`` step (``bench.py``'s
  ``measure_sharded_on_one``); 4 gloo ranks on the card at 2048^2 on the
  ("x",) and ("dcn", "x") layouts against one rank; 2 gloo ranks at 256^2
  against the same ranks on the CPU (the twin);
* the sharded AMG path (``parallel/sharded_amg.py``): config 3's system
  and hierarchy through ``ShardedAMGSolver`` on one NCCL rank (the 5
  upper levels sharded, every local apply on the ELL SpMV kernel, the
  280-row bottom an LU solve) to 1e-5 against ``AMGSolver.solve``, its
  kernel on each sharded block and on the 4-rank blocks of level 0; 256^2
  on the card against the CPU twin; 4 gloo ranks sharing the card on the
  parent's hierarchy, bit-equal to the one rank;
* the design probes of ``benchmarks/`` (``csrc/ablation.cu``): the port's
  ``stencil_ablation`` and ``spmv_ablation`` harnesses at their full size
  (8192^2 f32; ``banded_csr(2**20)``), each probe kernel against its twin;
* the last slice's modules (phase 16h): the web server (``web/server.py``)
  answering four requests from the card (4097^2 sawtooth GS; 1025^2
  V-cycle GS, Jacobi and BiCGSTAB, each against a direct solve bit for
  bit), ``viz.record_cycle_stages`` at 1025^2 against ``step`` and
  ``viz_main``'s ``--gif`` solve, checkpoint and resume at the main path's
  configuration against an uninterrupted solve, the guards and
  ``PhaseTimer`` / ``fence`` / ``trace``, and the ``amg_debug`` harness at
  257^2 nodes with the reference's 5000 sweeps.

Phases (each prints its lines and its seconds; the first failure exits
non-zero):
  1. device   2. build (with the tile kernels' registers, spills and shared
  memory, the apply chain's and the residual march's too)   3. 2D kernel
  vs twin (with the down-leg, apply chain and colour sweep; the fused
  smoother at sweeps 0-9 and the down-leg at 0-3 also against the
  per-colour oracle; the apply chain at 0-11 applies also against single
  applies; the fused Jacobi at
  sweeps 0-11, omega 0.8 and 1, also against the per-sweep kernel; the
  prolong-add stream also against the one-thread-per-point kernel; the
  fused pair update and float-float residual also against the plain pair
  update and the ff residual kernel in turn; the geometry refusals of the
  chain, the Jacobi tile and the stream)
  4. 3D kernel vs twin (the fused smoother at sweeps 0-9, and 100 on the
  resident route, also against the per-colour oracle; the residual march
  at a shape whose nz is no multiple of its chunk; the route of each
  shape; the march's geometry
  refusal; the fused Jacobi at sweeps 0-9 and 100, omega 0.8 and 1, also
  against the per-sweep oracle, on the route of each shape; the apply's
  march also against the point apply; the fused 3D pair update and
  float-float residual also against the plain pair update and
  ff_residual3d in turn; the Jacobi march's, the resident Jacobi's and the
  apply's refusals)   5. main
  path (+ CPU-twin run, + the per-colour path)   5b. main
  path with fuse_downleg (+ 129^2 CPU-twin run)   6. 8193^2 (plain,
  inner_cg=4, fuse_downleg, the per-colour path)   7. 1025^2 inner_cg / Jacobi (+ CPU-twin
  runs)   8. plain ops   9. CLI   10. 3D paths A, B, C   10b. config 4
  with Jacobi
  (+ the per-sweep kernel swapped in) and with inner_cg=4 (+ the point
  apply), each bit-equal   11. 3D variants D
  (+ CPU-twin runs)   12. options (f64 with the kernels, bf16)   12b. bench
  paths: apply chain, colour sweep   13. AMG
  set-up   14. AMG kernels vs
  twins (with the SpMM)   15. AMG 1024^2 solves   16. AMG 256^2 vs CPU twins,
  FEM and the AMG CLI   16b. bench SpMM path   16c. sharded kernel vs twin (and colour sweeps of the global grid)
  16d. sharded 8192^2, one rank (NCCL)   16e. sharded 2048^2, 4 ranks on one
  card (gloo)   16f. design probes: the stencil and SpMV probe kernels vs
  their twins   16g. sharded AMG: config 3 on one rank (NCCL; the SpMV
  kernel at every sharded block shape vs its twin, pinned launch and
  collective counts, walls beside AMGSolver.solve, a profiled solve),
  256^2 card vs CPU twin, 4 gloo ranks on one card   16h. amg_debug,
  utilities and front-ends (web requests, cycle stages, checkpoint and
  resume, guards, metrics, amg_debug)   17. times (with
  the per-pass ladder of the smoother and
  the down-leg at 8448^2, of the 3D smoother at 257^3 and 513^3, of the
  sharded smoother at 8208 x 8192, of the apply chain and of the Jacobi
  tile at 8192^2, each against the kernels it replaced; the Jacobi tile and
  the prolong-add stream at 8192^2 and 8448^2 against their oracles, also
  L2 flushed; the residual march against the point
  kernel, the 3D Jacobi march against the per-sweep kernel and the
  apply's march against the point apply at 257^3 and 513^3, each L2
  flushed too, with the 3D Jacobi's ladder (1 / 2 / 4 / 9 sweeps at 257^3)
  and the 17^3 bottom's 100 Jacobi sweeps; L2-flushed times of the fused
  kernels, the
  residuals and the float-float residuals, the fused ones also against the
  plain pair update and the residual kernel in turn; the
  17^3 bottom's 100 sweeps; the solves on three paths, the 1025^2 Jacobi
  and the 8193^2 solves and config 4's Jacobi and inner_cg=4 solves
  against their oracles swapped in, config 4 and
  513^3 fused against per colour; profiled runs of the 1025^2 and config 4
  solves and of each AMG solve; the two probe harnesses' mains as the
  probes' path)
The line before the last is the kernel table as one JSON object (each
kernel's time at its shapes: one call between CUDA events, ``ms``, and
per call from CUDA-graph replays, ``device_ms``, where the probes' ``ms``
is already that; the least time the card could take for the same work,
``bound_ms``; one PyTorch call's time for the same function where there
is one, ``library_ms``; ``launches`` counts wrapper calls, a graph's
capture included, and the probes' ``launches_executed`` what the card
ran, graph replays included); the last line is ``{"ok":
true, "device": {...}}``.  Without CUDA, or without the rest of the
repository beside it, it exits non-zero and prints no result.

Usage (from the repository root, one card):  python3 chip_smoke.py
"""

from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

EPS32 = 2.0 ** -23
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
# one fused Jacobi launch per smoother call: 15 iterations x 5 smoothed
# levels x 2 calls (the per-sweep kernel: one per sweep, twice that)
JACOBI_LAUNCHES = 15 * 5 * 2
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
                 ((132, 132), (129, 129)), ((66, 66), (65, 65)),
                 ((256, 384), (201, 329))]  # ragged, non-square
TIME_SHAPES = [((1280, 1280), (1025, 1025)), ((8448, 8448), (8193, 8193))]
# the fused smoother is held to its twin and to the per-colour oracle at
# every sweep count here (9: one launch per group, 4 + 4 + 1), the down-leg
# at 0-3; the per-pass ladder times both, and the kernels they replace, at
# 8448^2 from graph replays
FUSED_SWEEPS = tuple(range(10))
DOWNLEG_SWEEPS = (0, 1, 2, 3)
LADDER_SMOOTHER = (1, 2, 4)
# an L2 flush between timed calls: read a buffer of 4x the 50 MB L2
FLUSH_BYTES = 200 * 2 ** 20
# the f32 relative residual of a plain .solve floors at ~6e-3 at 1025^2
# (the CPU twins: 0.0072 at iteration 4, then 0.0059 flat), so the fused /
# unfused .solve runs to 1e-2
SOLVE_TOL = 1e-2
# f64 solve_refined of the main path with use_pallas=True: the JAX package
# in f64 on the CPU (XLA, use_pallas True or False) takes 9 iterations to
# 1.794e-9
F64_ITERATIONS = 9
# bench.py's headline chain (measure_stencil_chains): A^8 u per pass at
# 8192^2 on u = 1e-3 sin(0.01 i) cos(0.013 j).  With bench's alpha = 10,
# h = 10/(n-1) (c = 6.7e6) A^7 u overflows f32 there (the CPU twins: inf at
# the 7th apply), so the path runs alpha = h^2 (c = 1), as the JAX chain
# test does, and stays finite
BENCH_N = 8192
CHAIN_FUSE = 8
CHAIN_PASSES = 4
# the apply chain is held to its twin and to single applies at every apply
# count here (11: launches of 8 + 3); its ladder at 8192^2 from graph
# replays
CHAIN_APPLIES = tuple(range(12))
LADDER_CHAIN = (1, 2, 4, 8)
# the fused Jacobi is held to its twin and to the per-sweep kernel at every
# sweep count here (9-11: launches of 8 + 1 .. 3), omega 0.8 and 1; its
# ladder (omega 0.8) and the prolong-add stream at 8192^2 from graph replays
JACOBI_SWEEPS = tuple(range(12))
LADDER_JACOBI = (1, 2, 4, 8)
JACOBI_OMEGA = 0.8
# bench.py's measure_ell_spmm: banded_csr(2**20), 4 vectors
SPMM_N = 1 << 20
SPMM_NVEC = 4
SPMM_PASSES = 3
# published H100 SXM peaks (NVIDIA's H100 datasheet): HBM bytes/s and
# f32 flop/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
_PS = "multigrid_prj_tpu/ops/pallas_stencil.py"
_PS3 = "multigrid_prj_tpu/ops/pallas_stencil_3d.py"
_SRC2 = "multigrid_prj_tpu_torch/csrc/stencil2d.cu"
_SRC3 = "multigrid_prj_tpu_torch/csrc/stencil3d.cu"
KERNELS = {  # wrapper counter name -> (TPU kernel it replaces, source)
    "rbgs_fused": (f"{_PS}:456", _SRC2),
    # the per-colour oracle of rbgs_fused and the down-leg, on no solver
    # path: its launches are those of the per-colour path run beside them
    "rbgs_color": (f"{_PS}:456", _SRC2),
    "residual": (f"{_PS}:313", _SRC2),
    "ff_residual": (f"{_PS}:792", _SRC2),
    "apply": (f"{_PS}:287", _SRC2),
    "jacobi": (f"{_PS}:962", _SRC2),
    # the per-sweep oracle of the fused Jacobi, on no solver path: its
    # launches are those of the 1025^2 Jacobi solve with it swapped in
    "jacobi_sweep": (f"{_PS}:962", _SRC2),
    "restrict_fw": (f"{_PS}:541", _SRC2),
    "prolong_add": (f"{_PS}:631", _SRC2),
    # the one-thread-per-point oracle of the prolong-add stream, on no
    # solver path: its launches are those of the 8193^2 solve with it
    # swapped in
    "prolong_add_point": (f"{_PS}:631", _SRC2),
    # the apply on the residual's march; apply3d_point, the one-thread-per-
    # point kernel it replaced, is on no solver path: its launches are those
    # of config 4's inner_cg=4 solve with it swapped in, run beside the path
    "apply3d": (f"{_PS3}:107", _SRC3),
    "apply3d_point": (f"{_PS3}:107", _SRC3),
    # the residual's z-chunked march
    "residual3d": (f"{_PS3}:117", _SRC3),
    # the 3D smoother: the z-marching tile, or the whole array resident in
    # shared memory (the 17^3 bottom); rbgs3d_color is its per-colour
    # oracle, on no solver path: its launches are those of the per-colour
    # path run beside it
    "rbgs3d_fused": (f"{_PS3}:128", _SRC3),
    "rbgs3d_color": (f"{_PS3}:128", _SRC3),
    # the 3D Jacobi: the z-chunked multi-sweep march, or the whole array
    # resident in shared memory (the 17^3 bottom); jacobi3d_sweep is its
    # per-sweep oracle, on no solver path: its launches are those of config
    # 4's Jacobi solve with it swapped in, run beside the path
    "jacobi3d": (f"{_PS3}:141", _SRC3),
    "jacobi3d_sweep": (f"{_PS3}:141", _SRC3),
    # the 3D float-float residual replaces no TPU kernel: XLA fused the JAX
    # function's elementwise chain there, torch runs it as ~120 passes
    "ff_residual3d": ("none: XLA fused multigrid_prj_tpu/ops/extended.py:85"
                      " on the TPU", _SRC3),
    # the pair update of the refined solve (multigrid_prj_tpu/gmg.py:638,
    # ops/extended.py:114, an XLA op on the TPU) fused into the float-float
    # residual that follows it: 2D with row 3's kernel, 3D with row 22's
    "ff_update_residual": (f"{_PS}:792 with multigrid_prj_tpu/ops/"
                           "extended.py:114, XLA's on the TPU", _SRC2),
    "ff_update_residual3d": ("none: XLA fused multigrid_prj_tpu/ops/"
                             "extended.py:85 and :114 on the TPU", _SRC3),
    # the exact-layout grid transfers of the 3D V-cycle replace no TPU
    # kernel either: XLA fused the JAX functions there, torch runs each as
    # ~15 launches of slices, products, sums, stacks and concatenations
    "restrict_fw3d": ("none: XLA fused multigrid_prj_tpu/ops/transfer.py:91"
                      " on the TPU", _SRC3),
    "prolong_add3d": ("none: XLA fused multigrid_prj_tpu/ops/"
                      "transfer.py:129 and the add on the TPU", _SRC3),
}
KERNELS_3D = ("apply3d", "apply3d_point", "residual3d", "rbgs3d_fused",
              "rbgs3d_color", "jacobi3d", "jacobi3d_sweep", "ff_residual3d",
              "ff_update_residual3d", "restrict_fw3d", "prolong_add3d")
_PSPMV = "multigrid_prj_tpu/ops/pallas_spmv.py"
_SRCS = "multigrid_prj_tpu_torch/csrc/spmv.cu"
KERNELS.update({
    # PallasELL.spmv2d (:613) and ell_local_spmv2d (:877): one CUDA kernel
    "spmv": (f"{_PSPMV}:613", _SRCS),
    "ff_residual_ell": (f"{_PSPMV}:695", _SRCS),
    "rbgs_resfilter": (f"{_PS}:497", _SRC2),
    "apply_chain": (f"{_PS}:871", _SRC2),
    "rbgs_color_sweep": (f"{_PS}:321", _SRC2),
    "ell_spmm": (f"{_PSPMV}:274", _SRCS),
    # the AMG cycle's fused ELL kernels replace no TPU kernel: the JAX
    # cycle runs the residual, the prolong-add and Chebyshev's vector
    # updates as XLA ops around PallasELL.spmv2d
    "spmv_axpy": (f"none: XLA ops around {_PSPMV}:613 (b - A x, x + P e) "
                  "on the TPU", _SRCS),
    "cheb_step": (f"none: the Chebyshev smoother's XLA ops around "
                  f"{_PSPMV}:613 on the TPU", _SRCS),
})
KERNELS["rbgs_fused_ext"] = (f"{_PS}:476", _SRC2)
KERNELS_AMG = ("spmv", "spmv_axpy", "cheb_step", "ff_residual_ell")
# the design probes of benchmarks/ (csrc/ablation.cu, ROADMAP B17 / B18),
# driven through the port's two harnesses (multigrid_prj_tpu_torch/
# benchmarks/), whose mains are their path; checked for launches after it
_SAB = "benchmarks/stencil_ablation.py"
_SPAB = "benchmarks/spmv_ablation.py"
_SRCA = "multigrid_prj_tpu_torch/csrc/ablation.cu"
PROBES = {
    "probe_copy": (f"{_SAB}:75", _SRCA),
    "probe_rolls": (f"{_SAB}:89", _SRCA),
    "probe_shifts": (f"{_SAB}:106", _SRCA),
    "probe_halo": (f"{_SAB}:125", _SRCA),
    "probe_full": (f"{_SAB}:149", _SRCA),
    "probe_carry": (f"{_SAB}:180", _SRCA),
    "probe_stream": (f"{_SPAB}:67", _SRCA),
    "probe_staticwin": (f"{_SPAB}:49", _SRCA),
    "probe_noshuffle": (f"{_SPAB}:30", _SRCA),
}
# flops per point of the stencil probes (each moves 8 B per point: u read
# once, y written once); the harness's chain is 5 + 24 applies
PROBE_FLOPS = {"copy": 1, "rolls": 3, "shifts": 3, "halo": 3, "full": 6,
               "carry": 6}
PROBE_N = 8192
PROBE_CHAIN = 29
ALSO_REPLACES = {"spmv": f"{_PSPMV}:877", "apply_chain": f"{_PS}:412",
                 "rbgs_fused": f"{_PS}:392", "jacobi": f"{_PS}:402",
                 "jacobi_sweep": f"{_PS}:402"}
# the kernels kept only as references of their redesigns: on no path
ON_NO_PATH = {"rbgs_color": "rbgs_fused", "rbgs3d_color": "rbgs3d_fused",
              "jacobi_sweep": "jacobi", "prolong_add_point": "prolong_add",
              "jacobi3d_sweep": "jacobi3d", "apply3d_point": "apply3d"}
# the JAX wrapper that reaches the kernel body in "replaces"
VIA = {"rbgs3d_fused": f"{_PS3}:220", "rbgs3d_color": f"{_PS3}:220",
       "jacobi3d": f"{_PS3}:237", "jacobi3d_sweep": f"{_PS3}:237",
       "apply3d": f"{_PS3}:205", "apply3d_point": f"{_PS3}:205",
       "jacobi": f"{_PS}:1304", "jacobi_sweep": f"{_PS}:1304",
       "prolong_add": f"{_PS}:677", "prolong_add_point": f"{_PS}:677"}
# (bytes, flops) per point of each stencil kernel's timed call, f32: every
# input read once and every output written once (the transfers per fine
# point); the timed calls are 2 sweeps of the smoothers (Jacobi and 3D
# Jacobi with omega 0.8), the down-leg with 2 sweeps, 8 chained applies
STENCIL_COST = {
    "rbgs_fused": (12, 12), "rbgs_color": (12, 12), "residual": (12, 7),
    "ff_residual": (24, 60),
    "apply": (8, 6), "jacobi": (12, 18), "jacobi_sweep": (12, 18),
    "restrict_fw": (5, 5), "prolong_add": (9, 3),
    "prolong_add_point": (9, 3), "rbgs_resfilter": (13, 24),
    "apply_chain": (8, 48), "rbgs_color_sweep": (12, 3),
    "apply3d": (8, 8), "apply3d_point": (8, 8), "residual3d": (12, 9),
    "rbgs3d_fused": (12, 18),
    "rbgs3d_color": (12, 18),
    "jacobi3d": (12, 24), "jacobi3d_sweep": (12, 24),
    "ff_residual3d": (24, 95),
    # the residual's and the pair update's (10 operations, at the point and
    # its 4 neighbours in 2D, at each plane copy's ~1.3 cells a point in 3D)
    "ff_update_residual": (36, 110), "ff_update_residual3d": (36, 108),
    # the 3D transfers per fine point, as portbench/roofline.py prices them:
    # the fine grid read, the coarse one written, 53 / 8 flops; u and the
    # coarse e read, u written, 27 / 8 + 1 flops
    "restrict_fw3d": (4.5, 6.625), "prolong_add3d": (8.5, 4.375),
    "rbgs_fused_ext": (12, 24)}

# AMG: BASELINE config 3's large FD system as benchmarks/amg_bench.py runs
# it (poisson_fd_csr(1024): 1,048,576 rows, 5,238,784 nnz; b from
# default_rng(0)), with the kernel path on.  Expected: the JAX package on
# the CPU with the XLA gather (levels, operator complexity 2.711, 5 / 4 / 8
# iterations), and the TPU's 5 f32 cycles and 8 ff32 iterations.
AMG_N = 1024
AMG_KW = dict(num_levels=12, min_coarse=2000, smoother="chebyshev",
              reorder="rcm")
AMG_LEVELS = [1048576, 382447, 77684, 13796, 2057, 280]
AMG_SOLVES = (("solve", 1e-5, 5), ("solve_pcg", 1e-5, 4),
              ("solve_refined", 1e-8, 8))
AMG_TWIN_N = 256  # CUDA vs CPU twins on one hierarchy
P1_N = 2049  # the amg-p1-2049-ff32 cell's P1 system: its fine level
FEM_N = 81  # structured P1 mesh: 6241 interior dofs, as many as mesh1
FEM_SOLVES = (("solve_pcg", 1e-6), ("solve_refined", 1e-9))
CLI_N = 128  # the amg_main run on a MatrixMarket file
AMG_TIME_NS = (1024, 4096)  # 1.05M and 16.8M rows (4096^2 in FD order)
# CUDA vs CPU twins on one AMG hierarchy: the SpMV and float-float kernels
# equal their twins, but the dense level matvecs and the bottom inverse
# (cuBLAS vs the CPU BLAS), the norms and PCG's dot products sum in another
# order on the two devices; each cycle carries those roundings on, so the
# histories agree to 1e-2 relative (plus 1e-12 at the extended residual's
# round-off floor), and the iteration counts are equal.
AMG_HISTORY_RTOL = 1e-2
# the float-float residual kernel vs the f64 residual of the pair system:
# one f32 rounding of the result plus 1e-12 of |b| + |A| |x|
FF_BOUND_SCALE = 1e-12

# 3D paths (BASELINE config 4: bench.py's measure_vcycle3d)
CONFIG4_KW = dict(shape=(257, 257, 257), length=1.0, alpha=1.0, num_levels=5,
                  cycle="v", nu=2, pre_sweeps=2, tol=1e-8, maxit=60)
CONFIG4_ITERATIONS = 11  # BENCH_r05.json, vcycle3d_257_iters (TPU)
PADDED4_KW = dict(CONFIG4_KW, pad_align=(8, 8, 128))
SCALE3D_KW = dict(CONFIG4_KW, shape=(513, 513, 513), num_levels=6)
SCALE3D_ITERATIONS = 12  # the CPU twins and every earlier card run
# smoother launches per solve: config 4's 11 iterations x (4 smoothed levels
# x 2 calls + the 17^3 bottom's one), 513^3's 12 x (5 x 2 + 1); the
# per-colour path's 2 x sweeps rbgs3d_color launches per call (2 sweeps, the
# bottom's 100)
CONFIG4_FUSED_LAUNCHES = 11 * (4 * 2 + 1)
SCALE3D_FUSED_LAUNCHES = 12 * (5 * 2 + 1)
CONFIG4_COLOUR_LAUNCHES = 11 * (4 * 2 * 4 + 2 * 100)
# config 4 with the Jacobi smoother (omega 0.8) and with inner_cg=4: the
# JAX package on the CPU (XLA ops at these unaligned shapes) takes 23 and 4
# iterations to 1e-8 on this RHS.  Jacobi launches: 23 iterations x (4
# smoothed levels x 2 calls on the march + the 17^3 bottom's 100 sweeps in
# one resident launch); with the per-sweep oracle swapped in, 23 x (4 x 2 x
# 2 + 100) jacobi3d_sweep launches
JACOBI3D_KW = dict(CONFIG4_KW, smoother="jacobi", omega=0.8)
JACOBI3D_ITERATIONS = 23
JACOBI3D_LAUNCHES = 23 * (4 * 2 + 1)
JACOBI3D_SWEEP_LAUNCHES = 23 * (4 * 2 * 2 + 100)
INNER_CG3D_ITERATIONS = 4
# the fused 3D Jacobi is held to its twin and to the per-sweep oracle at
# every sweep count here (5-9: launches of 4 + 1 .. 4 + 4 + 1) and at the
# bottom's 100, omega 0.8 and 1; its ladder at 257^3
JACOBI3D_SWEEPS = tuple(range(10)) + (100,)
LADDER_JACOBI3D = (1, 2, 4, 9)
# D: 65^3 in (72, 72, 128) buffers, 4 levels, 9^3 bottom (dense inverse);
# the bf16 .solve's tolerance sits above its f32 residual floor (the JAX
# package on the CPU floors at 8.4e-4 there and passes 2e-3 at iteration 6)
VARIANT3D_KW = dict(CONFIG4_KW, shape=(65, 65, 65), num_levels=4,
                    pad_align=(8, 8, 128), maxit=40)
BF16_TOL = 2e-3
# the non-cubic shape (physical, logical) that catches swapped axes, and
# one whose x-y extents are no multiple of the z-marching tile's core
NONCUBIC_3D = ((20, 24, 136), (17, 21, 129))
RAGGED_3D = ((19, 53, 101), None)
# the residual's march: x-y extents no multiple of its 64 x 8 tile, nz (71)
# no multiple of its z-chunk (2 planes here)
CHUNK_3D = ((71, 45, 77), None)
# residual launches per solve: one per smoothed level and iteration
CONFIG4_RESIDUAL_LAUNCHES = 11 * 4
SCALE3D_RESIDUAL_LAUNCHES = 12 * 5
TIME_SHAPES_3D = [((257, 257, 257), None), ((513, 513, 513), None)]
# config 4's coarser z-marching levels, where the fused smoother's 2-sweep
# call is timed too
COARSE_LEVELS_3D = ((129, 129, 129), (65, 65, 65), (33, 33, 33))
CONFIG4_BOTTOM = (17, 17, 17)
# the fused 3D smoother is held to its twin and to the per-colour oracle at
# every sweep count here on the z-marching route, at these and 100 on the
# resident one (the 17^3 bottom's coarse_sweeps); its ladder at 257^3 and
# 513^3
FUSED3D_SWEEPS = tuple(range(10))
BOTTOM_SWEEPS = 100
LADDER_3D = (1, 2, 4)
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
# bf16 defect correction, CUDA vs CPU: the elementwise bf16 ops round alike
# on both devices, the bf16 bottom matvec (cuBLAS vs the CPU BLAS) and the
# f32 norms do not; each such rounding is 2^-8 relative in a correction
BF16_HISTORY_RTOL = 1e-1

# the sharded GMG path (README.md's ShardedGMGSolver example, 8192^2, 6
# levels), f32, one rank on the card (NCCL): a fixed number of cycles, as f32
# floors far above the default tol at this size; the per-colour and grouped
# plain schedules agree with the kernel route to SHARD_HISTORY_RTOL where
# the history lies above 1e-3 (tests/test_sharded_gmg.py:252-255)
SHARD_KW = dict(shape=(8192, 8192), num_levels=6)
SHARD_CYCLES = 8
SHARD_HISTORY_RTOL = 2e-2
# rbgs_fused_extended against its twin and against colour sweeps of the
# global grid: slabs of R + 16 rows starting at global row row0 (the first,
# an interior and the last slab of 8192 rows), full and ragged widths, and a
# logical shape smaller than the buffer; alpha 1, h 1/2 (c = 4, so the
# colour sweep's b / c equals the kernel's b * (1/c))
EXT_ROWS = (8, 64, 2048)
EXT_ROW0 = (-8, 0, 4088, 8184, -7, 57)  # odd first rows: the parity
EXT_GRIDS = ((8192, (8192, 8192)), (330, (8192, 330)), (330, (8000, 300)))
EXT_TIME_SHAPE = (8208, 8192)  # one 8192-row slab with its halos
# several ranks on the one card (gloo; NCCL refuses two ranks on one GPU):
# 4 ranks at 2048^2 (bench.py's measure_sharded_on_one size, 5 levels) for
# GLOO_STEPS steps against one rank, and 2 ranks at 256^2 against the same
# ranks on the CPU (the twin)
GLOO_N, GLOO_LEVELS, GLOO_STEPS = 2048, 5, 3
GLOO_SOLVE = dict(shape=(256, 256), num_levels=4, tol=1e-2, maxit=60)
GLOO_DEADLINE_S = 600
# the sharded AMG path (parallel/sharded_amg.py): config 3's system and
# hierarchy (AMG_N, AMG_KW; the solver always takes RCM) to AMG_SOLVES' tol
# on one NCCL rank, against AMGSolver.solve and, on SAMG_RANKS gloo ranks
# sharing the card, bit for bit; the JAX ShardedAMGSolver on the CPU takes 5
# iterations over 1 and over 4 devices (gather route, f32), and shards the
# 5 upper levels over 4 (every halo of A, P and P^T > 0)
SAMG_KW_SOLVE = dict(smoother="chebyshev", tol=1e-5, maxit=200)
SAMG_KW = dict(num_levels=12, min_coarse=2000, **SAMG_KW_SOLVE)
SAMG_ITERATIONS = 5
SAMG_SHARDED = 5
SAMG_RANKS = 4
SAMG_TWIN_N = 256  # card vs CPU twin on one hierarchy


def swap(solver, **fields):
    """``solver`` with fields of its float32 route (``ops/routes.Route``)
    swapped, e.g. the smoother for an oracle: the same solve on other
    kernels."""
    solver._f32_route = solver._f32_route._replace(**fields)
    return solver


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def rhs_3d(torch, level, device):
    """Config 4's smooth 3D pair on ``level`` (bench.py:462-465)."""
    from multigrid_prj_tpu_torch.models.poisson import assemble_rhs

    return assemble_rhs(
        level, 1.0, device=device,
        f=lambda x, y, z: torch.sin(3.0 * x) * torch.cos(2.0 * y) + z,
        g=lambda x, y, z: torch.exp(x) * torch.exp(-2.0 * y) * z)


def level_shapes_3d(build_hierarchy, *solver_kws):
    """(physical, logical or None) of every level of the given 3D solver
    configurations, once each, in order."""
    out = []
    for kw in solver_kws:
        for lev in build_hierarchy(kw["shape"], kw["length"],
                                   kw["num_levels"],
                                   pad_align=kw.get("pad_align")):
            item = (lev.physical,
                    lev.shape if lev.padded_shape is not None else None)
            if item not in out:
                out.append(item)
    return out


def kernel_inputs_3d(torch, shape, logical, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    u, b = (torch.randn(shape, generator=gen, device="cuda")
            for _ in range(2))
    h = 1.0 / ((logical or shape)[0] - 1)
    return u, b, h


def kernel_calls_3d(c3, u, b, h, logical, alpha=1.0):
    """name -> [(label, kernel call, twin call)] on the same 3D inputs.
    The fused smoother runs every sweep count against the per-colour oracle
    and against the twin (the resident route also the bottom's 100); the
    fused Jacobi every count of ``JACOBI3D_SWEEPS``, omega 0.8 and 1,
    against the per-sweep oracle and the twin; the residual's march against
    its twin, the apply's against the one-thread-per-point kernel and the
    twin;
    the float-float residual against its twin, on a pair whose low half is
    ~1e-8 of ``u`` and the pair of ``b / c``; the exact-layout restriction
    of ``u`` and prolong-add of a coarse ``e`` into ``u`` against theirs;
    the last case of each, against the twin (the smoothers' at 2 sweeps,
    V(2,2), the Jacobi's at omega 0.8), is the one timed."""
    from multigrid_prj_tpu_torch.ops import extended as text
    from multigrid_prj_tpu_torch.ops import transfer as tr

    u_lo = u * 1e-8
    d_hi, d_lo = text.ff_from_div(b, alpha / (h * h))
    ff_args = (u, u_lo, d_hi, d_lo, b, alpha, h, logical)
    e = (b * 1e-3).flip(0).contiguous()  # a correction, ~1e-3 of u
    up_args = (u, u_lo, e, d_hi, d_lo, b, alpha, h, logical)
    ec = b[::2, ::2, ::2].contiguous()  # a coarse correction of u's grid

    def fused(s):
        return c3.red_black_gauss_seidel_3d(u, b, alpha, h, sweeps=s,
                                            logical_shape=logical)

    def twin(s):
        return c3.red_black_gauss_seidel_3d_plain(u, b, alpha, h, s, logical)

    def oracle(s):
        return c3._rbgs3d_per_colour(u, b, alpha, h, s, logical)

    def jacobi(s, w):
        return c3.jacobi_3d(u, b, alpha, h, omega=w, sweeps=s,
                            logical_shape=logical)

    def jac_twin(s, w):
        return c3.jacobi_3d_plain(u, b, alpha, h, w, s, logical)

    def per_sweep(s, w):
        return c3._jacobi3d_per_sweep(u, b, alpha, h, w, s, logical)

    counts = list(FUSED3D_SWEEPS)
    if c3.rbgs3d_route(u.shape) == "resident":
        counts.append(BOTTOM_SWEEPS)
    return {
        "rbgs3d_fused": (
            [(f"sweeps {s} vs the per-colour oracle", lambda s=s: fused(s),
              lambda s=s: oracle(s)) for s in counts]
            + [(f"sweeps {s}", lambda s=s: fused(s), lambda s=s: twin(s))
               for s in counts if s != 2]
            + [("sweeps 2", lambda: fused(2), lambda: twin(2))]),
        "rbgs3d_color": [("sweeps 2", lambda: oracle(2), lambda: twin(2))],
        "residual3d": [(
            "",
            lambda: c3.poisson_residual_3d(u, b, alpha, h, logical),
            lambda: c3.poisson_residual_3d_plain(u, b, alpha, h, logical))],
        "apply3d": [
            ("vs apply3d_point",
             lambda: c3.poisson_apply_3d(u, alpha, h, logical),
             lambda: c3._apply3d_launch(u, alpha, h, logical,
                                        "apply3d_point")),
            ("",
             lambda: c3.poisson_apply_3d(u, alpha, h, logical),
             lambda: c3.poisson_apply_3d_plain(u, alpha, h, logical))],
        "apply3d_point": [(
            "",
            lambda: c3._apply3d_launch(u, alpha, h, logical,
                                       "apply3d_point"),
            lambda: c3.poisson_apply_3d_plain(u, alpha, h, logical))],
        "jacobi3d": (
            [(f"sweeps {s}, omega {w} vs the per-sweep oracle",
              lambda s=s, w=w: jacobi(s, w), lambda s=s, w=w: per_sweep(s, w))
             for s in JACOBI3D_SWEEPS for w in (1.0, 0.8)]
            + [(f"sweeps {s}, omega {w}", lambda s=s, w=w: jacobi(s, w),
                lambda s=s, w=w: jac_twin(s, w))
               for s in JACOBI3D_SWEEPS for w in (1.0, 0.8)
               if (s, w) != (2, 0.8)]
            + [("sweeps 2, omega 0.8", lambda: jacobi(2, 0.8),
                lambda: jac_twin(2, 0.8))]),
        "jacobi3d_sweep": [("sweeps 2, omega 0.8", lambda: per_sweep(2, 0.8),
                            lambda: jac_twin(2, 0.8))],
        "ff_residual3d": [("", lambda: c3.ff_poisson_residual_3d(*ff_args),
                           lambda: text.ff_poisson_residual(*ff_args))],
        "ff_update_residual3d": fused_ff_calls(
            c3.ff_update_residual_3d, c3.ff_poisson_residual_3d, text,
            up_args),
        "restrict_fw3d": [("", lambda: c3.restrict_fw3d(u),
                           lambda: tr.restrict_full_weighting(u))],
        "prolong_add3d": [("", lambda: c3.prolong_add3d(ec, u),
                           lambda: u + tr.prolong(ec, u.shape))],
    }


def fused_ff_calls(fn, residual, text, args):
    """The fused pair update and float-float residual against the
    composition the path ran before (the plain pair update, then the
    residual kernel), then against the twin; the last case is timed."""
    def composition():
        hi, lo = text.ff_accumulate(*args[:3])
        return hi, lo, residual(hi, lo, *args[3:])

    return [("vs the composition", lambda: fn(*args), composition),
            ("", lambda: fn(*args), lambda: text.ff_update_residual(*args))]


def bench_u(torch, n, device="cuda"):
    """bench.py's chain input (``measure_stencil_chains``):
    ``1e-3 sin(0.01 i) cos(0.013 j)`` in f32."""
    i = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    j = torch.arange(n, dtype=torch.float32, device=device)[None, :]
    return (1e-3 * torch.sin(0.01 * i) * torch.cos(0.013 * j)).contiguous()


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
    e = (b * 1e-3).flip(0).contiguous()  # a correction, ~1e-3 of u
    up = (u, u_lo, e, d_hi, d_lo, b, alpha, h, logical)

    def fused(s):
        return cs.red_black_gauss_seidel(u, b, alpha, h, sweeps=s,
                                         logical_shape=logical)

    def twin(s):
        return cs.red_black_gauss_seidel_plain(u, b, alpha, h, s, logical)

    def oracle(s):
        return cs._rbgs_per_colour(u, b, alpha, h, s, logical)

    def jac(s, w):
        return cs.jacobi(u, b, alpha, h, omega=w, sweeps=s,
                         logical_shape=logical)

    def jac_twin(s, w):
        return cs.jacobi_plain(u, b, alpha, h, w, s, logical)

    def jac_sweeps(s, w):
        return cs._jacobi_per_sweep(u, b, alpha, h, w, s, logical)

    calls = {
        # every sweep count against the per-colour oracle, then the twin;
        # the last case, 2 sweeps (V(2,2)) against the twin, is the one
        # timed, the first 2-sweep case the oracle timed beside it
        "rbgs_fused": (
            [(f"sweeps {s} vs the per-colour oracle", lambda s=s: fused(s),
              lambda s=s: oracle(s))
             for s in sorted(FUSED_SWEEPS, key=lambda s: s != 2)]
            + [(f"sweeps {s}", lambda s=s: fused(s), lambda s=s: twin(s))
               for s in FUSED_SWEEPS if s != 2]
            + [("sweeps 2", lambda: fused(2), lambda: twin(2))]),
        "rbgs_color": [("sweeps 2", lambda: oracle(2), lambda: twin(2))],
        "residual": [(
            "",
            lambda: cs.poisson_residual(u, b, alpha, h, logical),
            lambda: cs.poisson_residual_plain(u, b, alpha, h, logical))],
        "ff_residual": [(
            "",
            lambda: cs.ff_poisson_residual(*ff),
            lambda: cs.ff_poisson_residual_plain(*ff))],
        "ff_update_residual": fused_ff_calls(
            cs.ff_update_residual, cs.ff_poisson_residual, text, up),
        "apply": [(
            "",
            lambda: cs.poisson_apply(u, alpha, h, logical),
            lambda: cs.poisson_apply_plain(u, alpha, h, logical))],
        # every sweep count, omega 1 and 0.8, against the per-sweep
        # kernel, then the twin; the last case, 2 sweeps with omega 0.8
        # (the Jacobi path's), is the one timed
        "jacobi": (
            [(f"sweeps {s}, omega {w} vs the per-sweep kernel",
              lambda s=s, w=w: jac(s, w), lambda s=s, w=w: jac_sweeps(s, w))
             for s in JACOBI_SWEEPS for w in (1.0, JACOBI_OMEGA)]
            + [(f"sweeps {s}, omega {w}", lambda s=s, w=w: jac(s, w),
                lambda s=s, w=w: jac_twin(s, w))
               for s in JACOBI_SWEEPS for w in (1.0, JACOBI_OMEGA)
               if (s, w) != (2, JACOBI_OMEGA)]
            + [(f"sweeps 2, omega {JACOBI_OMEGA}",
                lambda: jac(2, JACOBI_OMEGA),
                lambda: jac_twin(2, JACOBI_OMEGA))]),
        "jacobi_sweep": [(f"sweeps 2, omega {JACOBI_OMEGA}",
                          lambda: jac_sweeps(2, JACOBI_OMEGA),
                          lambda: jac_twin(2, JACOBI_OMEGA))],
    }
    calls["rbgs_color_sweep"] = [(
        f"color {col}",
        lambda col=col: cs.rbgs_color_sweep(u, b, alpha, h, col, logical),
        lambda col=col: cs.rbgs_color_sweep_plain(u, b, alpha, h, col,
                                                  logical))
        for col in (0, 1)]
    calls["apply_chain"] = chain_calls(cs, u, h, logical)
    n, m = u.shape
    if n % 2 == 0 and m % 2 == 0:  # the transfers live on padded levels
        lg = logical or (n, m)
        e = b[: n // 2, : m // 2].contiguous()
        calls["restrict_fw"] = [(
            "",
            lambda: cs.restrict_fw_padded_fast(u, lg),
            lambda: cs.restrict_fw_padded_fast_plain(u, lg))]
        calls["prolong_add"] = [
            (f"from {tuple(e.shape)} vs the point kernel",
             lambda: cs.prolong_add_padded_fast(e, u),
             lambda: cs._prolong_add_point(e, u)),
            (f"from {tuple(e.shape)}",
             lambda: cs.prolong_add_padded_fast(e, u),
             lambda: cs.prolong_add_padded_fast_plain(e, u))]
        calls["prolong_add_point"] = [(
            f"from {tuple(e.shape)}",
            lambda: cs._prolong_add_point(e, u),
            lambda: cs.prolong_add_padded_fast_plain(e, u))]
    if n % 2 == 0 and m % 2 == 0 and logical is not None:
        calls["rbgs_resfilter"] = downleg_calls(cs, u, b, h, logical, alpha)
    return calls


def chain_calls(cs, u, h, logical):
    """The apply chain at every count of ``CHAIN_APPLIES`` against its twin
    and against as many single apply launches, alpha = h^2 (c = 1 keeps 11
    applies of a unit-size field finite); the last case, 8 applies against
    the twin, is the one timed."""
    def chain(s):
        return cs.poisson_apply_chain(u, h * h, h, s, logical)

    def twin(s):
        return cs.poisson_apply_chain_plain(u, h * h, h, s, logical)

    def singles(s):
        x = u.clone()
        for _ in range(s):
            x = cs.poisson_apply(x, h * h, h, logical)
        return x

    return ([(f"{s} applies{tag}", lambda s=s: chain(s),
              lambda s=s, ref=ref: ref(s))
             for s in CHAIN_APPLIES
             for tag, ref in ((" vs single applies", singles), ("", twin))
             if (s, tag) != (CHAIN_FUSE, "")]
            + [(f"{CHAIN_FUSE} applies", lambda: chain(CHAIN_FUSE),
                lambda: twin(CHAIN_FUSE))])


def flat(x):
    """A call's result as one tensor: the down-leg returns u2 and the
    coarse residual, compared flattened and timed as they are."""
    if isinstance(x, tuple):
        import torch

        return torch.cat([t.reshape(-1) for t in x])
    return x


def downleg_calls(cs, u, b, h, logical, alpha):
    """The fused down-leg (u2 and the coarse residual) at sweeps 0-3
    against its twin and against the three kernels it fuses (the smoother
    as the fused kernel and as the per-colour oracle's launches); the last
    case, 2 sweeps against the twin, is the one timed, the one before it
    the composition the path ran before (the per-colour oracle, the
    residual and the restriction) timed beside it."""
    def fused(s):
        return cs.rbgs_residual_restrict(u, b, alpha, h, s, logical)

    def twin(s):
        return cs.rbgs_residual_restrict_plain(u, b, alpha, h, s, logical)

    def composition(s, per_colour=True):
        u2 = (cs._rbgs_per_colour(u, b, alpha, h, s, logical) if per_colour
              else cs.red_black_gauss_seidel(u, b, alpha, h, sweeps=s,
                                             logical_shape=logical))
        r = cs.poisson_residual(u2, b, alpha, h, logical)
        return u2, cs.restrict_fw_padded_fast(r, logical)

    return ([(f"sweeps {s}", lambda s=s: fused(s), lambda s=s: twin(s))
             for s in DOWNLEG_SWEEPS if s != 2]
            + [(f"sweeps {s} vs the kernels it fuses (fused smoother)",
                lambda s=s: fused(s),
                lambda s=s: composition(s, per_colour=False))
               for s in DOWNLEG_SWEEPS]
            + [(f"sweeps {s} vs the kernels it fuses", lambda s=s: fused(s),
                lambda s=s: composition(s)) for s in (0, 1, 3, 2)]
            + [("sweeps 2", lambda: fused(2), lambda: twin(2))])


def tile_kernel_report(cs, c3, log):
    """Registers, spills and shared memory of the colour-split tile kernels
    (``rbgs_fused_kernel<S>``, ``rbgs_resfilter_kernel<S>``,
    ``rbgs_fused_ext_kernel<S>``), of the z-marching 3D tile
    (``rbgs3d_zmarch_kernel<S>``), of the row-walking tiles of the apply
    chain and the Jacobi smoother (``apply_chain_kernel<A>``,
    ``jacobi_fused_kernel<S>``), of the prolong-add stream, of the
    residual's and apply's z-chunked march (``stencil3d_march_kernel``) and
    of the 3D Jacobi's (``jacobi3d_march_kernel<S>``) and of the 3D
    float-float residual's (``ff_residual3d_march_kernel``) from nvcc's
    ``-Xptxas -v`` log; the tile kernels' shared memory is dynamic, so it
    comes from the tile geometry the wrapper passes (``cs.rbgs_tile``,
    ``c3.rbgs3d_tile``, ``cs.apply_tile``, ``cs.jacobi_tile``,
    ``c3.jacobi3d_tile``, ``c3.ff_residual3d_tile``); the residual
    march's is static, from the log."""
    import re

    props, cur = {}, None
    for ln in log.splitlines():
        hit = re.search(r"(?:Compiling entry function|Function properties "
                        r"for) '?(\w+)", ln)
        if hit:
            cur = hit.group(1)
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
        if spill and cur:
            props.setdefault(cur, {})["spills"] = spill.groups()
        used = re.search(r"Used (\d+) registers", ln)
        if used and cur:
            props.setdefault(cur, {})["regs"] = used.group(1)
        smem = re.search(r"(\d+) bytes smem", ln)
        if smem and cur:
            props.setdefault(cur, {})["smem"] = smem.group(1)
    out = []
    for kind, extra in (("rbgs_fused_kernel", 0), ("rbgs_resfilter_kernel",
                                                   2),
                        ("rbgs_fused_ext_kernel", 0),
                        ("rbgs3d_zmarch_kernel", None)):
        for mangled, pr in sorted(props.items()):
            hit = re.search(kind + r"ILi(\d)EE", mangled)
            if not hit:
                continue
            sweeps = int(hit.group(1))
            if extra is None:
                _, _, rows, cols, ru, rb, _ = c3.rbgs3d_tile(
                    2 * sweeps, TIME_SHAPES_3D[0][0])
                smem = 4 * (ru + rb) * rows * cols
                what = (f"rings of {ru} u and {rb} b planes of a {rows} x "
                        f"{cols} tile, two colour planes each")
            else:
                rows = cs.rbgs_tile(2 * sweeps + extra)[2]
                smem = 4 * (rows * 64 + 16) * 4
                what = (f"{rows} x 128 tile of u and b, two colour planes "
                        "each")
            st, ld = pr.get("spills", ("?", "?"))
            out.append(f"{kind}<{sweeps}>: {pr.get('regs', '?')} registers, "
                       f"spill stores {st} B, spill loads {ld} B, dynamic "
                       f"shared memory {smem} B ({what})")
    for mangled, pr in sorted(props.items()):
        hit = re.search(r"apply_chain_kernelILi(\d)EE", mangled)
        st, ld = pr.get("spills", ("?", "?"))
        if hit:
            applies = int(hit.group(1))
            _, hc, rows, cols = cs.apply_tile(applies)
            out.append(f"apply_chain_kernel<{applies}>: "
                       f"{pr.get('regs', '?')} registers, spill stores {st} "
                       f"B, spill loads {ld} B, dynamic shared memory "
                       f"{2 * 4 * rows * cols} B (two {rows} x {cols} "
                       f"buffers, halo {applies} rows, {hc} columns)")
        hit = re.search(r"jacobi_fused_kernelILi(\d)EE", mangled)
        if hit:
            sweeps = int(hit.group(1))
            _, hc, rows, cols = cs.jacobi_tile(sweeps)
            out.append(f"jacobi_fused_kernel<{sweeps}>: "
                       f"{pr.get('regs', '?')} registers, spill stores {st} "
                       f"B, spill loads {ld} B, dynamic shared memory "
                       f"{2 * 4 * rows * cols} B (two {rows} x {cols} "
                       f"buffers, halo {sweeps} rows, {hc} columns; b * (1/c)"
                       " in registers)")
        elif "prolong_add_stream_kernel" in mangled:
            strip, quads = cs.prolong_tile()
            out.append(f"prolong_add_stream_kernel: {pr.get('regs', '?')} "
                       f"registers, spill stores {st} B, spill loads {ld} B, "
                       f"no shared memory (strips of {strip} coarse rows, "
                       f"{quads} quads per block)")
        elif "ff_update_residual3d_march_kernel" in mangled:
            tx, ty, _, ahead = c3.ff_residual3d_tile((1, 1, 1))
            slot = 3 * (tx + 2) * (ty + 2) + 3 * tx * ty
            out.append(f"ff_update_residual3d_march_kernel: "
                       f"{pr.get('regs', '?')} registers, spill stores {st} "
                       f"B, spill loads {ld} B, dynamic shared memory "
                       f"{4 * (ahead + 2) * slot} B ({ahead + 2} slots of "
                       f"plane copies of u_hi, u_lo and e with a ring, d_hi, "
                       f"d_lo and b)")
        elif "ff_residual3d_march_kernel" in mangled:
            tx, ty, _, ahead = c3.ff_residual3d_tile((1, 1, 1))
            slot = 2 * (tx + 2) * (ty + 2) + 3 * tx * ty
            out.append(f"ff_residual3d_march_kernel: {pr.get('regs', '?')} "
                       f"registers, spill stores {st} B, spill loads {ld} B, "
                       f"dynamic shared memory {4 * (ahead + 2) * slot} B "
                       f"({ahead + 2} slots of plane copies of u_hi and "
                       f"u_lo with a ring, d_hi, d_lo and b)")
        elif "stencil3d_march_kernel" in mangled:
            what = ("residual3d: a ring of plane copies and b"
                    if "ILb1EE" in mangled else "apply3d: a ring of plane "
                    "copies")
            out.append(f"stencil3d_march_kernel: {pr.get('regs', '?')} "
                       f"registers, spill stores {st} B, spill loads {ld} B, "
                       f"static shared memory {pr.get('smem', '?')} B "
                       f"({what})")
        hit = re.search(r"jacobi3d_march_kernelILi(\d)EE", mangled)
        if hit:
            sweeps = int(hit.group(1))
            tx, ty, halo, _, ahead = c3.jacobi3d_tile((1, 1, 1), sweeps)
            planes = (ahead + 2) + (ahead + 1) + 2 * (sweeps - 1)
            out.append(f"jacobi3d_march_kernel<{sweeps}>: "
                       f"{pr.get('regs', '?')} registers, spill stores {st} "
                       f"B, spill loads {ld} B, dynamic shared memory "
                       f"{4 * planes * tx * ty} B ({planes} planes of a "
                       f"{tx} x {ty} tile: u and b rings, two per "
                       f"intermediate sweep; halo {halo})")
    return out


def bound(nbytes, flops):
    """The least time (ms) the card could take for work that moves
    ``nbytes`` and does ``flops`` f32 operations, and which of the two
    bounds it (published H100 SXM peaks)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def ell_cost(kname, E, nvec=1):
    """(bytes, flops) of one ELL kernel call on the CudaELL ``E``: the slot
    arrays as stored, the vectors read and written once; flops of the
    stored nonzeros."""
    K, n = E.colsT.shape
    m = E.shape[1]
    if kname == "ff_residual_ell":
        return 12 * K * n + 8 * m + 12 * n, 30 * E.nnz
    if kname == "spmv_axpy":  # z read, y written
        return 8 * K * n + 4 * m + 8 * n, 2 * E.nnz + n
    if kname == "cheb_step":  # a later step: b, d, p read; p, x_out written
        return 8 * K * n + 4 * m + 20 * n, 2 * E.nnz + 6 * n
    return 8 * K * n + 4 * nvec * (m + n), 2 * E.nnz * nvec


def csr_library(torch, M, device="cuda"):
    """``M`` as a ``torch.sparse_csr_tensor`` (f32, int32 indices) on the
    card: the library yardstick (cuSPARSE) timed beside the ELL kernels and
    used nowhere in the port."""
    import numpy as np

    return torch.sparse_csr_tensor(
        torch.from_numpy(M.indptr.astype(np.int32)),
        torch.from_numpy(M.indices.astype(np.int32)),
        torch.from_numpy(M.data.astype(np.float32)), M.shape,
        check_invariants=True).to(device)


def record(at, ms, plain_ms, nbytes, flops, library_ms=None, **extra):
    """One timing entry of the kernel table."""
    b_ms, by = bound(nbytes, flops)
    return dict(at=at, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                library_ms=library_ms, **extra)


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


def graph_ms(torch, fn, reps=20, runs=10):
    """Device time (ms) per call of ``fn`` with the host out of the way:
    ``reps`` calls as one program (``benchmarks/program.py``: one CUDA
    graph), its replays timed with CUDA events (median of ``runs``).  For
    kernels shorter than the Python wrapper's launch cost, where
    ``median_ms`` of one call times the host."""
    from multigrid_prj_tpu_torch.benchmarks.program import Program

    prog = Program(fn, reps=reps, cuda=True)
    ms = median_ms(torch, prog.replay, runs=runs, warmup=2)
    del prog
    return ms / reps


def device_ms(torch, fn, npts):
    """``graph_ms`` of one kernel call on ``npts`` points: the yardstick of
    the probes (rows 20-21) for the kernels timed one call at a time."""
    return graph_ms(torch, fn, reps=20 if npts < 4_000_000 else 5, runs=5)


def flushed_ms(torch, fn, runs=10):
    """Median device time (ms) of one call of ``fn`` with L2 flushed before
    it: a read of ``FLUSH_BYTES``, enqueued first, lasts longer than the
    host's launch of ``fn``, so the events time the kernel alone on a cold
    L2 (CUDA events, synchronised per run)."""
    buf = torch.ones(FLUSH_BYTES // 4, device="cuda")
    sink = torch.empty((), device="cuda")
    fn()
    times = []
    for _ in range(runs):
        torch.sum(buf, dim=0, out=sink)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    del buf
    return statistics.median(times)


def stencil_bytes(kname, shape, logical):
    """Bytes one call of a 2D or 3D stencil kernel must move at ``shape``:
    ``STENCIL_COST``'s per-point count, except that the float-float
    residuals read no ``d_hi`` / ``d_lo`` at boundary and dead-zone points
    (16 B there, 24 B inside; with the fused pair update 28 and 36)."""
    npts = math.prod(shape)
    if kname not in ("ff_residual", "ff_residual3d", "ff_update_residual",
                     "ff_update_residual3d"):
        return STENCIL_COST[kname][0] * npts
    inside = math.prod(n - 2 for n in (logical or shape))
    per = STENCIL_COST[kname][0]
    return per * inside + (per - 8) * (npts - inside)


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


# -- AMG helpers (device-generic, so the phases can be rehearsed on the CPU
# at small sizes; the script itself runs them on CUDA only) -----------------


def sync(torch, dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def amg_setup(torch, AMGSolver, A, dev, **kw):
    """``AMGSolver(A, **kw)`` on ``dev`` and its set-up seconds (host setup,
    RCM, Galerkin products, device levels and kernel layouts)."""
    t0 = time.perf_counter()
    solver = AMGSolver(A, **kw, device=dev)
    sync(torch, dev)
    return solver, time.perf_counter() - t0


def cpu_twin_solver(torch, AMGSolver, solver):
    """The same hierarchy on the CPU, through the kernels' twins."""
    return AMGSolver.from_hierarchy(
        solver.host_matrices, solver.host_P, perm=solver._perm,
        lmax=[lv.lmax for lv in solver.levels],
        smoother=solver.smoother_name, dtype=torch.float32, use_pallas=True,
        device="cpu")


def level_lines(solver):
    """Per level: rows, ELL width K, and what runs its A / P / P^T."""
    out = []
    for i, lv in enumerate(solver.levels):
        a = ("bottom inverse" if i == len(solver.levels) - 1 else
             "dense" if lv.A_dense is not None else
             "A_fast" if lv.A_fast is not None else "gather")
        p = ("" if lv.P is None else
             f", P {'P_fast' if lv.P_fast is not None else 'gather'} "
             f"(K {lv.P.k}), Pt {'Pt_fast' if lv.Pt_fast is not None else 'gather'}"
             f" (K {lv.Pt.k})")
        out.append(f"level {i}: {solver.level_sizes[i]} rows, K {lv.A.k}, "
                   f"A {a}{p}")
    return out


def check_spmv_cases(torch, cv, cases, dev, seed):
    """Each ``(label, CudaELL)``: the SpMV kernel vs its twin on the same
    random x; returns the largest |difference|."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    worst = 0.0
    for label, E in cases:
        x = torch.randn(E.shape[1], generator=gen, device=dev)
        got = E.spmv(x)
        want = cv.ell_spmv_plain(E.colsT, E.valsT, x)
        sync(torch, dev)
        err = float((got - want).abs().max()) if got.numel() else 0.0
        worst = max(worst, err)
        check(torch.equal(got, want),
              f"ell_spmv != twin on {label} (max abs diff {err})")
        print(f"[amg kernels] ell_spmv on {label}: {E.shape[0]} x "
              f"{E.shape[1]}, K {E.k}, {E.nnz} nnz: equal to its twin "
              "(torch.equal)")
    return worst


def check_fused_cases(torch, cv, cases, dev, seed):
    """Each ``(label, CudaELL)``: the SpMV-and-add kernel (``z - A x``,
    ``z + A x``) and, on a square matrix, the Chebyshev steps (the first
    from ``x`` and from zero, a later one) vs their twins on the same
    random vectors (``torch.equal``); returns the largest |difference| of
    each, as ``(spmv_axpy, cheb_step)``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    worst = [0.0, 0.0]

    def same(got, want, k, what):
        sync(torch, dev)
        err = float((got - want).abs().max()) if got.numel() else 0.0
        worst[k] = max(worst[k], err)
        check(torch.equal(got, want), f"{what} != twin (max abs diff {err})")

    for label, E in cases:
        n, m = E.shape
        x = torch.randn(m, generator=gen, device=dev)
        z = torch.randn(n, generator=gen, device=dev)
        for subtract in (True, False):
            same(cv.ell_spmv_axpy(E.colsT, E.valsT, x, z, subtract),
                 cv.ell_spmv_axpy_plain(E.colsT, E.valsT, x, z, subtract), 0,
                 f"ell_spmv_axpy (subtract {subtract}) on {label}")
        same(E.spmv_add(x, z), z + E.spmv(x), 0, f"spmv_add on {label}")
        done = "ell_spmv_axpy"
        if n == m:
            same(E.residual(x, z), z - E.spmv(x), 0, f"residual on {label}")
            d = torch.rand(n, generator=gen, device=dev) + 0.5
            for x0 in (x, None):
                p, xo = E.cheb_step(x0, z, d, None, 0.0, 1.7, True)
                pw, xw = cv.ell_cheb_step_plain(E.colsT, E.valsT, x0, z, d,
                                                None, 0.0, 1.7, True)
                same(p, pw, 1, f"ell_cheb_step (first) p on {label}")
                same(xo, xw, 1, f"ell_cheb_step (first) x on {label}")
                p2, xo2 = E.cheb_step(xo, z, d, p, 0.61, 0.37, False)
                pw2, xw2 = cv.ell_cheb_step_plain(E.colsT, E.valsT, xw, z, d,
                                                  pw, 0.61, 0.37, False)
                same(p2, pw2, 1, f"ell_cheb_step p on {label}")
                same(xo2, xw2, 1, f"ell_cheb_step x on {label}")
            done += " and ell_cheb_step (first from x and from zero, later)"
        print(f"[amg kernels] {done} on {label}: {n} x {m}, K {E.k}, "
              f"{E.nnz} nnz: equal to their twins (torch.equal)")
    return tuple(worst)


def amg_launches(solver, method, k):
    """The ELL launches a ``method`` solve of ``k`` iterations makes on
    ``solver``'s kernel path (Chebyshev, V(1, 1)): per cycle, each level
    above the bottom whose A is a kernel (no dense matrix) runs
    ``2 * cheb_degree`` Chebyshev steps and its residual, each whose P is
    one its prolong-add (``spmv_axpy``), each whose P^T is one its
    restriction (``spmv``).  ``solve``: k cycles and k + 1 stop tests on
    level 0's residual; ``solve_pcg``: k + 1 cycles (the preconditioner)
    and k + 1 applies of level 0's A; ``solve_refined``: k cycles and k + 1
    float-float residuals."""
    above = solver.levels[:-1]
    a = sum(lv.A_fast is not None and lv.A_dense is None for lv in above)
    p = sum(lv.P_fast is not None for lv in above)
    pt = sum(lv.Pt_fast is not None for lv in above)
    lv0 = solver.levels[0]
    fast0 = int(lv0.A_fast is not None and lv0.A_dense is None)
    cycles = k + 1 if method == "solve_pcg" else k
    want = {"spmv": pt * cycles, "spmv_axpy": (a + p) * cycles,
            "cheb_step": 2 * solver.cheb_degree * a * cycles,
            "ff_residual_ell": 0}
    if method == "solve":
        want["spmv_axpy"] += (k + 1) * fast0
    elif method == "solve_pcg":
        want["spmv"] += (k + 1) * fast0
    else:
        want["ff_residual_ell"] = k + 1
    return want


def check_spmm_cases(torch, cv, cases, dev, seed):
    """Each ``(label, host CSR, CudaELL)``: the SpMM kernel with 1, 4 and 9
    vectors (9: two launches) vs its twin and, column by column, the SpMV
    kernel (``torch.equal``), and vs the f64 product of the same matrix
    within 4 ulp (f32) of ``|A| |X|``; returns the largest |kernel -
    twin|."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    worst = 0.0
    for label, M, E in cases:
        E64 = cv.CudaELL.build(M, dtype=torch.float64, device=dev)
        for nvec in (1, 4, 9):
            X = torch.randn(E.shape[1], nvec, generator=gen, device=dev)
            got = E.spmm(X)
            want = cv.ell_spmm_plain(E.colsT, E.valsT, X)
            sync(torch, dev)
            err = float((got - want).abs().max())
            worst = max(worst, err)
            check(torch.equal(got, want),
                  f"ell_spmm != twin on {label}, {nvec} vectors ({err})")
            check(all(torch.equal(got[:, j], E.spmv(X[:, j].contiguous()))
                      for j in range(nvec)),
                  f"ell_spmm != per-column spmv on {label}, {nvec} vectors")
            exact = cv.ell_spmm_plain(E64.colsT, E64.valsT, X.double())
            scale = cv.ell_spmm_plain(E64.colsT, E64.valsT.abs(),
                                      X.double().abs())
            ratio = float(((got.double() - exact).abs()
                           / (4 * EPS32 * scale).clamp_min(1e-300)).max())
            check(ratio <= 1.0, f"ell_spmm on {label}, {nvec} vectors: "
                  f"{ratio:.3g} of the f64 bound")
        print(f"[amg kernels] ell_spmm on {label}: {E.shape[0]} x "
              f"{E.shape[1]}, K {E.k}, 1 / 4 / 9 vectors: equal to its twin "
              "and to per-column spmv (torch.equal); within 4 ulp of "
              "|A||X| of the f64 product")
        del E64
    return worst


def check_ff_residual(torch, cv, HostCSR, ff_pair_from_f64, A, E, dev, seed):
    """The float-float residual kernel on ``A`` (its pair layout ``E``) with
    random pairs near a solution, vs its twin (``torch.equal``) and vs the
    f64 residual of the pair system within one f32 rounding plus
    ``FF_BOUND_SCALE`` of ``|b| + |A| |x|``; returns (max |kernel - twin|,
    max error / bound, the plain f32 residual's max error / bound)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x64 = rng.standard_normal(A.shape[0])
    b64 = A.spmv(x64) + 1e-6 * rng.standard_normal(A.shape[0])
    bh, bl = ff_pair_from_f64(b64, device=dev)
    xh, xl = ff_pair_from_f64(x64, device=dev)
    got = E.residual_ff(bh, bl, xh, xl)
    want = cv.ell_ff_residual_plain(E.colsT, E.valsT, E.valsT_lo, bh, bl, xh,
                                    xl)
    plain = bh - cv.ell_spmv_plain(E.colsT, E.valsT, xh)
    sync(torch, dev)
    err = float((got - want).abs().max())
    check(torch.equal(got, want),
          f"ell_ff_residual != twin (max abs diff {err})")
    vh = A.data.astype(np.float32).astype(np.float64)
    vl = (A.data - vh).astype(np.float32).astype(np.float64)
    xp = xh.cpu().numpy().astype(np.float64) + xl.cpu().numpy()
    bp = bh.cpu().numpy().astype(np.float64) + bl.cpu().numpy()
    r64 = bp - HostCSR(A.indptr, A.indices, vh + vl, A.shape).spmv(xp)
    scale = np.abs(bp) + HostCSR(A.indptr, A.indices, np.abs(A.data),
                                 A.shape).spmv(np.abs(xp))
    bound = EPS32 * np.abs(r64) + FF_BOUND_SCALE * scale
    ratio = float((np.abs(got.cpu().numpy() - r64) / bound).max())
    plain_ratio = float((np.abs(plain.cpu().numpy() - r64) / bound).max())
    check(ratio <= 1.0, f"ell_ff_residual vs the f64 residual: {ratio:.3g} "
          "of the bound")
    return err, ratio, plain_ratio


def true_rel_residual(A, b64, x):
    """``||b - A x|| / ||b||`` in f64 on the host (x numpy or a tensor)."""
    import numpy as np

    x = x if isinstance(x, np.ndarray) else x.cpu().numpy()
    r = b64 - A.spmv(x.astype(np.float64))
    return float(np.linalg.norm(r) / np.linalg.norm(b64))


def profile_run(torch, fn):
    """One run of ``fn`` under ``torch.profiler``: (host wall s, summed
    device-kernel seconds, device events, top device ops by time as
    (name, (us, count))).  The kernels of one stream run one at a time, so
    the summed kernel time is the device's busy time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    n = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n += 1
        us, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), cnt + 1)
    busy = sum(us for us, _ in by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return wall, busy, n, top


def run_amg(torch, phases, launches, max_err, dev="cuda", n=AMG_N,
            twin_n=AMG_TWIN_N, fem_n=FEM_N, cli_n=CLI_N, spmm_n=SPMM_N,
            p1_n=P1_N, expected=True):
    """The AMG phases: kernels vs twins on the path's matrices (with the
    SpMM on banded_csr(spmm_n) and the level-0 operators, the fused cycle
    kernels on every level and on the RCM'd P1 p1_n^2 system), the n^2 FD
    solves (the main AMG path, counted into ``launches``), the twin_n^2
    CUDA-vs-CPU-twin solves, the FEM solves and the ``amg_main`` CLI.
    ``expected`` holds the n = 1024 counts.  Returns what the times phase
    needs."""
    import numpy as np

    from multigrid_prj_tpu_torch import native
    from multigrid_prj_tpu_torch.amg import AMGSolver
    from multigrid_prj_tpu_torch.models.fem import (
        P1System,
        assemble_p1,
        structured_unit_square_mesh,
    )
    from multigrid_prj_tpu_torch.models.poisson import (
        banded_csr,
        poisson_fd_csr,
    )
    from multigrid_prj_tpu_torch.ops import cuda_spmv as cv
    from multigrid_prj_tpu_torch.ops import cuda_stencil as cs
    from multigrid_prj_tpu_torch.ops.sparse import HostCSR
    from multigrid_prj_tpu_torch.ops.sparse_extended import ff_pair_from_f64
    from multigrid_prj_tpu_torch.utils.io import load_vector, save_matrix_market

    on_cuda = torch.device(dev).type == "cuda"
    # the GMG phases' solvers still hold device memory: count from here
    base = torch.cuda.memory_allocated() if on_cuda else 0
    phases.next(f"AMG {n}^2 set-up")
    A = poisson_fd_csr(n)
    amg, setup_s = amg_setup(torch, AMGSolver, A, dev, **AMG_KW)
    held = torch.cuda.memory_allocated() - base if on_cuda else 0
    print(f"[amg] native library available: {native.available()}")
    print(f"[amg] poisson_fd_csr({n}): {A.shape[0]} rows, {A.nnz} nnz; "
          f"set-up {setup_s:.2f} s; levels {amg.level_sizes}; operator "
          f"complexity {amg.operator_complexity:.3f}; dtype {amg.dtype}, "
          f"smoother {amg.smoother_name}")
    for line in level_lines(amg):
        print(f"[amg] {line}")
    if expected:
        check(amg.level_sizes == AMG_LEVELS and
              round(amg.operator_complexity, 3) == 2.711,
              f"AMG hierarchy {amg.level_sizes} differs from {AMG_LEVELS}")

    phases.next("AMG kernels vs twins")
    rng = np.random.default_rng(5)
    shuffled = A.permute(rng.permutation(A.shape[0]))
    lv = amg.levels
    cases = [(f"the RCM'd FD {n}^2 (level 0 A_fast)", lv[0].A_fast),
             (f"a randomly permuted FD {n}^2 (non-banded)",
              cv.CudaELL.build(shuffled, device=dev)),
             ("level 0 P_fast (smoothed P)", lv[0].P_fast),
             ("level 0 Pt_fast (its transpose)", lv[0].Pt_fast)]
    cases += [(f"level {i} A_fast (Galerkin coarse operator)", lv[i].A_fast)
              for i in range(1, len(lv))]
    if expected:  # 1024^2: levels 0-3 run the kernels, with both transfers
        check(all(E is not None for _, E in cases[:7]),
              "a kernel operator of the 1024^2 hierarchy is missing")
    cases = [(label, E) for label, E in cases if E is not None]
    del shuffled
    max_err["spmv"] = max(max_err["spmv"],
                          check_spmv_cases(torch, cv, cases, dev, seed=7))
    # the fused cycle kernels on every kernel operator of the hierarchy,
    # and on the P1 cell's fine level (RCM'd as the solver orders it)
    fused = [(f"level {i} {name}", E) for i, lvl in enumerate(lv)
             for name, E in (("A_fast", lvl.A_fast), ("P_fast", lvl.P_fast),
                             ("Pt_fast", lvl.Pt_fast)) if E is not None]
    if p1_n:
        t0 = time.perf_counter()
        P1 = P1System(structured_unit_square_mesh(p1_n)).A
        P1 = P1.permute(P1.rcm_permutation())
        fused.append((f"the RCM'd P1 {p1_n}^2 system (the AMG cell's level "
                      f"0; {time.perf_counter() - t0:.1f} s to assemble)",
                      cv.CudaELL.build(P1, device=dev)))
        del P1
    errs = check_fused_cases(torch, cv, fused, dev, seed=10)
    for k, err in zip(("spmv_axpy", "cheb_step"), errs):
        max_err[k] = max(max_err[k], err)
    del fused
    host0, hP = amg.host_matrices[0], amg.host_P[0]
    spmm_cases = [(f"banded_csr({spmm_n})", banded_csr(spmm_n), None),
                  (f"the RCM'd FD {n}^2 (level 0)", host0, lv[0].A_fast),
                  ("level 0 P", hP, lv[0].P_fast),
                  ("level 0 P^T", hP.transpose(), lv[0].Pt_fast)]
    spmm_cases = [(label, M, E if E is not None
                   else cv.CudaELL.build(M, device=dev))
                  for label, M, E in spmm_cases]
    max_err["ell_spmm"] = max(max_err["ell_spmm"], check_spmm_cases(
        torch, cv, spmm_cases, dev, seed=9))
    del spmm_cases
    pair = cv.CudaELL.build(amg.host_matrices[0], pair=True, device=dev)
    err, ratio, plain_ratio = check_ff_residual(
        torch, cv, HostCSR, ff_pair_from_f64, amg.host_matrices[0], pair, dev,
        seed=8)
    max_err["ff_residual_ell"] = max(max_err["ff_residual_ell"], err)
    print(f"[amg kernels] ell_ff_residual on the RCM'd FD {n}^2 with random "
          "pairs: equal to its twin (torch.equal); vs the f64 residual of "
          f"the pair system {ratio:.3g} of the bound (eps_f32 |r| + "
          f"{FF_BOUND_SCALE} (|b| + |A||x|)); a plain f32 residual: "
          f"{plain_ratio:.3g} of it")

    phases.next(f"AMG {n}^2 solves")
    b = np.random.default_rng(0).standard_normal(A.shape[0]).astype(np.float32)
    b64 = b.astype(np.float64)
    b_dev = torch.from_numpy(b).to(dev)
    if on_cuda:
        torch.cuda.reset_peak_memory_stats()
    results = {}
    for method, tol, iters in AMG_SOLVES:
        cs.reset_launch_counts()
        res = getattr(amg, method)(b_dev, tol=tol)
        sync(torch, dev)
        counts = {k: cs.LAUNCHES[k] for k in KERNELS_AMG}
        for k, v in counts.items():
            launches[k] += v
        x = res.x
        true_rel = true_rel_residual(A, b64, x)
        print(f"[amg {n}] {method}(tol={tol}): {res.iterations} iterations "
              f"(expected {iters}), final rel. residual "
              f"{res.rel_residual:.3e}; true f64 rel. residual of x "
              f"{true_rel:.3e}")
        print(f"[amg {n}] {method} history "
              f"{[float(h) for h in res.history]}")
        print(f"[amg {n}] {method} kernel launches: {counts}")
        check(res.rel_residual <= tol and len(x) == A.shape[0]
              and bool(np.isfinite(np.asarray(
                  x if isinstance(x, np.ndarray) else x.cpu())).all()),
              f"AMG {method}: not converged or a bad solution")
        if expected:
            check(res.iterations == iters,
                  f"AMG {method}: {res.iterations} iterations, expected "
                  f"{iters}")
        if on_cuda:
            want = amg_launches(amg, method, res.iterations)
            check(counts == want, f"AMG {method}: kernel launches {counts},"
                  f" the path's {want}")
        results[method] = (tol, res)
    if on_cuda:
        print(f"[amg {n}] device memory of the AMG path: the hierarchy "
              f"{held / 2**30:.3f} GiB (gather ELLs and kernel layouts of "
              f"every level), peak during the solves "
              f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.3f} GiB "
              "(with the kernel checks' pair layout)")

    phases.next(f"AMG {twin_n}^2 CUDA vs CPU twins")
    small, setup_s = amg_setup(torch, AMGSolver, poisson_fd_csr(twin_n), dev,
                               **AMG_KW)
    print(f"[amg {twin_n}] set-up {setup_s:.2f} s; levels "
          f"{small.level_sizes}")
    b_small = np.random.default_rng(0).standard_normal(
        small.level_sizes[0]).astype(np.float32)
    compare_twin_solves(torch, f"amg {twin_n}", small,
                        cpu_twin_solver(torch, AMGSolver, small), b_small,
                        [(m, tol) for m, tol, _ in AMG_SOLVES])
    del small

    phases.next("AMG FEM and CLI")
    env = dict(os.environ, PYTHONPATH=REPO)
    with tempfile.TemporaryDirectory() as tmp:
        fd_cli = poisson_fd_csr(cli_n)
        mtx = os.path.join(tmp, f"fd{cli_n}.mtx")
        save_matrix_market(mtx, *fd_cli.to_coo(), fd_cli.shape)
        argv = ["-matrix", mtx, "-precision", "ff32", "-tol", "1e-8",
                "-device", torch.device(dev).type]
        cli = subprocess.Popen(
            [sys.executable, "-m", "multigrid_prj_tpu_torch.cli.amg_main",
             *argv], cwd=tmp, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        try:
            A_fem, rhs = assemble_p1(structured_unit_square_mesh(fem_n))
            fem, setup_s = amg_setup(torch, AMGSolver, A_fem, dev)
            print(f"[fem] P1 on structured_unit_square_mesh({fem_n}): "
                  f"{A_fem.shape[0]} dofs, {A_fem.nnz} nnz; set-up "
                  f"{setup_s:.2f} s; levels {fem.level_sizes}")
            for line in level_lines(fem):
                print(f"[fem] {line}")
            compare_twin_solves(torch, "fem", fem,
                                cpu_twin_solver(torch, AMGSolver, fem), rhs,
                                FEM_SOLVES)
            out, _ = cli.communicate(timeout=600)
        finally:
            if cli.poll() is None:
                cli.kill()
                cli.wait()
        check(cli.returncode == 0, f"amg_main {argv} failed:\n{out}")
        check("not converged" not in out, f"amg_main {argv}:\n{out}")
        hist = load_vector(os.path.join(tmp, "amg_history.txt"))
        x = load_vector(os.path.join(tmp, "x.mtx"))
        ones = np.ones(fd_cli.shape[0])
        rel = true_rel_residual(fd_cli, fd_cli.spmv(ones), x)
        check(hist[-1] <= 1e-8 and x.size == fd_cli.shape[0] and rel <= 2e-8,
              f"amg_main files: history {hist[-1]}, {x.size} values, true "
              f"rel. residual {rel}")
        said = [ln for ln in out.splitlines() if "iterations" in ln]
        print(f"[cli] amg_main -matrix fd{cli_n}.mtx -precision ff32 -tol "
              f"1e-8: {said[0] if said else '?'}; wrote amg_history.txt "
              f"({len(hist)} entries, last {hist[-1]:.3e}) and x.mtx "
              f"({x.size} values, true f64 rel. residual {rel:.3e})")
    return dict(amg=amg, pair=pair, b_dev=b_dev, results=results, A=A)


def time_amg(torch, ctx, card, times):
    """The ELL kernels vs their twins (CUDA events, median of 10) on the
    main AMG path's fine level (1024^2, RCM'd) and on FD 4096^2 (natural
    order, the HBM-sized case), with the bytes each call must move; the
    warm walls of the 1024^2 solves; one profiled run of each solve."""
    from multigrid_prj_tpu_torch.models.poisson import poisson_fd_csr
    from multigrid_prj_tpu_torch.ops import cuda_spmv as cv

    for n in AMG_TIME_NS:
        M = ctx["amg"].host_matrices[0] if n == AMG_N else poisson_fd_csr(n)
        E = (ctx["pair"] if n == AMG_N else
             cv.CudaELL.build(M, pair=True, device="cuda"))
        lib = csr_library(torch, M)
        rows, m, K = E.shape[0], E.shape[1], E.k
        gen = torch.Generator(device="cuda").manual_seed(n)
        x = torch.randn(m, generator=gen, device="cuda")
        bh = torch.randn(rows, generator=gen, device="cuda")
        xl, bl = x * 1e-8, bh * 1e-8
        xcol = x[:, None].contiguous()
        d = bh.abs() + 0.5  # a diagonal and a direction for Chebyshev
        p = torch.randn(rows, generator=gen, device="cuda")
        calls = {  # name -> (kernel, twin, library call or None)
            "spmv": (lambda: E.spmv(x),
                     lambda: cv.ell_spmv_plain(E.colsT, E.valsT, x),
                     lambda: lib @ xcol),
            "ff_residual_ell": (
                lambda: E.residual_ff(bh, bl, x, xl),
                lambda: cv.ell_ff_residual_plain(E.colsT, E.valsT, E.valsT_lo,
                                                 bh, bl, x, xl),
                None),  # no library call carries the float-float pair
            # the cycle's fused forms: the residual b - A x and a later
            # Chebyshev step (p updated in place); no library call fuses
            "spmv_axpy": (
                lambda: E.residual(x, bh),
                lambda: cv.ell_spmv_axpy_plain(E.colsT, E.valsT, x, bh, True),
                None),
            "cheb_step": (
                lambda: E.cheb_step(x, bh, d, p, 0.61, 0.37, False),
                lambda: cv.ell_cheb_step_plain(E.colsT, E.valsT, x, bh, d, p,
                                               0.61, 0.37, False),
                None)}
        at = (f"{rows} rows (FD {n}^2, RCM)" if n == AMG_N
              else f"{rows} rows (FD {n}^2)")
        for k, (kern, twin, libcall) in calls.items():
            t = (median_ms(torch, kern, runs=10),
                 median_ms(torch, twin, runs=10))
            t_lib = median_ms(torch, libcall, runs=10) if libcall else None
            nbytes, flops = ell_cost(k, E)
            rec = record(at, t[0], t[1], nbytes, flops, t_lib,
                         device_ms=device_ms(torch, kern, rows))
            times.setdefault(k, []).append(rec)
            print(f"[time] {k} at FD {n}^2 ({rows} rows, K {K}, {E.nnz} nnz):"
                  f" kernel {t[0] * 1e3:.1f} us (device "
                  f"{rec['device_ms'] * 1e3:.1f} us), twin {t[1] * 1e3:.1f} us, "
                  f"library (cuSPARSE CSR) "
                  f"{'none' if t_lib is None else f'{t_lib * 1e3:.1f} us'}; "
                  f"bound {rec['bound_ms'] * 1e3:.1f} us ({rec['bound_by']});"
                  f" kernel {nbytes / t[0] / 1e6:.0f} GB/s, "
                  f"{E.nnz / t[0] / 1e6:.2f} Gnnz/s  ({card})")
        del E, x, bh, xl, bl, lib, xcol, d, p
        torch.cuda.empty_cache()
    amg, b_dev = ctx["amg"], ctx["b_dev"]
    for method, (tol, res) in ctx["results"].items():
        med, walls, out = median_wall(
            torch, lambda: getattr(amg, method)(b_dev, tol=tol))
        check(out.iterations == res.iterations, f"timed AMG {method} differs")
        print(f"[time] amg {AMG_N}^2 {method}: median wall {med * 1e3:.2f} ms "
              f"over 3 ({[round(w * 1e3, 2) for w in walls]} ms), "
              f"{res.iterations} iterations  ({card})")
        try:
            wall, busy, nev, top = profile_run(
                torch, lambda: getattr(amg, method)(b_dev, tol=tol))
        except Exception as exc:  # the trace is a measurement aid only
            print(f"[profile] amg {method}: not measured ({exc!r})")
            continue
        if not nev:
            print(f"[profile] amg {method}: the trace shows no device time "
                  "(not measured)")
            continue
        print(f"[profile] amg {AMG_N}^2 {method}: {nev} device ops "
              f"({nev / res.iterations:.0f} per iteration), device busy "
              f"{busy * 1e3:.2f} ms = {busy / wall:.1%} of the profiled wall "
              f"{wall * 1e3:.2f} ms, {busy / med:.1%} of the unprofiled "
              f"median  ({card})")
        for name, (us, cnt) in top[:6]:
            print(f"[profile]   {us / 1e3:8.3f} ms  {cnt:5d}x  {name[:90]}")


def compare_twin_solves(torch, tag, solver, twin, b, solves):
    """Each ``(method, tol)`` on ``solver`` (CUDA) and on ``twin`` (the same
    hierarchy through the twins on the CPU): equal iterations, histories
    within ``AMG_HISTORY_RTOL`` (+1e-12)."""
    from multigrid_prj_tpu_torch.ops import cuda_stencil as cs

    for method, tol in solves:
        cs.reset_launch_counts()
        got = getattr(solver, method)(b, tol=tol)
        sync(torch, solver.device)
        counts = {k: cs.LAUNCHES[k] for k in KERNELS_AMG}
        t0 = time.perf_counter()
        want = getattr(twin, method)(b, tol=tol)
        diff = abs(got.history - want.history)
        rel = float((diff / want.history).max())
        print(f"[{tag}] {method}(tol={tol}): {got.iterations} iterations to "
              f"{got.rel_residual:.3e}, CPU twins {want.iterations} to "
              f"{want.rel_residual:.3e} in {time.perf_counter() - t0:.1f} s; "
              f"launches {counts}; max rel. history diff {rel:.3e} (bound "
              f"{AMG_HISTORY_RTOL} + 1e-12)")
        check(got.iterations == want.iterations and got.rel_residual <= tol,
              f"{tag} {method}: {got.iterations} iterations vs CPU twins "
              f"{want.iterations}")
        check(bool((diff <= 1e-12 + AMG_HISTORY_RTOL * want.history).all()),
              f"{tag} {method}: histories differ beyond the bound")
        if torch.device(solver.device).type == "cuda":
            want = amg_launches(solver, method, got.iterations)
            check(counts == want, f"{tag} {method}: kernel launches "
                  f"{counts}, the path's {want}")


# -- the sharded GMG path (device-generic where it can be, so the phases can
# be rehearsed on the CPU at small sizes) ------------------------------------


def ext_slab(torch, g, row0, rows):
    """Rows ``row0 .. row0 + rows + 15`` of the global array ``g``, zeros
    where they fall outside it: an extended slab with the edge exchange's
    zero halos."""
    ne = rows + 16
    out = torch.zeros((ne, g.shape[1]), dtype=g.dtype, device=g.device)
    lo, hi = max(row0, 0), min(row0 + ne, g.shape[0])
    if hi > lo:
        out[lo - row0:hi - row0] = g[lo:hi]
    return out


def check_fused_ext(torch, cs, max_err, n=8192, rows=EXT_ROWS,
                    row0s=EXT_ROW0, grids=EXT_GRIDS, dev="cuda"):
    """rbgs_fused_extended against its twin (torch.equal) at sweeps 1-4 for
    every slab, and its core against 2 * sweeps colour sweeps of the global
    grid, cropped (rows past the global buffer must be 0: pinned)."""
    alpha, h = 1.0, 0.5
    done = 0
    for m, logical in grids:
        gen = torch.Generator(device=dev).manual_seed(m + logical[0])
        gu, gb = (torch.randn((n, m), generator=gen, device=dev)
                  for _ in range(2))
        for sweeps in (1, 2, 3, 4):
            ref = gu
            for _ in range(sweeps):
                for col in (0, 1):
                    ref = cs.rbgs_color_sweep(ref, gb, alpha, h, col, logical)
            for r in rows:
                for row0 in row0s:
                    ue, be = ext_slab(torch, gu, row0, r), ext_slab(
                        torch, gb, row0, r)
                    got = cs.rbgs_fused_extended(ue, be, row0, logical,
                                                 alpha, h, sweeps)
                    want = cs.rbgs_fused_extended_plain(ue, be, row0,
                                                        logical, alpha, h,
                                                        sweeps)
                    err = float((got - want).abs().max())
                    max_err["rbgs_fused_ext"] = max(
                        max_err["rbgs_fused_ext"], err)
                    k = max(0, min(r, n - (row0 + 8)))
                    tag = (f"rbgs_fused_ext sweeps {sweeps}, R {r}, m {m}, "
                           f"row0 {row0}, logical {logical}")
                    check(torch.equal(got, want),
                          f"{tag} != twin (max abs diff {err})")
                    check(torch.equal(got[:k], ref[row0 + 8:row0 + 8 + k])
                          and not bool(got[k:].any()),
                          f"{tag} != {2 * sweeps} colour sweeps, cropped")
                    done += 1
        del gu, gb, ref
    return done


def free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def init_one_rank_nccl():
    """maybe_initialize_distributed with a world of one rank in the
    environment, as torchrun would set it: the NCCL process group."""
    import torch.distributed as dist

    from multigrid_prj_tpu_torch.parallel import maybe_initialize_distributed

    env = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port()),
           "WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0"}
    os.environ.update(env)
    try:
        multi = maybe_initialize_distributed()
    finally:
        for k in env:
            os.environ.pop(k)
    check(not multi and dist.is_initialized()
          and str(dist.get_backend()) == "nccl",
          f"one-rank NCCL group: multi {multi}, backend "
          f"{dist.get_backend() if dist.is_initialized() else None}")
    return str(dist.get_backend())


def gloo_steps(torch, mesh, dev, n=GLOO_N, levels=GLOO_LEVELS,
               steps=GLOO_STEPS):
    """``steps`` sharded V-cycles at ``n``^2 from zero on ``mesh``: the
    gathered u, the launches and the collective counts."""
    from multigrid_prj_tpu_torch.models.poisson import assemble_rhs
    from multigrid_prj_tpu_torch.ops import cuda_stencil as cs
    from multigrid_prj_tpu_torch.parallel import ShardedGMGSolver
    from multigrid_prj_tpu_torch.parallel.sharded_gmg import (
        gather_slabs,
        scatter_slabs,
    )

    s = ShardedGMGSolver(shape=(n, n), mesh=mesh, num_levels=levels,
                         device=dev, use_pallas=True)
    b = scatter_slabs(assemble_rhs(s.levels[0], 10.0, test=1,
                                   dtype=torch.float32, device=dev), mesh)
    cs.reset_launch_counts()
    mesh.reset_counts()
    u = torch.zeros_like(b)
    for _ in range(steps):
        u = s.step(u, b)
    sync(torch, dev)
    return dict(u=gather_slabs(u, mesh).cpu().numpy(),
                launches=cs.LAUNCHES["rbgs_fused_ext"],
                counts=dict(mesh.counts), num_sharded=s.num_sharded,
                backend=mesh.backend)


def gloo_solves(torch, mesh, devs, kw=GLOO_SOLVE):
    """The 256^2 solve on ``mesh`` on each device of ``devs`` from one
    right-hand side (the kernel route; its twin on the CPU)."""
    from multigrid_prj_tpu_torch.models.poisson import assemble_rhs
    from multigrid_prj_tpu_torch.ops import cuda_stencil as cs
    from multigrid_prj_tpu_torch.parallel import ShardedGMGSolver
    from multigrid_prj_tpu_torch.parallel.sharded_gmg import (
        gather_slabs,
        scatter_slabs,
    )

    out = {}
    for dev in devs:
        s = ShardedGMGSolver(mesh=mesh, device=dev, use_pallas=True, **kw)
        b = scatter_slabs(assemble_rhs(s.levels[0], 10.0, test=1,
                                       dtype=torch.float32, device="cpu"),
                          mesh, device=dev)
        cs.reset_launch_counts()
        r = s.solve(b)
        out[dev] = dict(history=r.history, iterations=r.iterations,
                        converged=r.converged,
                        u=gather_slabs(r.u, mesh).cpu().numpy(),
                        launches=cs.LAUNCHES["rbgs_fused_ext"])
    return out


def gloo_rank(rank, world, init_file, out_path, dev="cuda",
              solve_devs=("cuda", "cpu"), n=GLOO_N):
    """One rank of the several-ranks-on-one-card phase (spawned; gloo over
    a file in a temporary directory): 4 ranks run ``gloo_steps`` on the
    ("x",) and ("dcn", "x") layouts, 2 ranks ``gloo_solves``; rank 0
    pickles the results to ``out_path``."""
    import pickle

    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist

    from multigrid_prj_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    if dev == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        if world == 4:
            out = {layout: gloo_steps(torch, make_mesh(*layout), dev, n=n)
                   for layout in ((4,), (2, 2))}
        else:
            out = gloo_solves(torch, make_mesh(world), solve_devs)
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn_ranks(world, tmp, dev="cuda", solve_devs=("cuda", "cpu"),
                n=GLOO_N, deadline_s=GLOO_DEADLINE_S, target=None,
                args=None):
    """Run ``target`` (default ``gloo_rank`` with ``dev``, ``solve_devs``,
    ``n``) in ``world`` spawned processes as ``target(rank, world,
    init_file, out_path, *args)`` and return rank 0's results; a rank's
    exception fails the phase, and ranks still running at the deadline are
    stopped and fail it."""
    import pickle

    import torch.multiprocessing as mp

    if target is None:
        target, args = gloo_rank, (dev, solve_devs, n)
    tag = f"{target.__name__}{world}"
    out_path = os.path.join(tmp, f"{tag}.pkl")
    ctx = mp.spawn(target, args=(world, os.path.join(tmp, f"init_{tag}"),
                                 out_path, *args),
                   nprocs=world, join=False)
    t_end = time.perf_counter() + deadline_s
    try:
        while not ctx.join(timeout=5):
            check(time.perf_counter() < t_end,
                  f"{world} gloo ranks still running after {deadline_s} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
                proc.join(10)
    with open(out_path, "rb") as f:
        return pickle.load(f)


# -- the sharded AMG path (device-generic, so the phase can be rehearsed on
# the CPU at small sizes; the script runs it on CUDA only) --------------------


def samg_applies_per_cycle(solver):
    """SpMV applies per cycle of a sharded AMG solve: per sharded level the
    smoother's applies of A ((nu1 + nu2) x degree with Chebyshev), the
    residual's, P^T's and P's; one more of A for the residual norm.  Each is
    one kernel launch on the kernel route and one halo exchange where the
    operator's halo is not 0."""
    smooth = (solver.nu1 + solver.nu2) * (
        solver.cheb_degree if solver.smoother_name == "chebyshev" else 1)
    return solver.num_sharded * (smooth + 3) + 1


def samg_state(solver):
    """The host hierarchy of a sharded AMG solver as numpy, for
    ``convert.sharded_amg_solver_from_numpy`` in the ranks."""
    def csr(M):
        return (M.indptr, M.indices, M.data, M.shape)

    return dict(host_matrices=[csr(M) for M in solver.host_matrices],
                host_P=[csr(P) for P in solver.host_P], perm=solver._perm,
                lmax=solver.lmax, smoother=solver.smoother_name,
                cheb_degree=solver.cheb_degree, nu1=solver.nu1,
                nu2=solver.nu2, tol=solver.tol, maxit=solver.maxit,
                num_sharded=solver.num_sharded)


def samg_rank(rank, world, init_file, out_path, state_path, dev="cuda"):
    """One of the gloo ranks sharing the card: the sharded AMG solver on the
    parent's hierarchy (``state_path``, from ``samg_state``), one solve of
    the default_rng(0) right-hand side counted; rank 0 pickles x and every
    rank's counts to ``out_path``."""
    import pickle

    sys.path.insert(0, REPO)
    import numpy as np
    import torch
    import torch.distributed as dist

    from multigrid_prj_tpu_torch.convert import sharded_amg_solver_from_numpy
    from multigrid_prj_tpu_torch.ops import cuda_stencil as cs
    from multigrid_prj_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    if dev == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh(world)
        with open(state_path, "rb") as f:
            state = pickle.load(f)
        t0 = time.perf_counter()
        s = sharded_amg_solver_from_numpy(state, mesh, device=dev,
                                          dtype=torch.float32,
                                          use_pallas=True)
        setup_s = time.perf_counter() - t0
        n = s.level_sizes[0]
        b = torch.from_numpy(np.random.default_rng(0).standard_normal(
            n).astype(np.float32)).to(dev)
        cs.reset_launch_counts()
        mesh.reset_counts()
        res = s.solve(b)
        sync(torch, dev)
        mine = dict(counts=dict(mesh.counts), spmv=cs.LAUNCHES["spmv"],
                    launches=sum(cs.LAUNCHES.values()), setup_s=setup_s,
                    halos=[(lv.A.halo, lv.P.halo, lv.Pt.halo)
                           for lv in s.sharded_levels])
        ranks = [None] * world
        dist.all_gather_object(ranks, mine)
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(dict(x=res.x.cpu().numpy(),
                                 iterations=res.iterations,
                                 rel=res.rel_residual,
                                 num_sharded=s.num_sharded, ranks=ranks), f)
    finally:
        dist.destroy_process_group()


def check_samg_blocks(torch, cv, tsa, solver, A0, ranks, dev, seed):
    """Row 19 at the sharded path's shapes: the SpMV kernel on every
    sharded block of ``solver`` (A, P, P^T of each level against its
    extended input) and on each of the ``ranks``-rank blocks of level 0,
    against its twin (``torch.equal``) on random inputs; returns the largest
    |difference| and the level-0 blocks (one rank's, and the first interior
    one of ``ranks``) as (label, ShardedELL, CudaShardedELL)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    worst, cases = 0.0, []
    for l, lv in enumerate(solver.sharded_levels):
        for name in ("A", "P", "Pt"):
            cases.append((f"level {l} {name}", getattr(lv, name),
                          getattr(lv, f"{name}_fast")))
    n_pad = -(-A0.shape[0] // ranks) * ranks
    full = tsa.build_sharded_ell(A0, n_pad, n_pad, ranks, torch.float32)
    for i in range(ranks):
        m = full.block(i, dev)
        cases.append((f"level 0 A, block {i} of {ranks}", m,
                      tsa.build_cuda_sharded(m)))
    del full
    for label, m, f in cases:
        x_ext = torch.randn(m.in_rows + 2 * m.halo, generator=gen,
                            device=dev)
        got = cv.ell_local_spmv(f.colsT, f.valsT, x_ext)
        want = cv.ell_spmv_plain(f.colsT, f.valsT, x_ext)
        sync(torch, dev)
        err = float((got - want).abs().max())
        worst = max(worst, err)
        check(torch.equal(got, want), f"ell_spmv != twin on the sharded "
              f"{label} (max abs diff {err})")
        print(f"[samg kernels] ell_spmv on the sharded {label}: "
              f"({f.colsT.shape[0]}, {f.colsT.shape[1]}) against "
              f"{x_ext.shape[0]} inputs (halo {m.halo}): equal to its twin "
              "(torch.equal)")
    lv0 = solver.sharded_levels[0]
    return worst, [(f"level 0 A, {solver.p} rank", lv0.A, lv0.A_fast),
                   cases[1 - ranks]]


def samg_block_time(torch, cv, label, m, f, per_solve, seed):
    """Row 19 at a sharded block: kernel and twin (CUDA events), the
    kernel's device time from graph replays (warm L2: the 4-rank block's
    12.6 MB stay resident) and one call with L2 flushed, one cuSPARSE CSR
    product of the same block against the same x_ext, and the bound of the
    bytes the call must move (the slots as stored, x_ext read once, y
    written once) and of its operations (two per stored nonzero)."""
    import numpy as np

    from multigrid_prj_tpu_torch.ops.sparse import HostCSR

    gen = torch.Generator(device="cuda").manual_seed(seed)
    m_ext = m.in_rows + 2 * m.halo
    x_ext = torch.randn(m_ext, generator=gen, device="cuda")
    K, R = f.colsT.shape
    vals = m.vals.cpu().numpy().astype(np.float64)
    rows, slots = np.nonzero(vals)
    lib = csr_library(torch, HostCSR.from_coo(
        rows, m.cols_rel.cpu().numpy()[rows, slots], vals[rows, slots],
        (R, m_ext)))
    xcol = x_ext[:, None].contiguous()

    def kern():
        return cv.ell_local_spmv(f.colsT, f.valsT, x_ext)

    t = (median_ms(torch, kern, runs=10),
         median_ms(torch, lambda: cv.ell_spmv_plain(f.colsT, f.valsT, x_ext),
                   runs=10))
    return record(f"sharded {label}: ({K}, {R}) against {m_ext} inputs",
                  t[0], t[1], 8 * K * R + 4 * (m_ext + R), 2 * rows.size,
                  median_ms(torch, lambda: lib @ xcol, runs=10),
                  device_ms=device_ms(torch, kern, R),
                  flushed_ms=flushed_ms(torch, kern),
                  launches_per_solve=per_solve)


def run_sharded_amg(torch, phases, launches, max_err, amg_ref, card,
                    dev="cuda", n=AMG_N, twin_n=SAMG_TWIN_N,
                    ranks=SAMG_RANKS, expected=True):
    """Phase 16g: the sharded AMG solver at n^2 FD on the one-rank mesh of
    the current process group (kernel route; the main path, counted into
    ``launches``), its kernel at the path's block shapes against the twin,
    twin_n^2 on the card against the CPU twin, and ``ranks`` gloo ranks on
    the same device against the one rank.  ``amg_ref`` is the unsharded
    AMG context of ``run_amg`` (its solver, A, b and solve result).
    ``expected`` holds the n = 1024 counts.  Returns the row-19 timing
    records (CUDA only)."""
    import pickle

    import numpy as np

    from multigrid_prj_tpu_torch.models.poisson import poisson_fd_csr
    from multigrid_prj_tpu_torch.ops import cuda_spmv as cv
    from multigrid_prj_tpu_torch.ops import cuda_stencil as cs
    from multigrid_prj_tpu_torch.parallel import ShardedAMGSolver, make_mesh
    from multigrid_prj_tpu_torch.parallel import sharded_amg as tsa
    from multigrid_prj_tpu_torch.parallel.distributed import Mesh

    on_cuda = torch.device(dev).type == "cuda"
    mesh = make_mesh()
    phases.next(f"sharded AMG {n}^2 FD, one rank ({mesh.backend})")
    A = amg_ref["A"]
    t0 = time.perf_counter()
    s = ShardedAMGSolver(A, mesh, dtype=torch.float32, use_pallas=True,
                         device=dev, **SAMG_KW)
    sync(torch, dev)
    setup_s = time.perf_counter() - t0
    print(f"[samg] poisson_fd_csr({n}) on a mesh of {mesh.size} "
          f"({mesh.backend}): set-up {setup_s:.2f} s; levels "
          f"{s.level_sizes}; {s.num_sharded} sharded, kernel route "
          f"{s._use_pallas}; the {s.level_sizes[-1]}-row bottom replicated "
          "(LU)")
    for l, lv in enumerate(s.sharded_levels):
        print(f"[samg] level {l}: A ({lv.A_fast.colsT.shape[0]}, "
              f"{lv.A.out_rows}) halo {lv.A.halo}, P K "
              f"{lv.P_fast.colsT.shape[0]} halo {lv.P.halo}, Pt K "
              f"{lv.Pt_fast.colsT.shape[0]} halo {lv.Pt.halo}")
    check(s._use_pallas and all(
        f is not None for lv in s.sharded_levels
        for f in (lv.A_fast, lv.P_fast, lv.Pt_fast)),
        "sharded AMG: a sharded level without the kernel route")
    if expected:
        check(s.level_sizes == AMG_LEVELS
              and s.num_sharded == SAMG_SHARDED,
              f"sharded AMG: levels {s.level_sizes}, {s.num_sharded} sharded")
    err, blocks = check_samg_blocks(torch, cv, tsa, s, s.host_matrices[0],
                                    ranks, dev, seed=19)
    max_err["spmv"] = max(max_err["spmv"], err)

    b = np.random.default_rng(0).standard_normal(A.shape[0]).astype(
        np.float32)
    b64 = b.astype(np.float64)
    b_dev = torch.from_numpy(b).to(dev)
    per = samg_applies_per_cycle(s)
    cs.reset_launch_counts()
    mesh.reset_counts()
    res = s.solve(b_dev)
    sync(torch, dev)
    counts, coll = dict(cs.LAUNCHES), dict(mesh.counts)
    for k, v in counts.items():
        launches[k] += v
    k = res.iterations
    true_rel = true_rel_residual(A, b64, res.x)
    ref_k = amg_ref["results"]["solve"][1].iterations
    print(f"[samg {n}] solve(tol={s.tol}): {k} iterations (expected "
          f"{SAMG_ITERATIONS}; AMGSolver.solve {ref_k}), rel. residual "
          f"{res.rel_residual:.3e}, true f64 rel. residual of x "
          f"{true_rel:.3e}; history {[float(h) for h in res.history]}")
    print(f"[samg {n}] launches {({q: v for q, v in counts.items() if v})} "
          f"({per} spmv per cycle); collectives {coll}")
    want = dict(halo=0, all_reduce=k + 1, all_gather=k + 1)
    check(tuple(res.x.shape) == (A.shape[0],)
          and bool(torch.isfinite(res.x).all())
          and true_rel <= 1.01 * s.tol and abs(k - ref_k) <= 1,
          f"sharded AMG {n}^2: x, or {true_rel} > 1.01 tol, or {k} vs {ref_k}")
    n_spmv = per * k if on_cuda else 0  # the CPU runs the twin
    check(counts["spmv"] == n_spmv == sum(counts.values()) and coll == want,
          f"sharded AMG {n}^2: launches {counts}, collectives {coll} (want "
          f"{n_spmv} spmv, {want})")
    if expected:
        check(k == SAMG_ITERATIONS, f"sharded AMG: {k} iterations")
    recs = []
    if on_cuda:
        recs = [samg_block_time(torch, cv, label, m, f, per * k, seed=23)
                for label, m, f in blocks]
        for rec in recs:
            print(f"[time] spmv at the {rec['at']}: kernel "
                  f"{rec['ms'] * 1e3:.1f} us (device "
                  f"{rec['device_ms'] * 1e3:.1f} us; L2 flushed "
                  f"{rec['flushed_ms'] * 1e3:.1f} us), twin "
                  f"{rec['plain_ms'] * 1e3:.1f} us, library (cuSPARSE CSR) "
                  f"{rec['library_ms'] * 1e3:.1f} us; bound "
                  f"{rec['bound_ms'] * 1e3:.1f} us ({rec['bound_by']}); "
                  f"{rec['launches_per_solve']} spmv launches per solve  "
                  f"({card})")
        amg, amg_b = amg_ref["amg"], amg_ref["b_dev"]
        fns = {"sharded": lambda: s.solve(b_dev),
               "unsharded": lambda: amg.solve(amg_b, tol=s.tol)}
        walls = {q: [] for q in fns}
        for q in fns:
            fns[q]()
        for q in ("sharded", "unsharded", "unsharded", "sharded", "sharded",
                  "unsharded"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fns[q]()
            torch.cuda.synchronize()
            walls[q].append(time.perf_counter() - t0)
            check(out.iterations == (k if q == "sharded" else ref_k),
                  f"timed {q} solve differs")
        for q, w in walls.items():
            print(f"[time] {n}^2 FD solve(tol={s.tol}), {q}: median wall "
                  f"{statistics.median(w) * 1e3:.2f} ms over 3 "
                  f"({[round(x * 1e3, 2) for x in w]} ms, alternating)  "
                  f"({card})")
        try:
            wall, busy, nev, top = profile_run(torch, fns["sharded"])
            print(f"[profile] sharded AMG {n}^2 solve: {nev} device ops "
                  f"({nev / k:.0f} per iteration), device busy "
                  f"{busy * 1e3:.2f} ms = {busy / max(wall, 1e-12):.1%} of "
                  f"the profiled wall {wall * 1e3:.2f} ms  ({card})")
            for kname, (us, cnt) in top[:6]:
                print(f"[profile]   {us / 1e3:8.3f} ms  {cnt:5d}x  "
                      f"{kname[:90]}")
        except Exception as exc:  # the trace is a measurement aid only
            print(f"[profile] sharded AMG solve: not measured ({exc!r})")

    phases.next(f"sharded AMG {twin_n}^2, card vs CPU twin")
    small = ShardedAMGSolver(poisson_fd_csr(twin_n), mesh,
                             dtype=torch.float32, use_pallas=True,
                             device=dev, **SAMG_KW)
    twin = ShardedAMGSolver.from_hierarchy(
        small.host_matrices, small.host_P, Mesh(("x",), (1,), (0,), 0),
        perm=small._perm, lmax=small.lmax, dtype=torch.float32,
        use_pallas=True, device="cpu", **SAMG_KW_SOLVE)
    bs = np.random.default_rng(0).standard_normal(twin_n ** 2).astype(
        np.float32)
    cs.reset_launch_counts()
    got = small.solve(torch.from_numpy(bs).to(dev))
    sync(torch, dev)
    n_spmv = cs.LAUNCHES["spmv"]
    want = twin.solve(bs)
    hd = abs(got.history - want.history)
    xw = want.x.numpy()
    xd = float(abs(got.x.cpu().numpy() - xw).max() / abs(xw).max())
    print(f"[samg {twin_n}] card {got.iterations} iterations to "
          f"{got.rel_residual:.3e} ({n_spmv} spmv launches), CPU twin "
          f"{want.iterations} to {want.rel_residual:.3e}; max rel. history "
          f"diff {float((hd / want.history).max()):.3e}, max |dx| / max |x| "
          f"{xd:.3e} (bound {AMG_HISTORY_RTOL})")
    check(got.iterations == want.iterations
          and bool((hd <= 1e-12 + AMG_HISTORY_RTOL * want.history).all())
          and xd <= AMG_HISTORY_RTOL
          and n_spmv == (samg_applies_per_cycle(small) * got.iterations
                         if on_cuda else 0),
          f"sharded AMG {twin_n}^2: card vs CPU twin")
    del small, twin

    phases.next(f"sharded AMG {n}^2 FD, {ranks} gloo ranks on one device")
    with tempfile.TemporaryDirectory() as tmp:
        state_path = os.path.join(tmp, "samg_state.pkl")
        with open(state_path, "wb") as f:
            pickle.dump(samg_state(s), f, protocol=pickle.HIGHEST_PROTOCOL)
        t0 = time.perf_counter()
        four = spawn_ranks(ranks, tmp, target=samg_rank,
                           args=(state_path, dev))
        t_spawn = time.perf_counter() - t0
    x1 = res.x.cpu().numpy()
    want_r = dict(halo=2 * per * k if ranks > 1 else 0, all_reduce=k + 1,
                  all_gather=k + 1)
    for i, r in enumerate(four["ranks"]):
        print(f"[samg gloo] rank {i}: set-up from the parent's hierarchy "
              f"{r['setup_s']:.2f} s; halos (A, P, Pt) {r['halos']}; "
              f"spmv launches {r['spmv']}; collectives {r['counts']}")
    same = np.array_equal(four["x"], x1)
    print(f"[samg gloo] {ranks} ranks: {four['iterations']} iterations, rel. "
          f"residual {four['rel']:.3e}; x equal to one rank's bit for bit: "
          f"{same}; spawn {t_spawn:.1f} s")
    check(four["num_sharded"] == s.num_sharded
          and four["iterations"] == k and same,
          f"{ranks} gloo ranks: x or iterations differ from one rank")
    check(all(r["counts"] == want_r and r["spmv"] == counts["spmv"]
              == r["launches"] for r in four["ranks"]),
          f"{ranks} gloo ranks: counts (want {want_r} and "
          f"{counts['spmv']} spmv)")
    del s
    return recs


# -- phase 16h: the amg_debug harness, the utilities and the front-ends ----
# (device-generic, so the phase can be rehearsed on the CPU at small sizes;
# the script runs it on CUDA at the sizes below)

# the web server's requests (the form's coarsest N, levels, test, smoother,
# cycle) and the kernels each must launch on the card: (a) 4097^2, the
# largest grid the form accepts; (b)-(d) 1025^2.  In f32 the server solves
# to 1e-6, below the f32 floor at these sizes, so (a)-(c) run their 1000
# iterations and answer converged: false, as the JAX server on a TPU
WEB_REQUESTS = (
    ("a", dict(n=9, ml=10, test=1, smt=0, cycle="sawtooth"), ("rbgs_fused",)),
    ("b", dict(n=33, ml=6, test=1, smt=0, cycle="v"),
     ("rbgs_fused", "residual")),
    ("c", dict(n=33, ml=6, test=1, smt=1, cycle="sawtooth"), ("jacobi",)),
    ("d", dict(n=33, ml=6, test=1, smt=2, cycle="sawtooth"),
     ("rbgs_fused",)),
)
FRONT_KW = dict(
    stages=dict(shape=(1025, 1025), length=10.0, num_levels=6),
    gif=dict(shape=(65, 65), length=10.0, num_levels=4),  # viz_main's
    # the main path's configuration, maxit setting the count (tol 1e-11 is
    # beyond f32): 3 iterations, then resumed for 5, against 8
    ckpt=dict(shape=(1025, 1025), num_levels=6, cycle="v", smoother="gs",
              pad_align=256),
    mesh=257, mesh_small=33, sweeps=5000, timed_sweeps=500)
CKPT_SPLIT = (3, 5)
CKPT_KERNELS = ("rbgs_fused", "residual", "restrict_fw", "prolong_add")


def write_msh(path, mesh):
    """``mesh`` as a gmsh 4.1 ASCII file: one node block (tags from 1), one
    block of boundary lines (type 1) and one of triangles (type 2).  The
    writer of the port's tests (``tests/torch_msh.py``), copied: this
    script imports no test."""
    import numpy as np

    n = mesh.n_nodes
    tris = mesh.triangles + 1
    edges = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [0, 2]]])
    bnd = mesh.on_boundary
    # an edge with both ends on the boundary and used by one triangle only
    key, count = np.unique(np.sort(edges, axis=1), axis=0, return_counts=True)
    lines = key[(count == 1) & bnd[key[:, 0] - 1] & bnd[key[:, 1] - 1]]
    with open(path, "w") as fh:
        fh.write("$MeshFormat\n4.1 0 8\n$EndMeshFormat\n")
        fh.write(f"$Nodes\n1 {n} 1 {n}\n2 1 0 {n}\n")
        fh.write("".join(f"{t}\n" for t in range(1, n + 1)))
        fh.write("".join(f"{float(x)!r} {float(y)!r} 0\n"
                         for x, y in mesh.nodes))
        fh.write("$EndNodes\n")
        m, nl = len(tris), len(lines)
        fh.write(f"$Elements\n2 {nl + m} 1 {nl + m}\n1 1 1 {nl}\n")
        fh.write("".join(f"{k + 1} {a} {b}\n" for k, (a, b) in enumerate(lines)))
        fh.write(f"2 1 2 {m}\n")
        # node order within a triangle as gmsh may give it (unsorted)
        fh.write("".join(f"{nl + k + 1} {c} {a} {b}\n"
                         for k, (a, b, c) in enumerate(tris)))
        fh.write("$EndElements\n")


def counts_of(torch, cs, fn):
    """``fn()`` with the launch counters set to 0 just before and read just
    after, NOT added to the path's counts (a rebuilt run compared with a
    path's own run)."""
    cs.reset_launch_counts()
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, {k: v for k, v in cs.LAUNCHES.items() if v}


def direct_web_solve(torch, form, device):
    """The server's solve of ``form`` rebuilt without the server: the same
    solver, RHS, tolerance and loop as ``web/server.run_solver``, nothing
    written."""
    from multigrid_prj_tpu_torch.gmg import GMGSolver
    from multigrid_prj_tpu_torch.models.poisson import assemble_rhs
    from multigrid_prj_tpu_torch.ops.krylov import bicgstab
    from multigrid_prj_tpu_torch.ops.stencil import poisson_apply

    n, ml, a, w = form["n"], form["ml"], 10.0, 10.0
    for _ in range(ml - 1):
        n = n * 2 - 1
    dtype = torch.float32 if device == "cuda" else torch.float64
    tol = 1e-6 if device == "cuda" else 1e-11
    solver = GMGSolver(shape=(n, n), length=w, alpha=a, num_levels=ml,
                       smoother="jacobi" if form["smt"] == 1 else "gs",
                       cycle=form["cycle"], tol=tol, device=device)
    b = assemble_rhs(solver.levels[0], w, test=form["test"], dtype=dtype,
                     device=device)
    if form["smt"] == 2:
        h0 = solver.levels[0].h
        res = bicgstab(lambda x: poisson_apply(x, a, h0), b, tol=tol,
                       maxit=200, history=True,
                       M=lambda r: solver.step(torch.zeros_like(r), r))
        return res.history.cpu().numpy(), res.iterations
    out = solver.solve(b)
    return out.history, out.iterations


def run_frontends(torch, run_counted, card, dev="cuda", requests=WEB_REQUESTS,
                  kw=FRONT_KW):
    """Phase 16h: every module of the last slice driven on ``dev`` through
    its entry points -- the web server answering requests, the
    cycle-stage recorder of ``viz``, checkpoint and resume, the guards and
    metrics, and the ``amg_debug`` harness."""
    import contextlib
    import glob
    import http.client
    import importlib.util
    import io
    import threading
    import urllib.parse
    from http.server import ThreadingHTTPServer

    import numpy as np

    from multigrid_prj_tpu_torch.amg import (
        AMGSolver,
        build_prolongation,
        coarsen_greedy,
    )
    from multigrid_prj_tpu_torch.cli import amg_debug
    from multigrid_prj_tpu_torch.gmg import GMGSolver
    from multigrid_prj_tpu_torch.models.fem import (
        assemble_p1,
        parse_msh,
        structured_unit_square_mesh,
    )
    from multigrid_prj_tpu_torch.models.poisson import assemble_rhs
    from multigrid_prj_tpu_torch.ops import cuda_stencil as cs
    from multigrid_prj_tpu_torch.ops.sparse import rap, to_device
    from multigrid_prj_tpu_torch.utils.checkpoint import (
        resume_solve,
        save_checkpoint,
    )
    from multigrid_prj_tpu_torch.utils.guards import (
        count_nonfinite,
        guard_solve_io,
    )
    from multigrid_prj_tpu_torch.utils.io import load_vector
    from multigrid_prj_tpu_torch.utils.metrics import PhaseTimer, fence, trace
    from multigrid_prj_tpu_torch.viz.plots import (
        record_cycle_stages,
        write_stage_files,
    )
    from multigrid_prj_tpu_torch.web import server

    on_card = dev == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def nonzero(counts):
        return {k: v for k, v in counts.items() if v}

    tmp = tempfile.mkdtemp(prefix="chip_smoke_16h_")
    # 1. the web server on the card: four requests and a bad one
    server.Handler.workdir = tmp
    server.Handler.device = dev
    srv = ThreadingHTTPServer(("127.0.0.1", 0), server.Handler)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    addr = srv.server_address

    def call(method, path, form=None):
        conn = http.client.HTTPConnection(*addr, timeout=900)
        try:
            body = None if form is None else urllib.parse.urlencode(form)
            conn.request(method, path, body=body, headers={
                "Content-Type": "application/x-www-form-urlencoded"})
            r = conn.getresponse()
            return r.status, r.read()
        finally:
            conn.close()

    try:
        status, page = call("GET", "/")
        check(status == 200 and b'name="smt"' in page
              and b'<option value="2">test 2' in page, "web form page")
        print(f"[web] GET / on 127.0.0.1:{addr[1]}: the form "
              f"({len(page)} bytes)")
        for label, form, kernels in requests:
            t0 = time.perf_counter()
            (status, body), counts = run_counted(
                lambda form=form: call("POST", "/run", form))
            wall = time.perf_counter() - t0
            ans = json.loads(body)
            check(status == 200 and "error" not in ans,
                  f"web request {label}: {ans.get('error')}")
            hist = ans["history"]
            n = form["n"]
            for _ in range(form["ml"] - 1):
                n = n * 2 - 1
            check(len(hist) == ans["iterations"] + 1,
                  f"web request {label}: {len(hist)} history entries for "
                  f"{ans['iterations']} iterations")
            status, text = call("GET", "/MGGS4.txt")
            filed = np.fromstring(text.decode(), sep=" ")
            check(status == 200 and filed[0] == len(hist)
                  and filed[1:].tolist() == hist,
                  f"web request {label}: MGGS4.txt is not the history")
            status, text = call("GET", "/x.mtx")
            x = np.fromstring(text.decode(), sep=" ")
            check(status == 200 and x[0] == n * n and x.size == n * n + 1
                  and bool(np.isfinite(x[1:]).all()),
                  f"web request {label}: x.mtx holds {x.size - 1} values "
                  f"for {n}^2 (finite: {bool(np.isfinite(x[1:]).all())})")
            del x, text
            launched = nonzero(counts)
            if on_card:
                check(all(launched.get(k, 0) > 0 for k in kernels),
                      f"web request {label}: launches {launched}, wanted "
                      f"{kernels}")
            same = ""
            if n == 1025 or not on_card:
                (dh, di), rcounts = counts_of(
                    torch, cs, lambda form=form: direct_web_solve(
                        torch, form, dev))
                check(di == ans["iterations"]
                      and np.array_equal(np.asarray(dh, np.float64),
                                         np.asarray(hist))
                      and rcounts == launched,
                      f"web request {label}: the direct solve differs "
                      f"({di} iterations, launches {rcounts})")
                same = ("; a direct solve in this process: history equal bit "
                        "for bit, the same launches")
            print(f"[web] request ({label}) {n}^2, {form['ml']} levels, smt "
                  f"{form['smt']}, {form['cycle']}: {ans['iterations']} "
                  f"iterations, converged {ans['converged']}, final "
                  f"{ans['final_residual']:.4e}, solve_time "
                  f"{ans['solve_time']:.3f} s, request wall {wall:.3f} s, "
                  f"launches {launched}{same}  ({card})")
        status, body = call("POST", "/run", {"n": 999999, "ml": 3})
        err = json.loads(body).get("error", "")
        check(status == 200 and "range" in err, f"web bad request: {body!r}")
        print(f"[web] bad request n=999999: error {err!r}")
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=60)
    check(not th.is_alive(), "web server thread still running")

    # 2. record_cycle_stages at the main path's width, against step
    solver = GMGSolver(device=dev, **kw["stages"])
    b = assemble_rhs(solver.levels[0], 10.0, test=0, dtype=torch.float32,
                     device=dev)
    t0 = time.perf_counter()
    frames, c_rec = run_counted(
        lambda: record_cycle_stages(solver, b, iterations=2))
    rec_wall = time.perf_counter() - t0

    def two_steps():
        us, u = [], torch.zeros_like(b)
        for _ in range(2):
            u = solver.step(u, b)
            us.append(u.cpu().numpy())
        return us

    steps, c_step = counts_of(torch, cs, two_steps)
    corrected = [f for lab, f in frames if lab.endswith("corrected")]
    check(len(frames) == 1 + 2 * (2 + len(solver.levels))
          and len(corrected) == 2
          and all(np.array_equal(f, s) for f, s in zip(corrected, steps))
          and c_rec.get("rbgs_fused", 0) == c_step.get("rbgs_fused", 0)
          and (c_step.get("rbgs_fused", 0) > 0 or not on_card),
          f"record_cycle_stages: corrected frames vs step, launches "
          f"{nonzero(c_rec)} vs {c_step}")
    print(f"[viz] record_cycle_stages at {kw['stages']['shape']}, "
          f"{len(solver.levels)} levels, 2 iterations: {len(frames)} frames "
          f"in {rec_wall:.3f} s, launches "
          f"{nonzero(c_rec)}; the corrected frames equal step applied once "
          f"and twice bit for bit, with {c_step} launches  ({card})")
    del frames, steps, corrected
    gsolver = GMGSolver(device=dev, **kw["gif"])
    gb = assemble_rhs(gsolver.levels[0], 10.0, test=0, dtype=torch.float32,
                      device=dev)
    gframes, c_gif = run_counted(
        lambda: record_cycle_stages(gsolver, gb, iterations=2))
    gdir = write_stage_files(gframes, os.path.join(tmp, "stages"))
    back = [load_vector(os.path.join(gdir, f"{k}.mtx"))
            for k in range(len(gframes))]
    check(all(np.array_equal(v, f.reshape(-1).astype(np.float64))
              for v, (_, f) in zip(back, gframes)),
          "write_stage_files: the files are not the frames")
    drew = ""
    if importlib.util.find_spec("matplotlib") is not None:
        from multigrid_prj_tpu_torch.cli import viz_main

        check(viz_main.main(["--gif", "--out", os.path.join(tmp, "gif"),
                             "-device", dev]) == 0, "viz_main --gif")
        drew = "; viz_main --gif drew cycle.gif and cycle3d.gif"
    print(f"[viz] viz_main's --gif solve ({kw['gif']['shape']}, "
          f"{kw['gif']['num_levels']} levels): {len(gframes)} stage files "
          f"written and read back equal, launches {nonzero(c_gif)}{drew}"
          f"{'' if drew else '; no matplotlib here, nothing drawn'}")

    # 3. checkpoint and resume at the main path's configuration
    first, rest = CKPT_SPLIT
    ck = GMGSolver(maxit=first, device=dev, **kw["ckpt"])
    bk = assemble_rhs(ck.levels[0], 10.0, test=1, dtype=torch.float32,
                      device=dev)
    part, c_part = run_counted(lambda: ck.solve(bk))
    path = os.path.join(tmp, "ckpt.npz")
    save_checkpoint(path, part.u, bk, part.history,
                    config=dict(kw["ckpt"], maxit=first))
    resumed, c_res = run_counted(lambda: resume_solve(
        GMGSolver(maxit=rest, device=dev, **kw["ckpt"]), path))
    whole, c_whole = counts_of(torch, cs, lambda: GMGSolver(
        maxit=first + rest, device=dev, **kw["ckpt"]).solve(bk))
    check(part.iterations == first and resumed.iterations == rest
          and len(resumed.history) == first + rest + 1
          and np.array_equal(resumed.history, whole.history)
          and torch.equal(resumed.u, whole.u),
          f"checkpoint: resumed history {resumed.history} vs "
          f"{whole.history}, u equal {torch.equal(resumed.u, whole.u)}")
    if on_card:
        check(all(c_res.get(k, 0) > 0 for k in CKPT_KERNELS),
              f"checkpoint resume launches {nonzero(c_res)}")
    print(f"[ckpt] {kw['ckpt']} f32: {first} iterations, save_checkpoint, "
          f"resume_solve for {rest}: the merged history ({len(resumed.history)}"
          f" entries, last {resumed.history[-1]:.4e}) and u equal an "
          f"uninterrupted {first + rest}-iteration solve bit for bit; "
          f"launches: first part {nonzero(c_part)}, resumed "
          f"{ {k: c_res.get(k, 0) for k in CKPT_KERNELS} }, uninterrupted "
          f"{c_whole}")

    # 4. guards and metrics on the card
    bad = bk.clone()
    bad[7, 9] = float("nan")
    cnt = count_nonfinite(bad)
    check(cnt.device.type == torch.device(dev).type and int(cnt) == 1,
          f"count_nonfinite: {cnt}")
    cs.reset_launch_counts()
    msg = None
    try:
        guard_solve_io(ck.solve)(bad)
    except ValueError as e:  # the refusal this check wants
        msg = str(e)
    check(msg is not None and "argument 0 of GMGSolver.solve" in msg
          and not any(cs.LAUNCHES.values()),
          f"guard_solve_io on a NaN rhs: {msg!r}, launches "
          f"{nonzero(cs.LAUNCHES)}")
    print(f"[guards] count_nonfinite -> {int(cnt)} on {cnt.device}; "
          f"guard_solve_io(GMGSolver.solve) refused the NaN rhs with no "
          f"launch: {msg!r}")
    timer = PhaseTimer()
    label = f"solve {kw['ckpt']['shape']}, {first} iterations"
    with timer.phase(label):
        out = ck.solve(bk)
        fence(out.u)
    report = timer.report()
    check(report.startswith(f"{label}: ") and report.endswith(" seconds")
          and timer.phases[label] > 0, f"PhaseTimer report {report!r}")
    print(f"[metrics] PhaseTimer with fence: {report}  ({card})")
    logdir = os.path.join(tmp, "trace")
    with trace(logdir):
        ck.solve(bk)
        sync()
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    text = ""
    for f in files:
        with open(f) as fh:
            text += fh.read()
    if on_card:
        check(len(files) == 1 and "rbgs_fused_kernel" in text,
              f"trace: {files}, names rbgs_fused_kernel: "
              f"{'rbgs_fused_kernel' in text}")
    print(f"[metrics] trace({logdir!r}) around a 3-iteration solve: "
          f"{[os.path.basename(f) for f in files]}, {len(text)} bytes, "
          f"names rbgs_fused_kernel {text.count('rbgs_fused_kernel')} times")
    del text

    # 5. amg_debug at 257^2 nodes with the reference harness's settings
    msh = os.path.join(tmp, "square.msh")
    mesh = structured_unit_square_mesh(kw["mesh"])
    write_msh(msh, mesh)
    vtu = os.path.join(tmp, "debug_output.vtu")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "multigrid_prj_tpu_torch.cli.amg_debug",
         "-mesh", msh, "-levels", "2", "-sweeps", str(kw["sweeps"]),
         "-device", dev, "-o", vtu],
        cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    out_lines = proc.stdout.strip().splitlines()
    for ln in out_lines:
        print(f"[amg_debug]   {ln}")
    check(proc.returncode == 0, f"amg_debug exit {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    r0 = float(next(ln for ln in out_lines if ln.startswith(
        "coarse residual before")).split()[-1])
    r1 = float(next(ln for ln in out_lines if ln.startswith(
        "coarse residual after")).split(":")[1].split()[0])
    with open(vtu) as fh:
        head = fh.read(4096)
    check(any("PASSED" in ln for ln in out_lines) and r1 < r0
          and f'NumberOfPoints="{mesh.n_nodes}"' in head,
          f"amg_debug: residual {r0} -> {r1}, VTU head {head[:300]!r}")
    # the sweeps' time, in this process on the same coarse level
    A, rhs = assemble_p1(parse_msh(msh))
    labels = coarsen_greedy(A, 0.2, seed=0)
    P = build_prolongation(A, labels, 0.2)
    Ac, bc = rap(P, A), P.transpose().spmv(rhs)
    cs_solver = AMGSolver(Ac, num_levels=1, smoother="mcgs",
                          use_pallas=False, reorder="none", device=dev)
    lvl = cs_solver.levels[0]
    xb = to_device(bc, cs_solver.dtype, cs_solver.device)
    x0 = torch.zeros_like(xb)
    amg_debug.coarse_smooth(lvl, x0, xb, 10)  # warm-up
    sync()
    t1 = time.perf_counter()
    amg_debug.coarse_smooth(lvl, x0, xb, kw["timed_sweeps"])
    sync()
    per_sweep = (time.perf_counter() - t1) / kw["timed_sweeps"]
    print(f"[amg_debug] {kw['mesh']}^2 mesh ({mesh.n_nodes} nodes), -levels 2"
          f" -sweeps {kw['sweeps']} -device {dev}: exit 0 in {wall:.2f} s, "
          f"PASSED, coarse residual {r0:.4e} -> {r1:.4e}, VTU of "
          f"{mesh.n_nodes} points; the coarse system {Ac.shape[0]} rows, "
          f"{len(lvl.color_blocks)} colours: {per_sweep * 1e3:.4f} ms per "
          f"sweep ({kw['timed_sweeps']} timed)  ({card})")
    # at 33 x 33 the card's and the CPU's runs print the same set-up lines
    small = os.path.join(tmp, "small.msh")
    write_msh(small, structured_unit_square_mesh(kw["mesh_small"]))
    printed = {}
    for d in (dev, "cpu"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = amg_debug.main(["-mesh", small, "-levels", "3", "-sweeps",
                                 "30", "-device", d, "-o",
                                 os.path.join(tmp, f"small_{d}.vtu")])
        check(rc == 0, f"amg_debug -device {d} at {kw['mesh_small']}^2")
        printed[d] = [ln for ln in buf.getvalue().splitlines()
                      if ln.startswith(("Mesh", "Assembled", "level ",
                                        "  -> P"))]
    check(printed[dev] == printed["cpu"] and len(printed["cpu"]) == 6,
          f"amg_debug set-up lines, {dev} vs cpu: {printed}")
    print(f"[amg_debug] {kw['mesh_small']}^2, -levels 3: the {dev} and cpu "
          f"runs print the same {len(printed['cpu'])} set-up lines")
    shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from multigrid_prj_tpu_torch.gmg import GMGSolver
    from multigrid_prj_tpu_torch.grids import build_hierarchy
    from multigrid_prj_tpu_torch.kernels import _build
    from multigrid_prj_tpu_torch.models.poisson import assemble_rhs
    from multigrid_prj_tpu_torch.ops import cuda_stencil as cs
    from multigrid_prj_tpu_torch.ops import cuda_stencil_3d as c3
    from multigrid_prj_tpu_torch.ops import extended as text
    from multigrid_prj_tpu_torch.ops import transfer as tr
    from multigrid_prj_tpu_torch.ops.transfer import pad_to
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
    print(f"[build] nvcc, {len(_build.SOURCES)} sources in parallel, "
          f"{info['seconds']:.2f} s -> {info['path']}")
    for ln in regs:
        print(f"[build] {ln}")
    for ln in tile_kernel_report(cs, c3, info["log"]):
        print(f"[build] {ln}")
    _build.library()

    # 3. 2D kernel vs twin (torch.equal at every path shape)
    phases.next("2D kernel vs twin")
    max_err = {k: 0.0 for k in {**KERNELS, **PROBES}}
    for i, (shape, logical) in enumerate(KERNEL_SHAPES):
        u, b, u_lo, h = kernel_inputs(torch, shape, logical, seed=i)
        done = []
        for kname, cases in kernel_calls(cs, text, u, b, u_lo, h,
                                         logical).items():
            for label, kern, twin in cases:
                got, want = flat(kern()), flat(twin())
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
    # sweeps 4 does not fit the down-leg's halo: the wrapper runs the
    # kernels it fuses, with no fused launch
    (shape, logical), sweeps = KERNEL_SHAPES[0], 4
    u, b, _, h = kernel_inputs(torch, shape, logical, seed=0)
    cs.reset_launch_counts()
    got = torch.cat([x.reshape(-1) for x in cs.rbgs_residual_restrict(
        u, b, 10.0, h, sweeps, logical)])
    torch.cuda.synchronize()
    counts = {k: v for k, v in cs.LAUNCHES.items() if v}
    n_fused = cs.LAUNCHES["rbgs_resfilter"]
    want = torch.cat([x.reshape(-1) for x in cs.rbgs_residual_restrict_plain(
        u, b, 10.0, h, sweeps, logical)])
    print(f"[kernels] down-leg with sweeps {sweeps} at {shape}: {n_fused} "
          f"fused launches, launches {counts}; equal to its twin: "
          f"{torch.equal(got, want)}")
    check(n_fused == 0 and torch.equal(got, want) and counts == {
        "rbgs_fused": 1, "residual": 1, "restrict_fw": 1},
          f"down-leg with sweeps {sweeps}")
    # the apply chain's C entry point refuses a geometry other than the
    # compiled one, before any launch
    import ctypes

    lib, y = _build.library(), torch.empty_like(u)
    n, m = shape
    chain_args = (cs._ptr(u), cs._ptr(y), n, m, *logical, 1.0)
    good = lib.mg_apply_chain(*chain_args, CHAIN_FUSE, cs._geometry(
        CHAIN_FUSE, cs.apply_tile), cs._stream())
    bad = {f"{a} applies, geometry {g}": lib.mg_apply_chain(
        *chain_args, a, (ctypes.c_int * 4)(*g), cs._stream())
        for a, g in ((8, (8, 8, 96, 128)), (8, (7, 8, 64, 128)),
                     (8, (8, 4, 64, 128)), (3, cs.apply_tile(8)),
                     (9, (9, 12, 64, 128)))}
    torch.cuda.synchronize()
    print(f"[kernels] apply_chain's entry point: the compiled geometry "
          f"{cs.apply_tile(CHAIN_FUSE)} launches (error {good}); refused "
          f"with errors {bad}")
    check(good == 0 and all(bad.values()), "apply_chain geometry refusal")
    # so do the Jacobi tile's and the prolong-add stream's
    jac_args = (cs._ptr(u), cs._ptr(b), cs._ptr(y), n, m, *logical, 0.1)
    good = lib.mg_jacobi_fused(*jac_args, 2, 1, 0.2, 0.8, cs._geometry(
        2, cs.jacobi_tile), cs._stream())
    bad = {f"{s} sweeps, geometry {g}": lib.mg_jacobi_fused(
        *jac_args, s, 1, 0.2, 0.8, (ctypes.c_int * 4)(*g), cs._stream())
        for s, g in ((2, (2, 4, 96, 128)), (2, (1, 4, 64, 128)),
                     (2, (2, 8, 64, 128)), (3, cs.jacobi_tile(2)),
                     (9, (9, 12, 64, 128)))}
    e = b[: n // 2, : m // 2].contiguous()
    strip, quads = cs.prolong_tile()
    good_p = lib.mg_prolong_add(cs._ptr(e), cs._ptr(u), cs._ptr(y), n // 2,
                                m // 2, (ctypes.c_int * 2)(strip, quads),
                                cs._stream())
    bad.update({f"prolong-add geometry {g}": lib.mg_prolong_add(
        cs._ptr(e), cs._ptr(u), cs._ptr(y), n // 2, m // 2,
        (ctypes.c_int * 2)(*g), cs._stream())
        for g in ((strip + 1, quads), (strip, 2 * quads))})
    torch.cuda.synchronize()
    print(f"[kernels] jacobi_fused's entry point: the compiled geometry "
          f"{cs.jacobi_tile(2)} launches (error {good}); prolong_add's "
          f"{(strip, quads)} launches (error {good_p}); refused with errors "
          f"{bad}")
    check(good == good_p == 0 and all(bad.values()),
          "jacobi_fused / prolong_add geometry refusal")
    del u, b, got, want, y, e
    torch.cuda.empty_cache()

    # 4. 3D kernel vs twin: every level of paths A-D (C's finest is 513^3)
    # and the non-cubic shape
    phases.next("3D kernel vs twin")
    shapes_3d = level_shapes_3d(build_hierarchy, CONFIG4_KW, PADDED4_KW,
                                SCALE3D_KW, VARIANT3D_KW) + [NONCUBIC_3D,
                                                             RAGGED_3D,
                                                             CHUNK_3D]
    for i, (shape, logical) in enumerate(shapes_3d):
        u, b, h = kernel_inputs_3d(torch, shape, logical, seed=100 + i)
        route = c3.rbgs3d_route(shape)
        for kname, cases in kernel_calls_3d(c3, u, b, h, logical).items():
            for label, kern, twin in cases:
                got, want = flat(kern()), flat(twin())
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                max_err[kname] = max(max_err[kname], err)
                check(torch.equal(got, want),
                      f"{kname} ({label}, {route}) != twin at {shape} "
                      f"logical {logical} (max abs diff {err})")
                del got, want
        print(f"[kernels3d] {shape} logical {logical}: "
              f"{', '.join(KERNELS_3D)} equal to their twins (torch.equal); "
              f"rbgs3d_fused on the {route} route, sweeps "
              f"{'0-9 and 100' if route == 'resident' else '0-9'} also "
              "equal to the per-colour oracle; jacobi3d on the "
              f"{c3.jacobi3d_route(shape)} route (2-sweep march "
              f"{c3.jacobi3d_tile(shape, 2)}), sweeps 0-9 and 100, omega 1 "
              "and 0.8, also equal to the per-sweep oracle; apply3d "
              f"(march {c3.residual3d_tile(shape)}) also to apply3d_point; "
              "ff_update_residual3d also to the pair update and "
              "ff_residual3d in turn")
        del u, b
    # the residual's C entry point refuses a geometry other than the
    # compiled tile and the chunk rule's
    shape, logical = CHUNK_3D
    u, b, h = kernel_inputs_3d(torch, shape, logical, seed=99)
    r3 = torch.empty_like(u)
    geo = c3.residual3d_tile(shape)
    r3_args = (cs._ptr(u), cs._ptr(b), cs._ptr(r3), *shape, *shape, 1.0)
    lib = _build.library()
    good = lib.mg_residual3d(*r3_args, (ctypes.c_int * 4)(*geo),
                             cs._stream())
    bad = {str(g): lib.mg_residual3d(*r3_args, (ctypes.c_int * 4)(*g),
                                     cs._stream())
           for g in ((geo[0], geo[1], geo[2] + 1, geo[3]),
                     (16, geo[1], geo[2], geo[3]),
                     (geo[0], 16, geo[2], geo[3]),
                     (geo[0], geo[1], geo[2], geo[3] + 1))}
    torch.cuda.synchronize()
    print(f"[kernels3d] residual3d's entry point at {shape}: the geometry "
          f"{geo} launches (error {good}); refused with errors {bad}")
    check(good == 0 and all(bad.values()), "residual3d geometry refusal")
    # so do the apply's (the same geometry) and the Jacobi march's (the
    # compiled tile, the sweeps' halo and the chunk rule's), and the
    # resident Jacobi a cap other than the compiled one
    good = lib.mg_apply3d(cs._ptr(u), cs._ptr(r3), *shape, *shape, 1.0,
                          (ctypes.c_int * 4)(*geo), cs._stream())
    bad = {str(g): lib.mg_apply3d(cs._ptr(u), cs._ptr(r3), *shape, *shape,
                                  1.0, (ctypes.c_int * 4)(*g), cs._stream())
           for g in ((geo[0], geo[1], geo[2] + 1, geo[3]),
                     (16, geo[1], geo[2], geo[3]))}
    jgeo = c3.jacobi3d_tile(shape, 2)
    j3_args = (cs._ptr(u), cs._ptr(b), cs._ptr(r3), *shape, *shape, 1.0,
               1.0 / 6.0, 1, 0.2, 0.8)
    jgood = lib.mg_jacobi3d(*j3_args, 2, (ctypes.c_int * 5)(*jgeo),
                            cs._stream())
    jbad = {f"{sw} sweeps, {g}": lib.mg_jacobi3d(
        *j3_args, sw, (ctypes.c_int * 5)(*g), cs._stream())
        for sw, g in ((2, (jgeo[0], jgeo[1], jgeo[2], jgeo[3] + 1, jgeo[4])),
                      (2, (32, jgeo[1], jgeo[2], jgeo[3], jgeo[4])),
                      (2, (jgeo[0], 16, jgeo[2], jgeo[3], jgeo[4])),
                      (3, jgeo), (5, (jgeo[0], jgeo[1], 5, *jgeo[3:])))}
    small = torch.zeros(CONFIG4_BOTTOM, device="cuda")
    rgood = lib.mg_jacobi3d_resident(
        cs._ptr(small), cs._ptr(small), cs._ptr(r3), *CONFIG4_BOTTOM,
        *CONFIG4_BOTTOM, 1.0, 1.0 / 6.0, 1, 0.2, 0.8, 100,
        c3.RESIDENT_MAX_POINTS, cs._stream())
    rbad = lib.mg_jacobi3d_resident(
        cs._ptr(small), cs._ptr(small), cs._ptr(r3), *CONFIG4_BOTTOM,
        *CONFIG4_BOTTOM, 1.0, 1.0 / 6.0, 1, 0.2, 0.8, 100,
        c3.RESIDENT_MAX_POINTS + 1, cs._stream())
    torch.cuda.synchronize()
    print(f"[kernels3d] apply3d's entry point at {shape}: {geo} launches "
          f"(error {good}); refused with errors {bad}. jacobi3d's: "
          f"{jgeo} launches (error {jgood}); refused with errors {jbad}; "
          f"the resident Jacobi: cap {c3.RESIDENT_MAX_POINTS} launches "
          f"(error {rgood}), another refused (error {rbad})")
    check(good == 0 and all(bad.values()), "apply3d geometry refusal")
    check(jgood == 0 and all(jbad.values()) and rgood == 0 and rbad != 0,
          "jacobi3d geometry refusal")
    del u, b, r3, small
    torch.cuda.empty_cache()

    launches = dict.fromkeys(cs.LAUNCHES, 0)

    def run_counted(fn):
        """One run of a path with the counters set to 0 just before and
        read just after; adds them to ``launches``."""
        cs.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = dict(cs.LAUNCHES)
        for k, v in counts.items():
            launches[k] += v
        return out, counts

    def run_path(solver, b, method="solve_refined", **kw):
        return run_counted(lambda: getattr(solver, method)(b, **kw))

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

    def check_twins(tag, res, kw, b, rtol=HISTORY_RTOL,
                    method="solve_refined", **solve_kw):
        t0 = time.perf_counter()
        ref = getattr(GMGSolver(**kw, device="cpu", use_pallas=True),
                      method)(b.cpu(), **solve_kw)
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

    def check_fused_equal(tag, res_f, counts_f, res_u, counts_u):
        """A fuse_downleg solve against the unfused one of the same run:
        the same history and solution bit for bit, and each fused launch
        in place of one smoother, one residual and one restriction
        launch."""
        n = counts_f["rbgs_resfilter"]
        print(f"[{tag}] {n} rbgs_resfilter launches; unfused -> fused: "
              f"residual {counts_u['residual']} -> {counts_f['residual']}, "
              f"restrict_fw {counts_u['restrict_fw']} -> "
              f"{counts_f['restrict_fw']}, rbgs_fused "
              f"{counts_u['rbgs_fused']} -> {counts_f['rbgs_fused']}; all "
              f"launches {sum(counts_u.values())} -> "
              f"{sum(counts_f.values())}; history equal to the unfused "
              "one (bit for bit)")
        check(np.array_equal(res_f.history, res_u.history)
              and torch.equal(res_f.u, res_u.u),
              f"{tag}: differs from the unfused solve")
        check(n > 0 and counts_u["rbgs_resfilter"] == 0
              and counts_u["residual"] - counts_f["residual"] == n
              and counts_u["restrict_fw"] - counts_f["restrict_fw"] == n
              and counts_u["rbgs_fused"] - counts_f["rbgs_fused"] == n,
              f"{tag}: launches {counts_f}, unfused {counts_u}")

    gs_need = ("rbgs_fused", "residual", "ff_residual", "ff_update_residual",
               "restrict_fw", "prolong_add")
    # every level above the bottom is padded, so the fused down-leg takes
    # all the cycle's residual and restriction launches
    fused_need = ("rbgs_fused", "ff_residual", "ff_update_residual",
                  "prolong_add",
                  "rbgs_resfilter")

    def per_colour(s):
        """``s`` with its smoother swapped for the per-colour oracle (2 x
        sweeps ``rbgs_color`` launches on a clone of u, the path before the
        fused smoother): the reference the fused paths are held to."""
        def _sm(u, b, alpha, h, sweeps=1, logical_shape=None):
            return cs._rbgs_per_colour(u, b, alpha, h, sweeps, logical_shape)

        return swap(s, smooth=_sm)

    def check_smoother_launches(tag, s, res, counts, fused):
        """One fused launch per smoother call of <= 4 sweeps: 2 calls per
        smoothed level and cycle (the bottom is the dense inverse), the
        pre-smoothing in the down-leg when fused; no oracle launch."""
        calls = (len(s.levels) - 1) * res.iterations * (1 if fused else 2)
        print(f"[{tag}] smoother launches: rbgs_fused {counts['rbgs_fused']} "
              f"(expected {calls}: one per call), rbgs_color "
              f"{counts['rbgs_color']}")
        check(s._coarse_inv is not None and counts["rbgs_fused"] == calls
              and counts["rbgs_color"] == 0, f"{tag}: smoother launches")

    def check_per_colour(tag, res_p, counts_p, res, counts):
        """The per-colour path against the fused one of the same run: the
        same history and solution bit for bit, 2 x sweeps colour launches
        in place of each fused one."""
        print(f"[{tag}] per-colour path: {res_p.iterations} iterations, "
              f"rbgs_color {counts_p['rbgs_color']} launches (fused path: "
              f"rbgs_fused {counts['rbgs_fused']}); all launches "
              f"{sum(counts_p.values())} (fused path "
              f"{sum(counts.values())}); history equal: "
              f"{np.array_equal(res_p.history, res.history)}")
        check(np.array_equal(res_p.history, res.history)
              and torch.equal(res_p.u, res.u),
              f"{tag}: the fused path differs from the per-colour path")
        check(counts_p["rbgs_fused"] == 0 and counts_p["rbgs_color"]
              == 4 * counts["rbgs_fused"], f"{tag}: per-colour launches")

    # 5. main path: 1025^2 ff32-refined V(2,2) solve on the card
    phases.next("main path 1025^2")
    solver = GMGSolver(**SOLVER_KW, device="cuda")
    b = assemble_rhs(solver.levels[0], 10.0, test=1, dtype=torch.float32,
                     device="cuda")
    res, counts = run_path(solver, b)
    check_solve("main", res, SHAPE, 1e-8, TPU_ITERATIONS, counts, gs_need)
    check_smoother_launches("main", solver, res, counts, fused=False)
    main_launches = sum(counts.values())
    check_twins("main", res, SOLVER_KW, b)
    psolver = per_colour(GMGSolver(**SOLVER_KW, device="cuda"))
    res_p, counts_p = run_path(psolver, b)
    check_per_colour("main", res_p, counts_p, res, counts)
    colour_launches = sum(counts_p.values())

    # 5b. the main path with fuse_downleg: bit-equal to the unfused run, one
    # fused launch in place of each level's smoother, residual and
    # restriction; .solve as well; 129^2 against its CPU-twin run
    phases.next("main path 1025^2, fuse_downleg")
    fsolver = GMGSolver(**SOLVER_KW, fuse_downleg=True, device="cuda")
    res_f, counts_f = run_path(fsolver, b)
    check_solve("main fuse_downleg", res_f, SHAPE, 1e-8, TPU_ITERATIONS,
                counts_f, fused_need)
    check_smoother_launches("main fuse_downleg", fsolver, res_f, counts_f,
                            fused=True)
    check_fused_equal("main fuse_downleg", res_f, counts_f, res, counts)
    fused_launches = sum(counts_f.values())
    for fuse in (False, True):
        tag = f"1025 .solve to {SOLVE_TOL}, fuse_downleg={fuse}"
        s = GMGSolver(**dict(SOLVER_KW, tol=SOLVE_TOL), fuse_downleg=fuse,
                      device="cuda")
        out, c = run_path(s, b, "solve")
        print(f"[{tag}] {out.iterations} iterations to "
              f"{float(out.history[-1]):.3e}; launches {c}")
        check(out.converged and bool(torch.isfinite(out.u).all()),
              f"{tag}: not converged")
        if fuse:
            check_fused_equal(tag, out, c, res_s, counts_s)
        res_s, counts_s = out, c
    kw129 = dict(SOLVER_KW, shape=(129, 129), num_levels=4, pad_align=128,
                 fuse_downleg=True)
    s129 = GMGSolver(**kw129, device="cuda")
    b129 = assemble_rhs(s129.levels[0], 10.0, test=1, device="cuda")
    res129, c129 = run_path(s129, b129)
    check(res129.converged and c129["rbgs_resfilter"] > 0,
          f"129^2 fuse_downleg: {c129}")
    check_twins("129 fuse_downleg", res129, kw129, b129)

    # 6. at scale: 8193^2, plain and inner_cg=4
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
        if not inner:  # inner_cg's preconditioner cycles call it too
            check_smoother_launches(tag, big, res8, counts, fused=False)
        print(f"[{tag}] peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        big_res[inner] = (res8, counts)
        del res8
    t0 = time.perf_counter()
    big_f = GMGSolver(**SCALE_KW, fuse_downleg=True, device="cuda")
    print(f"[8193 fuse_downleg] solver set-up {time.perf_counter() - t0:.1f} "
          "s")
    res8f, counts = run_path(big_f, big_b)
    check_solve("8193 fuse_downleg", res8f, (8193, 8193), 1e-7,
                SCALE_ITERATIONS[0], counts, fused_need)
    check_smoother_launches("8193 fuse_downleg", big_f, res8f, counts,
                            fused=True)
    check_fused_equal("8193 fuse_downleg", res8f, counts, *big_res[0])
    del res8f
    big_p = per_colour(GMGSolver(**SCALE_KW, device="cuda"))
    res8p, counts = run_path(big_p, big_b)
    check_per_colour("8193", res8p, counts, *big_res[0])
    del res8p
    # with the one-thread-per-point prolong-add swapped in for the stream:
    # bit-equal, one point launch in place of each stream launch
    big_pt = swap(GMGSolver(**SCALE_KW, device="cuda"),
                  prolong_add=cs._prolong_add_point)
    res8t, counts = run_path(big_pt, big_b)
    res8, counts8 = big_res[0]
    print(f"[8193] with prolong_add_point swapped in: {res8t.iterations} "
          f"iterations, prolong_add_point {counts['prolong_add_point']} "
          f"launches (stream path: prolong_add {counts8['prolong_add']}); "
          f"history and solution equal: "
          f"{np.array_equal(res8t.history, res8.history)}, "
          f"{torch.equal(res8t.u, res8.u)}")
    check(np.array_equal(res8t.history, res8.history)
          and torch.equal(res8t.u, res8.u)
          and counts["prolong_add"] == 0
          and counts["prolong_add_point"] == counts8["prolong_add"] > 0,
          "8193: the prolong-add stream differs from the point kernel")
    del res8t, res8

    # 7. 1025^2 inner_cg=4 and Jacobi omega 0.8, each against its CPU twins
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
    check(res_jac.iterations == JACOBI_ITERATIONS
          and counts["jacobi"] == JACOBI_LAUNCHES
          and counts["jacobi_sweep"] == 0,
          f"1025 jacobi: {res_jac.iterations} iterations, "
          f"{counts['jacobi']} jacobi launches (expected "
          f"{JACOBI_ITERATIONS}, {JACOBI_LAUNCHES})")
    check_twins("1025 jacobi", res_jac, JACOBI_KW, b)

    def per_sweep(s):
        """``s`` with its Jacobi smoother swapped for the per-sweep kernel
        (one ``jacobi_sweep`` launch per sweep, the path before the fused
        tile)."""
        def _sm(u, b, alpha, h, sweeps=1, logical_shape=None):
            return cs._jacobi_per_sweep(u, b, alpha, h, JACOBI_KW["omega"],
                                        sweeps, logical_shape)

        return swap(s, smooth=_sm)

    jac_o = per_sweep(GMGSolver(**JACOBI_KW, device="cuda"))
    res_jo, counts_o = run_path(jac_o, b)
    print(f"[1025 jacobi] {counts['jacobi']} fused jacobi launches (expected "
          f"{JACOBI_LAUNCHES}); with the per-sweep kernel swapped in: "
          f"{res_jo.iterations} iterations, jacobi_sweep "
          f"{counts_o['jacobi_sweep']} launches; history and solution equal: "
          f"{np.array_equal(res_jo.history, res_jac.history)}, "
          f"{torch.equal(res_jo.u, res_jac.u)}")
    check(np.array_equal(res_jo.history, res_jac.history)
          and torch.equal(res_jo.u, res_jac.u) and counts_o["jacobi"] == 0
          and counts_o["jacobi_sweep"] == 2 * JACOBI_LAUNCHES,
          "1025 jacobi: the fused tile differs from the per-sweep kernel")
    del res_jo

    # 8. the options whose JAX meaning is "no kernel" run plain ops on CUDA
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
    check(res_sor.converged and cs.LAUNCHES["rbgs_fused"] == 0
          and cs.LAUNCHES["rbgs_color"] == 0, "omega=1.2 solve")

    # 9. CLI on the card (three runs at once, one process each)
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

    # 10. 3D paths A (config 4 verbatim), B (padded), C (513^3)
    phases.next("3D paths A, B, C")
    need3d = ("rbgs3d_fused", "residual3d")
    paths3d, colour3d = {}, {}

    def per_colour3d(s):
        """``s`` with its smoother swapped for the 3D per-colour oracle (2 x
        sweeps ``rbgs3d_color`` launches on a clone of u, the path before
        the fused smoother)."""
        def _sm(u, b, alpha, h, sweeps=1, logical_shape=None):
            return c3._rbgs3d_per_colour(u, b, alpha, h, sweeps,
                                         logical_shape)

        return swap(s, smooth=_sm)

    def smoother3d_calls(s, res):
        """Smoother calls of a 3D solve: 2 per smoothed level and iteration,
        and the bottom's, which runs the smoother when the coarsest level is
        above the dense inverse's cap."""
        bottom = s._coarse_inv is None
        return ((len(s.levels) - 1) * 2 + bottom) * res.iterations, bottom
    for tag, kw in [("A 257^3", CONFIG4_KW), ("B 257^3 pad (8,8,128)",
                                               PADDED4_KW),
                    ("C 513^3", SCALE3D_KW)]:
        t0 = time.perf_counter()
        extra = dict(smoother_dtype=torch.bfloat16) if tag[0] == "A" else {}
        s3 = GMGSolver(**kw, **extra, device="cuda")
        b3 = rhs_3d(torch, s3.levels[0], "cuda")
        torch.cuda.synchronize()
        print(f"[{tag}] set-up {time.perf_counter() - t0:.1f} s; levels "
              f"{[lev.physical for lev in s3.levels]}; dense bottom "
              f"inverse: {s3._coarse_inv is not None}")
        torch.cuda.reset_peak_memory_stats()
        res3, counts = run_path(s3, b3)
        if tag[0] == "C":
            check(res3.converged and float(res3.history[-1]) <= 1e-8
                  and res3.iterations == SCALE3D_ITERATIONS,
                  f"{tag}: not converged in {SCALE3D_ITERATIONS} iterations")
            print(f"[{tag}] {res3.iterations} iterations, final rel. "
                  f"residual {float(res3.history[-1]):.3e}; history "
                  f"{[float(x) for x in res3.history]}")
            print(f"[{tag}] kernel launches during the solve: {counts}")
        else:
            check_solve(tag, res3, kw["shape"], 1e-8, CONFIG4_ITERATIONS,
                        counts, need3d)
        check(all(counts[k] > 0 for k in need3d)
              and tuple(res3.u.shape) == kw["shape"]
              and bool(torch.isfinite(res3.u).all()), f"{tag}: solution")
        # one fused launch per smoother call: 2-sweep calls on the
        # z-marching tile, the 17^3 bottom's 100 sweeps on the resident route
        calls, bottom = smoother3d_calls(s3, res3)
        print(f"[{tag}] smoother launches: rbgs3d_fused "
              f"{counts['rbgs3d_fused']} (expected {calls}: one per call, the "
              f"bottom's {s3.levels[-1].physical} on the "
              f"{c3.rbgs3d_route(s3.levels[-1].physical)} route: {bottom}), "
              f"rbgs3d_color {counts['rbgs3d_color']}")
        check(counts["rbgs3d_fused"] == calls and counts["rbgs3d_color"] == 0,
              f"{tag}: smoother launches")
        print(f"[{tag}] peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"{sum(counts.values()) / res3.iterations:.1f} kernel launches "
              "per iteration (wrapper counts)")
        paths3d[tag] = (s3, b3, res3)
        n_res = {"A": CONFIG4_RESIDUAL_LAUNCHES,
                 "C": SCALE3D_RESIDUAL_LAUNCHES}.get(tag[0])
        print(f"[{tag}] residual3d launches {counts['residual3d']} "
              f"(expected {n_res}: one per smoothed level and iteration)")
        check(n_res is None or counts["residual3d"] == n_res,
              f"{tag}: residual launches")
        # the float-float residual: the first on its own kernel, each later
        # one fused with the pair update before it
        print(f"[{tag}] ff_residual3d launches {counts['ff_residual3d']} "
              f"(expected 1), ff_update_residual3d "
              f"{counts['ff_update_residual3d']} (expected "
              f"{res3.iterations}: one per iteration)")
        check(counts["ff_residual3d"] == 1
              and counts["ff_update_residual3d"] == res3.iterations,
              f"{tag}: float-float residual launches")
        # the transfers: a kernel launch each at every exact-layout level
        # above the bottom per iteration, plain ops at padded ones
        n_exact = sum(lev.padded_shape is None for lev in s3.levels[:-1])
        print(f"[{tag}] restrict_fw3d launches {counts['restrict_fw3d']}, "
              f"prolong_add3d {counts['prolong_add3d']} (expected "
              f"{n_exact * res3.iterations}: {n_exact} exact-layout "
              "transfer levels, one each per iteration)")
        check(counts["restrict_fw3d"] == counts["prolong_add3d"]
              == n_exact * res3.iterations, f"{tag}: transfer launches")
        if tag[0] == "A":  # and with the plain ff ops, and per colour
            check(calls == CONFIG4_FUSED_LAUNCHES, f"{tag}: {calls} calls")
            # with the plain pair update and float-float residual in place
            # of their kernels
            fs3 = swap(GMGSolver(**kw, **extra, device="cuda"),
                       ff_residual=text.ff_poisson_residual,
                       ff_update_residual=text.ff_update_residual)
            res3f, counts_f = run_path(fs3, b3)
            print(f"[{tag}] with the plain pair update and float-float "
                  f"residual: {res3f.iterations} iterations, ff_residual3d "
                  f"{counts_f['ff_residual3d']} launches, "
                  f"ff_update_residual3d "
                  f"{counts_f['ff_update_residual3d']}; history and "
                  f"solution equal: "
                  f"{np.array_equal(res3f.history, res3.history)}, "
                  f"{torch.equal(res3f.u, res3.u)}")
            check(res3f.iterations == res3.iterations
                  and np.array_equal(res3f.history, res3.history)
                  and torch.equal(res3f.u, res3.u)
                  and counts_f["ff_residual3d"] == 0
                  and counts_f["ff_update_residual3d"] == 0,
                  f"{tag}: the ff residual kernels differ from the plain "
                  "ones")
            del fs3, res3f
            # with the plain exact-layout transfers in place of their
            # kernels
            ts3 = swap(GMGSolver(**kw, **extra, device="cuda"),
                       exact_restrict=tr.restrict_full_weighting,
                       exact_prolong_add=tr.prolong_add)
            res3t, counts_t = run_path(ts3, b3)
            print(f"[{tag}] with the plain transfers: {res3t.iterations} "
                  f"iterations, restrict_fw3d {counts_t['restrict_fw3d']} "
                  f"launches, prolong_add3d {counts_t['prolong_add3d']}; "
                  f"history and solution equal: "
                  f"{np.array_equal(res3t.history, res3.history)}, "
                  f"{torch.equal(res3t.u, res3.u)}")
            check(res3t.iterations == res3.iterations
                  and np.array_equal(res3t.history, res3.history)
                  and torch.equal(res3t.u, res3.u)
                  and counts_t["restrict_fw3d"] == 0
                  and counts_t["prolong_add3d"] == 0,
                  f"{tag}: the transfer kernels differ from the plain ops")
            del ts3, res3t
            ps3 = per_colour3d(GMGSolver(**kw, **extra, device="cuda"))
            res3p, counts_p = run_path(ps3, b3)
            print(f"[{tag}] per-colour path: {res3p.iterations} iterations, "
                  f"rbgs3d_color {counts_p['rbgs3d_color']} launches (fused "
                  f"path: rbgs3d_fused {counts['rbgs3d_fused']}); all "
                  f"launches {sum(counts_p.values())} (fused path "
                  f"{sum(counts.values())}); history and solution equal: "
                  f"{np.array_equal(res3p.history, res3.history)}, "
                  f"{torch.equal(res3p.u, res3.u)}")
            check(res3p.iterations == res3.iterations == CONFIG4_ITERATIONS
                  and np.array_equal(res3p.history, res3.history)
                  and torch.equal(res3p.u, res3.u),
                  f"{tag}: the fused path differs from the per-colour path")
            check(counts_p["rbgs3d_fused"] == 0 and counts_p["rbgs3d_color"]
                  == CONFIG4_COLOUR_LAUNCHES, f"{tag}: per-colour launches")
            colour3d[tag] = ps3
            del res3p
        elif tag[0] == "C":
            check(calls == SCALE3D_FUSED_LAUNCHES, f"{tag}: {calls} calls")

    # 10b. config 4 at its full 257^3 with the Jacobi smoother (omega 0.8;
    # the march, and the 17^3 bottom's 100 sweeps on the resident route) and
    # with inner_cg=4 (the apply on the march), each also with the kernel
    # it replaced swapped in: the same history and solution bit for bit
    phases.next("3D paths A jacobi, A inner_cg=4")
    b_c4 = paths3d["A 257^3"][1]
    shape4 = CONFIG4_KW["shape"]
    jac3 = GMGSolver(**JACOBI3D_KW, device="cuda")
    res_j3, counts = run_path(jac3, b_c4)
    check_solve("A jacobi", res_j3, shape4, 1e-8, JACOBI3D_ITERATIONS, counts,
                ("jacobi3d", "residual3d"))
    bottom = jac3.levels[-1].physical
    print(f"[A jacobi] jacobi3d launches {counts['jacobi3d']} (expected "
          f"{JACOBI3D_LAUNCHES}: one per smoother call, the bottom's "
          f"{bottom} on the {c3.jacobi3d_route(bottom)} route; the levels "
          f"above on the march, 2-sweep geometry at 257^3 "
          f"{c3.jacobi3d_tile(shape4, 2)}), jacobi3d_sweep "
          f"{counts['jacobi3d_sweep']}")
    check(res_j3.iterations == JACOBI3D_ITERATIONS
          and jac3._coarse_inv is None
          and c3.jacobi3d_route(bottom) == "resident"
          and counts["jacobi3d"] == JACOBI3D_LAUNCHES
          and counts["jacobi3d_sweep"] == 0,
          f"A jacobi: {res_j3.iterations} iterations (expected "
          f"{JACOBI3D_ITERATIONS}), {counts['jacobi3d']} jacobi3d launches")

    def per_sweep3d(s):
        """``s`` with its Jacobi smoother swapped for the per-sweep kernel
        (one ``jacobi3d_sweep`` launch per sweep, the path before the
        march)."""
        def _sm(u, b, alpha, h, sweeps=1, logical_shape=None):
            return c3._jacobi3d_per_sweep(u, b, alpha, h,
                                          JACOBI3D_KW["omega"], sweeps,
                                          logical_shape)

        return swap(s, smooth=_sm)

    jac3_o = per_sweep3d(GMGSolver(**JACOBI3D_KW, device="cuda"))
    res_j3o, counts_o = run_path(jac3_o, b_c4)
    print(f"[A jacobi] with the per-sweep kernel swapped in: "
          f"{res_j3o.iterations} iterations, jacobi3d_sweep "
          f"{counts_o['jacobi3d_sweep']} launches (expected "
          f"{JACOBI3D_SWEEP_LAUNCHES}), jacobi3d {counts_o['jacobi3d']}; "
          f"history and solution equal: "
          f"{np.array_equal(res_j3o.history, res_j3.history)}, "
          f"{torch.equal(res_j3o.u, res_j3.u)}")
    check(np.array_equal(res_j3o.history, res_j3.history)
          and torch.equal(res_j3o.u, res_j3.u) and counts_o["jacobi3d"] == 0
          and counts_o["jacobi3d_sweep"] == JACOBI3D_SWEEP_LAUNCHES,
          "A jacobi: the march differs from the per-sweep kernel")
    del res_j3o

    def point_apply3d(s):
        """``s`` with its operator apply swapped for the one-thread-per-
        point kernel the march replaced (``apply3d_point``)."""
        def _apply(u, alpha, h, logical_shape=None):
            return c3._apply3d_launch(u, alpha, h, logical_shape,
                                      "apply3d_point")

        return swap(s, apply=_apply)

    cg3 = GMGSolver(**CONFIG4_KW, device="cuda")
    res_c3, counts = run_path(cg3, b_c4, inner_cg=4)
    check_solve("A inner_cg=4", res_c3, shape4, 1e-8, INNER_CG3D_ITERATIONS,
                counts, need3d + ("apply3d",))
    check(res_c3.iterations == INNER_CG3D_ITERATIONS
          and counts["apply3d_point"] == 0,
          f"A inner_cg=4: {res_c3.iterations} iterations (expected "
          f"{INNER_CG3D_ITERATIONS})")
    cg3_o = point_apply3d(GMGSolver(**CONFIG4_KW, device="cuda"))
    res_c3o, counts_o = run_path(cg3_o, b_c4, inner_cg=4)
    print(f"[A inner_cg=4] apply3d launches {counts['apply3d']}; with "
          f"apply3d_point swapped in: {res_c3o.iterations} iterations, "
          f"apply3d_point {counts_o['apply3d_point']} launches, apply3d "
          f"{counts_o['apply3d']}; history and solution equal: "
          f"{np.array_equal(res_c3o.history, res_c3.history)}, "
          f"{torch.equal(res_c3o.u, res_c3.u)}")
    check(np.array_equal(res_c3o.history, res_c3.history)
          and torch.equal(res_c3o.u, res_c3.u) and counts_o["apply3d"] == 0
          and counts_o["apply3d_point"] == counts["apply3d"] > 0,
          "A inner_cg=4: the march differs from the point apply")
    del res_c3o

    # 11. 3D variants D at 65^3, pad (8, 8, 128), each against its CPU-twin
    # run: GS, inner_cg=4, Jacobi omega 0.8, bf16 defect correction, SOR
    phases.next("3D variants D")
    dv = GMGSolver(**VARIANT3D_KW, device="cuda")
    db = rhs_3d(torch, dv.levels[0], "cuda")
    jac_kw = dict(VARIANT3D_KW, smoother="jacobi", omega=0.8)
    bf16_kw = dict(VARIANT3D_KW, smoother_dtype=torch.bfloat16, tol=BF16_TOL)
    for tag, kw, dsolver, method, solve_kw, need, rtol in [
            ("D GS", VARIANT3D_KW, dv, "solve_refined", {}, need3d,
             HISTORY_RTOL),
            ("D inner_cg=4", VARIANT3D_KW, dv, "solve_refined",
             dict(inner_cg=4), need3d + ("apply3d",), INNER_CG_HISTORY_RTOL),
            ("D jacobi", jac_kw, GMGSolver(**jac_kw, device="cuda"),
             "solve_refined", {}, ("jacobi3d", "residual3d"), HISTORY_RTOL),
            ("D bf16 .solve", bf16_kw, GMGSolver(**bf16_kw, device="cuda"),
             "solve", {}, ("residual3d",), BF16_HISTORY_RTOL)]:
        res_d, counts = run_path(dsolver, db, method, **solve_kw)
        print(f"[{tag}] {res_d.iterations} iterations to "
              f"{float(res_d.history[-1]):.3e}; launches {counts}")
        check(res_d.converged and all(counts[k] > 0 for k in need),
              f"{tag}: not converged, or a kernel of {need} not launched")
        if method == "solve":  # the bf16 cycle runs plain ops
            check(sum(counts.values()) == counts["residual3d"]
                  == res_d.iterations, f"{tag}: the bf16 cycle launched")
        check_twins(tag, res_d, kw, db, rtol=rtol, method=method, **solve_kw)
    cs.reset_launch_counts()
    res_sor = GMGSolver(**VARIANT3D_KW, omega=1.2, device="cuda") \
        .solve_refined(db)
    torch.cuda.synchronize()
    print(f"[D SOR] omega=1.2 (plain smoother): {res_sor.iterations} "
          f"iterations to {float(res_sor.history[-1]):.3e}; launches "
          f"{dict(cs.LAUNCHES)}")
    check(res_sor.converged and cs.LAUNCHES["rbgs3d_fused"] == 0
          and cs.LAUNCHES["rbgs3d_color"] == 0, "3D omega=1.2 solve")

    # 12. options: f64 with the kernels on runs the plain ops (the JAX
    # wrappers send f64 to XLA) and takes the JAX package's iterations; the
    # bf16 defect correction runs in 2D too (3D: paths A-D)
    phases.next("options")
    cs.reset_launch_counts()
    res64 = solver.solve_refined(b.double())
    torch.cuda.synchronize()
    n64 = sum(cs.LAUNCHES.values())
    t0 = time.perf_counter()
    ref64 = GMGSolver(**SOLVER_KW, use_pallas=False, device="cpu") \
        .solve_refined(b.double().cpu())
    diff = abs(res64.history - ref64.history)
    print(f"[options] f64 solve_refined with use_pallas=True: "
          f"{res64.iterations} iterations to {float(res64.history[-1]):.4e} "
          f"(JAX f64: {F64_ITERATIONS}); {n64} kernel launches; the CPU f64 "
          f"plain solve {ref64.iterations} iterations in "
          f"{time.perf_counter() - t0:.1f} s, max history diff "
          f"{float(diff.max()):.3e}")
    # the f64 round-off floor of a relative residual at 1025^2 is
    # eps_f64 kappa(A) ~ 1e-10; the two devices sum in other orders
    check(n64 == 0 and res64.converged and res64.iterations == F64_ITERATIONS
          == ref64.iterations and res64.u.dtype == torch.float64
          and bool((diff <= 1e-10 + 1e-6 * ref64.history).all()),
          "f64 solve_refined with use_pallas=True")
    bf16_2d =dict(SOLVER_KW, shape=(129, 129), num_levels=4, pad_align=128,
                   tol=1e-3, smoother_dtype=torch.bfloat16)
    b129 = assemble_rhs(build_hierarchy((129, 129), 10.0, 4,
                                        pad_align=128)[0], 10.0, test=1,
                        device="cuda")
    cs.reset_launch_counts()
    res_bf = GMGSolver(**bf16_2d, device="cuda").solve(b129)
    torch.cuda.synchronize()
    print(f"[options] smoother_dtype=bfloat16, 129^2 .solve: "
          f"{res_bf.iterations} iterations to {float(res_bf.history[-1]):.3e};"
          f" launches {dict(cs.LAUNCHES)}")
    check(res_bf.converged and sum(cs.LAUNCHES.values())
          == cs.LAUNCHES["residual"] == res_bf.iterations,
          "2D smoother_dtype solve")

    # 12b. the public ops bench.py headlines: the apply chain (A^8 u per
    # pass at 8192^2, bench's u; alpha = h^2, see BENCH_N), held to its
    # twin; its kernel against the twin at 1, 3, 8 and 11 applies there; and
    # a red-black smoother written with the public colour-sweep op on the
    # main path's finest level, held to its twin and to the RB-GS kernel
    phases.next("bench paths: apply chain, colour sweep")
    h_b = 10.0 / (BENCH_N - 1)
    u_b = bench_u(torch, BENCH_N)

    def chain_path():
        x = u_b
        for _ in range(CHAIN_PASSES):
            x = cs.poisson_apply_chain(x, h_b * h_b, h_b, CHAIN_FUSE)
        return x

    x_c, c_c = run_counted(chain_path)
    twin_c = cs.poisson_apply_chain_plain(u_b, h_b * h_b, h_b,
                                          CHAIN_FUSE * CHAIN_PASSES)
    print(f"[bench chain] {CHAIN_PASSES} passes of A^{CHAIN_FUSE} u at "
          f"{BENCH_N}^2: launches {({k: v for k, v in c_c.items() if v})}; "
          f"max |x| {float(x_c.abs().max()):.3e}; equal to "
          f"{CHAIN_FUSE * CHAIN_PASSES} twin applies: "
          f"{torch.equal(x_c, twin_c)}")
    check(c_c["apply_chain"] == CHAIN_PASSES == sum(c_c.values())
          and torch.equal(x_c, twin_c) and bool(torch.isfinite(x_c).all()),
          "bench chain path")
    del x_c, twin_c
    for label, kern, ref in chain_calls(cs, u_b, h_b, None):
        got, want = kern(), ref()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        max_err["apply_chain"] = max(max_err["apply_chain"], err)
        check(torch.equal(got, want),
              f"apply_chain ({label}) != reference at {BENCH_N}^2 ({err})")
    print(f"[kernels] apply_chain at {BENCH_N}^2, applies "
          f"{CHAIN_APPLIES[0]}-{CHAIN_APPLIES[-1]}: equal to its twin and "
          "to single applies (torch.equal)")
    lev0 = solver.levels[0]
    b_pad = pad_to(b, lev0.padded_shape)

    def sweep_path(sweep):
        x = torch.zeros_like(b_pad)
        for _ in range(2):
            for col in (0, 1):
                x = sweep(x, b_pad, 10.0, lev0.h, col, lev0.shape)
        return x

    x_s, c_s = run_counted(lambda: sweep_path(cs.rbgs_color_sweep))
    twin_s = sweep_path(cs.rbgs_color_sweep_plain)
    gs2 = cs.red_black_gauss_seidel(torch.zeros_like(b_pad), b_pad, 10.0,
                                    lev0.h, sweeps=2,
                                    logical_shape=lev0.shape)
    torch.cuda.synchronize()
    d_gs = float((x_s - gs2).abs().max())
    ulp = float(np.spacing(np.float32(float(x_s.abs().max()))))
    print(f"[colour sweep] 2 red-black sweeps from the public op at "
          f"{tuple(b_pad.shape)}: launches "
          f"{({k: v for k, v in c_s.items() if v})}; equal to the twins: "
          f"{torch.equal(x_s, twin_s)}; against the RB-GS kernel (which "
          f"multiplies by 1/c where this op divides by c) {d_gs:.3e} = "
          f"{d_gs / ulp:.3g} ulp of the field's largest value")
    check(c_s["rbgs_color_sweep"] == 4 == sum(c_s.values())
          and torch.equal(x_s, twin_s) and d_gs <= 4 * ulp,
          "colour-sweep path")
    del x_s, twin_s, gs2, u_b

    # 13.-16. AMG: kernels vs twins, the 1024^2 FD solves, 256^2 against
    # the CPU twins, FEM and the amg_main CLI
    amg_ctx = run_amg(torch, phases, launches, max_err)

    # 16b. bench.py's measure_ell_spmm path: X <- A X, 4 vectors, on
    # banded_csr(2**20), held to its twin
    phases.next("bench SpMM path")
    from multigrid_prj_tpu_torch.models.poisson import banded_csr
    from multigrid_prj_tpu_torch.ops import cuda_spmv as cv

    banded = banded_csr(SPMM_N)
    E_b = cv.CudaELL.build(banded, device="cuda")
    X0 = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (SPMM_N, SPMM_NVEC)).astype(np.float32)).cuda()

    def spmm_path(spmm):
        X = X0
        for _ in range(SPMM_PASSES):
            X = spmm(X)
        return X

    X_s, c_m = run_counted(lambda: spmm_path(E_b.spmm))
    twin_m = spmm_path(lambda X: cv.ell_spmm_plain(E_b.colsT, E_b.valsT, X))
    print(f"[bench spmm] {SPMM_PASSES} passes of X <- A X on "
          f"banded_csr({SPMM_N}) (K {E_b.k}, {E_b.nnz} nnz), "
          f"{SPMM_NVEC} vectors: launches "
          f"{({k: v for k, v in c_m.items() if v})}; equal to the twin: "
          f"{torch.equal(X_s, twin_m)}")
    check(c_m["ell_spmm"] == SPMM_PASSES == sum(c_m.values())
          and torch.equal(X_s, twin_m) and bool(torch.isfinite(X_s).all()),
          "bench SpMM path")
    del X_s, twin_m

    # 16c. the sharded smoother's kernel against its twin and against
    # colour sweeps of the global grid
    phases.next("sharded kernel vs twin")
    n_ext = check_fused_ext(torch, cs, max_err)
    print(f"[kernels] rbgs_fused_ext: {n_ext} slabs (R {EXT_ROWS}, row0 "
          f"{EXT_ROW0}, grids {EXT_GRIDS}, sweeps 1-4) equal to the twin and "
          "to 2 x sweeps colour sweeps of the global grid, cropped "
          "(torch.equal)")
    torch.cuda.empty_cache()

    # 16d. the sharded path, one rank on the card (NCCL): README.md's
    # ShardedGMGSolver at 8192^2, kernel route, against the per-colour and
    # grouped plain schedules; one step against the unsharded GMGSolver's
    phases.next("sharded 8192^2, one rank (NCCL)")
    import torch.distributed as dist

    from multigrid_prj_tpu_torch.parallel import ShardedGMGSolver, make_mesh

    backend = init_one_rank_nccl()
    mesh1 = make_mesh()
    shard_kw = dict(SHARD_KW, mesh=mesh1, tol=0.0, maxit=SHARD_CYCLES,
                    device="cuda")
    sh = ShardedGMGSolver(**shard_kw, use_pallas=True)
    sh_b = assemble_rhs(sh.levels[0], 10.0, test=1, dtype=torch.float32,
                        device="cuda")
    mesh1.reset_counts()
    sh_res, c_sh = run_counted(lambda: sh.solve(sh_b))
    hist = sh_res.history
    n_ext_launch = c_sh["rbgs_fused_ext"]
    print(f"[sharded 8192] backend {backend}, mesh {mesh1.axis_names} of "
          f"{mesh1.size}; {sh.num_sharded} sharded levels; "
          f"{sh_res.iterations} cycles; history "
          f"{[float(x) for x in hist]}")
    print(f"[sharded 8192] launches {({k: v for k, v in c_sh.items() if v})}"
          f" ({n_ext_launch / (sh.num_sharded * SHARD_CYCLES):.1f} "
          f"rbgs_fused_ext per sharded level visit); collectives "
          f"{dict(mesh1.counts)}")
    check(sh_res.iterations == SHARD_CYCLES
          and bool(np.all(np.diff(hist[1:]) < 0))
          and bool(torch.isfinite(sh_res.u).all())
          and tuple(sh_res.u.shape) == SHARD_KW["shape"],
          "sharded 8192^2: the history does not fall each cycle, or u is "
          "not finite")
    check(n_ext_launch == 2 * sh.num_sharded * SHARD_CYCLES
          and sum(c_sh.values()) == n_ext_launch,
          f"sharded 8192^2: launches {c_sh}")

    def rel_diff(got, want):
        """Largest relative difference where ``want`` lies above 1e-3."""
        sel = want > 1e-3
        return float((abs(got[sel] - want[sel]) / want[sel]).max())

    plain = {}
    for grouped in (False, True):
        ref, c_ref = run_counted(lambda grouped=grouped: ShardedGMGSolver(
            **shard_kw, use_pallas=False, use_grouped=grouped).solve(sh_b))
        plain[grouped] = ref.history
        check(sum(c_ref.values()) == 0,
              f"sharded 8192^2, use_pallas=False: launches {c_ref}")
        del ref
    diffs = {"kernel route vs per-colour": rel_diff(hist, plain[False]),
             "grouped vs per-colour": rel_diff(plain[True], plain[False])}
    print(f"[sharded 8192] use_pallas=False, per colour: history "
          f"{[float(x) for x in plain[False]]}; grouped: "
          f"{[float(x) for x in plain[True]]}; no launches; max rel. history "
          f"diffs {diffs} (bound {SHARD_HISTORY_RTOL})")
    check(all(d <= SHARD_HISTORY_RTOL for d in diffs.values()),
          f"sharded 8192^2: histories differ: {diffs}")
    un = GMGSolver(shape=SHARD_KW["shape"], num_levels=SHARD_KW["num_levels"],
                   cycle="v", nu=2, pre_sweeps=2, device="cuda")
    u_sh = torch.zeros_like(sh_b)
    fns = {"sharded": lambda: sh.step(u_sh, sh_b),
           "unsharded": lambda: un.step(u_sh, sh_b)}
    step_walls = {k: [] for k in fns}
    for k in fns:
        fns[k]()
    for k in ("sharded", "unsharded", "unsharded", "sharded", "sharded",
              "unsharded"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fns[k]()
        torch.cuda.synchronize()
        step_walls[k].append(time.perf_counter() - t0)
    for k, w in step_walls.items():
        print(f"[time] one V(2,2) step at 8192^2, {k}: median wall "
              f"{statistics.median(w) * 1e3:.2f} ms over 3 "
              f"({[round(x * 1e3, 2) for x in w]} ms, alternating)  ({card})")
    for k in fns:
        try:
            wall, busy, nev, top = profile_run(torch, fns[k])
        except Exception as exc:  # the trace is a measurement aid only
            print(f"[profile] 8192^2 {k} step: not measured ({exc!r})")
            continue
        print(f"[profile] 8192^2 {k} step: {nev} device ops, device busy "
              f"{busy * 1e3:.2f} ms = {busy / max(wall, 1e-12):.1%} of the "
              f"profiled wall {wall * 1e3:.2f} ms  ({card})")
        for kname, (us, cnt) in top[:6]:
            print(f"[profile]   {us / 1e3:8.3f} ms  {cnt:5d}x  {kname[:90]}")
    del un, u_sh, fns
    torch.cuda.empty_cache()

    # 16e. several ranks on the one card (gloo): 4 ranks at 2048^2 on both
    # layouts against one rank, 2 ranks at 256^2 against the CPU twin
    phases.next("sharded 2048^2, 4 ranks on one card (gloo)")
    one = gloo_steps(torch, mesh1, "cuda")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        four = spawn_ranks(4, tmp)
        t4 = time.perf_counter() - t0
        two = spawn_ranks(2, tmp)
        t2 = time.perf_counter() - t0 - t4
    ulp = float(np.spacing(np.float32(abs(one["u"]).max())))
    for layout, r in four.items():
        d = float(abs(r["u"] - one["u"]).max())
        print(f"[gloo 2048] mesh {layout} ({r['backend']}): "
              f"{GLOO_STEPS} steps, u against one rank: max |du| {d:.3e} "
              f"({d / ulp:.3g} ulp of max |u|); rank 0 launches "
              f"{r['launches']}, collectives {r['counts']}")
        check(r["backend"] == "gloo" and d <= 4 * ulp
              and r["num_sharded"] == one["num_sharded"]
              and r["launches"] == 2 * r["num_sharded"] * GLOO_STEPS,
              f"4 gloo ranks, mesh {layout}: u or launches")
    check(np.array_equal(four[(4,)]["u"], four[(2, 2)]["u"]),
          "4 gloo ranks: (dcn, x) differs from (x,)")
    print("[gloo 2048] (x,) and (dcn, x) equal bit for bit")
    cu, cpu = two["cuda"], two["cpu"]
    diff = abs(cu["history"] - cpu["history"])
    print(f"[gloo 256] 2 ranks: card {cu['iterations']} iterations "
          f"({cu['launches']} launches on rank 0), CPU twin "
          f"{cpu['iterations']}; max rel. history diff "
          f"{float((diff / cpu['history']).max()):.3e} (bound "
          f"{HISTORY_RTOL}); spawns {t4:.1f} s (4 ranks), {t2:.1f} s (2)")
    check(cu["converged"] and cu["iterations"] == cpu["iterations"]
          and cu["launches"] > 0 and cpu["launches"] == 0
          and bool((diff <= HISTORY_ATOL + HISTORY_RTOL
                    * cpu["history"]).all()),
          "2 gloo ranks at 256^2: card vs CPU twin")

    # 16f. the design probes of benchmarks/: every stencil probe at 8192^2
    # and each R of its harness, one apply and the harness's 29-apply chain,
    # and every SpMV probe on banded_csr(2**20) at each block size, against
    # its twin (torch.equal); orig is the SpMV kernel
    phases.next("design probes")
    from multigrid_prj_tpu_torch.benchmarks import program as pgm
    from multigrid_prj_tpu_torch.benchmarks import spmv_ablation as spab
    from multigrid_prj_tpu_torch.benchmarks import stencil_ablation as sab

    check(sab.N == sab.M == PROBE_N, "stencil_ablation's N, M")
    u_p = sab.make_u("cuda")
    probe_twins = {}
    for label, mk, rs in sab.VARIANTS:
        kind = mk.__name__[2:]
        for r in rs:
            twin = ((lambda u, r=r: mk.plain(u, r)) if kind == "carry"
                    else mk.plain)
            probe_twins[kind, r] = twin
            for tag, fn_k, fn_p in (
                    ("one apply", mk(r), twin),
                    (f"{PROBE_CHAIN} applies", sab.chain(mk(r))(PROBE_CHAIN),
                     sab.chain(twin)(PROBE_CHAIN))):
                got, want = fn_k(u_p), fn_p(u_p)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                key = f"probe_{kind}"
                max_err[key] = max(max_err[key], err)
                check(torch.equal(got, want), f"{key} R={r} ({tag}) != twin "
                      f"(max abs diff {err})")
                del got, want
        print(f"[probes] {label}: probe_{kind} at {PROBE_N}^2, R {rs}, one "
              f"apply and {PROBE_CHAIN} applies equal to the twin "
              "(torch.equal)")
    n_p = PROBE_N
    halo = sab.v_halo(32)(u_p)
    edges = (torch.equal(halo[0], (4.0 * u_p[0] - u_p[7]) - u_p[1])
             and torch.equal(halo[n_p - 1], (4.0 * u_p[n_p - 1]
                                              - u_p[n_p - 2]) - u_p[n_p - 8]))
    full = sab.v_full(32)(u_p)
    carry_eq = all(torch.equal(sab.v_carry(r)(u_p), full) for r in (32, 64))
    print(f"[probes] probe_halo edge rows (row 0's north u[7], row {n_p - 1}'s"
          f" south u[{n_p - 8}]): {edges}; probe_carry == probe_full at R 32, "
          f"64: {carry_eq}")
    check(edges and carry_eq, "probe_halo edge rows / probe_carry")
    del halo, full
    x_p = spab.pad_x(torch.from_numpy(np.random.default_rng(0).standard_normal(
        SPMM_N).astype(np.float32)).cuda())
    for tag, kern, _ in spab.VARIANTS:
        for br in spab.BLOCK_ROWS:
            got = spab.spmv_variant(E_b, x_p, kern, br)
            if tag == "orig":
                want = E_b.spmv(x_p[:SPMM_N])
                also = cv.ell_spmv_plain(E_b.colsT, E_b.valsT, x_p)
                check(torch.equal(got, also), f"orig br{br} != SpMV twin")
            else:
                want = spab._PLAIN[tag](E_b.colsT, E_b.valsT, x_p)
                err = float((got - want).abs().max())
                max_err[tag] = max(max_err[tag], err)
            check(torch.equal(got, want), f"{tag} br{br} != its twin")
        print(f"[probes] {tag} on banded_csr({SPMM_N}), K {E_b.k}, block rows "
              f"{spab.BLOCK_ROWS}: equal to "
              f"{'CudaELL.spmv and its twin' if tag == 'orig' else 'its twin'}"
              " (torch.equal)")
    torch.cuda.empty_cache()

    # 16g. the sharded AMG path: config 3 on one NCCL rank (16d's group),
    # the SpMV kernel at the path's block shapes, 256^2 against the CPU
    # twin, 4 gloo ranks sharing the card bit-equal to the one rank
    samg_times = run_sharded_amg(torch, phases, launches, max_err, amg_ctx,
                                 card)
    dist.destroy_process_group()
    torch.cuda.empty_cache()

    # 16h. the last slice's modules on the card: the web server answering
    # four requests, record_cycle_stages against step, checkpoint and
    # resume, the guards and metrics, and the amg_debug harness
    phases.next("16h amg_debug, utilities and front-ends")
    run_frontends(torch, run_counted, card)
    torch.cuda.empty_cache()

    missing = [k for k in KERNELS if launches[k] == 0]
    check(not missing, f"kernels no path launched: {missing}")

    # 17. times: kernels vs twins at 1280^2 (warm L2) and 8448^2 (HBM), the
    # 3D ones at 257^3 and 513^3, the bench chain at 8192^2 and SpMM at
    # 2^20 x 4, the AMG ones at 1024^2 and 4096^2, each with its bound and
    # its library call where there is one; warm solves, the 1025^2 and
    # 8193^2 ones fused and unfused in alternating order
    phases.next("times")
    times = {}

    def add_time(k, label, rec, note=""):
        times.setdefault(k, []).append(rec)
        lib = rec["library_ms"]
        lib = "none" if lib is None else f"{lib * 1e3:.1f} us"
        dev = ("" if "device_ms" not in rec else
               f" (device {rec['device_ms'] * 1e3:.1f} us)")
        print(f"[time] {k} {label} at {rec['at']}: kernel "
              f"{rec['ms'] * 1e3:.1f} us{dev}, twin "
              f"{rec['plain_ms'] * 1e3:.1f} "
              f"us, library {lib}; bound {rec['bound_ms'] * 1e3:.1f} us "
              f"({rec['bound_by']}){note}  ({card})")

    # bench.py's headline: A^8 u in one launch against 8 single applies
    n_b = BENCH_N
    u_b = bench_u(torch, n_b)
    a_b = h_b * h_b

    def singles(s=CHAIN_FUSE):
        x = u_b
        for _ in range(s):
            x = cs.poisson_apply(x, a_b, h_b)
        return x

    t_k = median_ms(torch, lambda: cs.poisson_apply_chain(u_b, a_b, h_b,
                                                          CHAIN_FUSE))
    t_p = median_ms(torch, lambda: cs.poisson_apply_chain_plain(
        u_b, a_b, h_b, CHAIN_FUSE), runs=10)
    t_s = median_ms(torch, singles)
    nnz = n_b * n_b + 4 * (n_b - 2) ** 2  # bench.py's count
    per = STENCIL_COST["apply_chain"]
    rec = record(f"{n_b}x{n_b} (bench.py's chain, c = 1)", t_k, t_p,
                 per[0] * n_b * n_b, per[1] * n_b * n_b,
                 device_ms=device_ms(torch, lambda: cs.poisson_apply_chain(
                     u_b, a_b, h_b, CHAIN_FUSE), n_b * n_b),
                 single_applies_ms=t_s,
                 nnz_per_s=nnz * CHAIN_FUSE / (t_k * 1e-3),
                 single_nnz_per_s=nnz * CHAIN_FUSE / (t_s * 1e-3))
    # the ladder: device time per call by applies, the row-walking tile
    # against as many single applies
    chain_paths = {
        "apply_chain": lambda s: cs.poisson_apply_chain(u_b, a_b, h_b, s),
        "single applies": singles}
    chain_ladder = {k: {s: device_ms(torch, lambda s=s, f=f: f(s), n_b * n_b)
                        for s in LADDER_CHAIN} for k, f in chain_paths.items()}
    for k, row in chain_ladder.items():
        print(f"[ladder] {k} at {n_b}x{n_b}, device us per call by applies: "
              f"{ {s: round(v * 1e3, 1) for s, v in row.items()} }  ({card})")
    rec["ladder_ms"] = chain_ladder
    rec["single_applies_device_ms"] = \
        chain_ladder["single applies"][CHAIN_FUSE]
    add_time("apply_chain", f"{CHAIN_FUSE} applies", rec,
             f"; {CHAIN_FUSE} single applies {t_s * 1e3:.1f} us (device "
             f"{rec['single_applies_device_ms'] * 1e3:.1f} us); "
             f"{rec['nnz_per_s']:.4g} nnz/s fused, "
             f"{rec['single_nnz_per_s']:.4g} single")
    del u_b
    for shape, logical in TIME_SHAPES:
        u, bb, u_lo, h = kernel_inputs(torch, shape, logical, seed=99)
        npts = shape[0] * shape[1]
        for kname, cases in kernel_calls(cs, text, u, bb, u_lo, h,
                                         logical).items():
            label, kern, twin = cases[-1]
            t = (median_ms(torch, kern), median_ms(torch, twin))
            per = STENCIL_COST[kname]
            extra, note = {"device_ms": device_ms(torch, kern, npts)}, ""
            if kname in ("rbgs_resfilter", "ff_update_residual"):
                # and the kernels it fuses
                extra["composition_ms"] = median_ms(torch, cases[-2][2])
                extra["composition_device_ms"] = device_ms(
                    torch, cases[-2][2], npts)
                what = ("per-colour smoother + residual + restriction "
                        "kernels" if kname == "rbgs_resfilter" else
                        "plain pair update + ff_residual kernel")
                note = (f"; {what} {extra['composition_ms'] * 1e3:.1f} us "
                        f"(device {extra['composition_device_ms'] * 1e3:.1f}"
                        " us)")
            if kname == "rbgs_fused":  # and the per-colour oracle
                extra["per_colour_ms"] = median_ms(torch, cases[0][2])
                extra["per_colour_device_ms"] = device_ms(torch, cases[0][2],
                                                          npts)
                note = (f"; per-colour oracle (4 rbgs_color launches and "
                        f"the clone) {extra['per_colour_ms'] * 1e3:.1f} us "
                        f"(device {extra['per_colour_device_ms'] * 1e3:.1f}"
                        " us)")
            oracle = {"jacobi": "per-sweep kernel",
                      "prolong_add": "point kernel"}.get(kname)
            if oracle:  # and the kernel it replaced
                old = next(c[2] for c in cases if c[0] == label + " vs the "
                           + oracle)
                extra["oracle_ms"] = median_ms(torch, old)
                extra["oracle_device_ms"] = device_ms(torch, old, npts)
                note = (f"; the {oracle} {extra['oracle_ms'] * 1e3:.1f} us "
                        f"(device {extra['oracle_device_ms'] * 1e3:.1f} us)")
                if npts > 4_000_000:
                    extra["oracle_flushed_ms"] = flushed_ms(torch, old)
                    note += (f", L2 flushed "
                             f"{extra['oracle_flushed_ms'] * 1e3:.1f} us")
            if npts > 4_000_000 and kname in (
                    "rbgs_fused", "ff_residual", "rbgs_resfilter", "jacobi",
                    "jacobi_sweep", "prolong_add", "prolong_add_point",
                    "ff_update_residual"):
                extra["flushed_ms"] = flushed_ms(torch, kern)
                note += (f"; L2 flushed before each call "
                         f"{extra['flushed_ms'] * 1e3:.1f} us")
            add_time(kname, label, record(
                "x".join(map(str, shape)), t[0], t[1],
                stencil_bytes(kname, shape, logical), per[1] * npts,
                **extra), note)
        del u, bb, u_lo
        torch.cuda.empty_cache()
    # the per-pass ladder at 8448^2, device time per call from graph
    # replays: the down-leg at sweeps 0-3; the smoother at 1, 2 and 4
    # sweeps, fused and as the per-colour oracle
    (shape, logical) = TIME_SHAPES[1]
    u, bb, _, h = kernel_inputs(torch, shape, logical, seed=97)
    npts = shape[0] * shape[1]
    ladder = {}
    for s in DOWNLEG_SWEEPS:
        ladder.setdefault("rbgs_resfilter", {})[s] = device_ms(
            torch, lambda s=s: cs.rbgs_residual_restrict(
                u, bb, 10.0, h, s, logical), npts)
    for s in LADDER_SMOOTHER:
        ladder.setdefault("rbgs_fused", {})[s] = device_ms(
            torch, lambda s=s: cs.red_black_gauss_seidel(
                u, bb, 10.0, h, sweeps=s, logical_shape=logical), npts)
        ladder.setdefault("per-colour", {})[s] = device_ms(
            torch, lambda s=s: cs._rbgs_per_colour(u, bb, 10.0, h, s,
                                                   logical), npts)
    for k, row in ladder.items():
        print(f"[ladder] {k} at {shape[0]}x{shape[1]}, device us per call "
              f"by sweeps: "
              f"{ {s: round(v * 1e3, 1) for s, v in row.items()} }  "
              f"({card})")
    times["rbgs_fused"][-1]["ladder_ms"] = {
        k: ladder[k] for k in ("rbgs_fused", "per-colour")}
    times["rbgs_resfilter"][-1]["ladder_ms"] = {
        "rbgs_resfilter": ladder["rbgs_resfilter"]}
    del u, bb
    torch.cuda.empty_cache()
    # the Jacobi tile and the prolong-add stream at 8192^2 (exact layout)
    # against their oracles and twins, also L2 flushed; the Jacobi ladder,
    # device time per call by sweeps (omega 0.8), fused and per sweep
    n8 = BENCH_N
    u, bb, _, h = kernel_inputs(torch, (n8, n8), None, seed=95)
    e = bb[: n8 // 2, : n8 // 2].contiguous()
    npts = n8 * n8
    jac_paths = {
        "jacobi": lambda s: cs.jacobi(u, bb, 10.0, h, omega=JACOBI_OMEGA,
                                      sweeps=s),
        "jacobi_sweep": lambda s: cs._jacobi_per_sweep(u, bb, 10.0, h,
                                                       JACOBI_OMEGA, s)}
    jac_ladder = {k: {s: device_ms(torch, lambda s=s, f=f: f(s), npts)
                      for s in LADDER_JACOBI} for k, f in jac_paths.items()}
    for k, row in jac_ladder.items():
        print(f"[ladder] {k} at {n8}x{n8}, device us per call by sweeps "
              f"(omega {JACOBI_OMEGA}): "
              f"{ {s: round(v * 1e3, 1) for s, v in row.items()} }  ({card})")
    per = STENCIL_COST["jacobi"]
    t_p = median_ms(torch, lambda: cs.jacobi_plain(u, bb, 10.0, h,
                                                   JACOBI_OMEGA, 2), runs=10)
    for k, f in jac_paths.items():
        t_l2 = flushed_ms(torch, lambda f=f: f(2))
        add_time(k, f"sweeps 2, omega {JACOBI_OMEGA}", record(
            f"{n8}x{n8}", median_ms(torch, lambda f=f: f(2)), t_p,
            per[0] * npts, per[1] * npts, device_ms=jac_ladder[k][2],
            flushed_ms=t_l2, ladder_ms=jac_ladder[k]),
            f"; L2 flushed {t_l2 * 1e3:.1f} us")
    per = STENCIL_COST["prolong_add"]
    t_p = median_ms(torch, lambda: cs.prolong_add_padded_fast_plain(e, u),
                    runs=10)
    for k, f in (("prolong_add", cs.prolong_add_padded_fast),
                 ("prolong_add_point", cs._prolong_add_point)):
        t_l2 = flushed_ms(torch, lambda f=f: f(e, u))
        add_time(k, f"from {tuple(e.shape)}", record(
            f"{n8}x{n8}", median_ms(torch, lambda f=f: f(e, u)), t_p,
            per[0] * npts, per[1] * npts,
            device_ms=device_ms(torch, lambda f=f: f(e, u), npts),
            flushed_ms=t_l2), f"; L2 flushed {t_l2 * 1e3:.1f} us")
    del u, bb, e, jac_paths
    torch.cuda.empty_cache()
    # the 3D kernels at 257^3 and 513^3; the fused smoother also with L2
    # flushed, against the per-colour oracle (4 rbgs3d_color launches and
    # the clone), and its ladder (device time per call by sweeps, fused and
    # per colour); then the 17^3 bottom's 100 sweeps, one resident launch
    # against 200 oracle launches
    for shape, logical in TIME_SHAPES_3D:
        u, bb, h = kernel_inputs_3d(torch, shape, logical, seed=99)
        npts = shape[0] * shape[1] * shape[2]
        for kname, cases in kernel_calls_3d(c3, u, bb, h, logical).items():
            label, kern, twin = cases[-1]
            t = (median_ms(torch, kern, runs=10),
                 median_ms(torch, twin, runs=10))
            per = STENCIL_COST[kname]
            extra, note = {"device_ms": device_ms(torch, kern, npts)}, ""
            if kname in ("residual3d", "apply3d",
                         "apply3d_point", "jacobi3d", "jacobi3d_sweep",
                         "ff_residual3d", "ff_update_residual3d",
                         "restrict_fw3d", "prolong_add3d"):
                extra["flushed_ms"] = flushed_ms(torch, kern)
                note = (f"; L2 flushed before each call "
                        f"{extra['flushed_ms'] * 1e3:.1f} us")
            if kname == "ff_update_residual3d":  # and the kernels it fuses
                comp = cases[-2][2]
                extra["composition_device_ms"] = device_ms(torch, comp, npts)
                extra["composition_flushed_ms"] = flushed_ms(torch, comp)
                note += (f"; plain pair update + ff_residual3d (device) "
                         f"{extra['composition_device_ms'] * 1e3:.1f} us, "
                         f"L2 flushed "
                         f"{extra['composition_flushed_ms'] * 1e3:.1f} us")
            replaced = {"apply3d": "apply3d_point",
                        "jacobi3d": "jacobi3d_sweep"}.get(kname)
            if replaced:  # and the kernel it replaced, on the same call
                point = next(c[2] for c in cases if "vs " in c[0]
                             and (kname != "jacobi3d"
                                  or c[0].startswith(label)))
                extra["point_device_ms"] = device_ms(torch, point, npts)
                extra["point_flushed_ms"] = flushed_ms(torch, point)
                note += (f"; {replaced} (device) "
                         f"{extra['point_device_ms'] * 1e3:.1f} us, L2 "
                         f"flushed {extra['point_flushed_ms'] * 1e3:.1f} us")
            if kname == "jacobi3d" and shape == TIME_SHAPES_3D[0][0]:
                j3_paths = {
                    "jacobi3d": lambda s: c3.jacobi_3d(
                        u, bb, 1.0, h, omega=JACOBI_OMEGA, sweeps=s,
                        logical_shape=logical),
                    "jacobi3d_sweep": lambda s: c3._jacobi3d_per_sweep(
                        u, bb, 1.0, h, JACOBI_OMEGA, s, logical)}
                extra["ladder_ms"] = {
                    path: {s: device_ms(torch, lambda s=s, f=f: f(s), npts)
                           for s in LADDER_JACOBI3D}
                    for path, f in j3_paths.items()}
                for path, row in extra["ladder_ms"].items():
                    print(f"[ladder] {path} at {'x'.join(map(str, shape))}, "
                          f"device us per call by sweeps (omega "
                          f"{JACOBI_OMEGA}): "
                          f"{ {s: round(v * 1e3, 1) for s, v in row.items()} }"
                          f"  ({card})")
            if kname == "rbgs3d_fused":
                paths = {
                    "rbgs3d_fused": lambda s: c3.red_black_gauss_seidel_3d(
                        u, bb, 1.0, h, sweeps=s, logical_shape=logical),
                    "per-colour": lambda s: c3._rbgs3d_per_colour(
                        u, bb, 1.0, h, s, logical)}

                def oracle():
                    return paths["per-colour"](2)

                extra["flushed_ms"] = flushed_ms(torch, kern)
                extra["per_colour_device_ms"] = device_ms(torch, oracle, npts)
                extra["per_colour_flushed_ms"] = flushed_ms(torch, oracle)
                extra["ladder_ms"] = {
                    path: {s: device_ms(torch, lambda s=s, f=f: f(s), npts)
                           for s in LADDER_3D} for path, f in paths.items()}
                note = (f"; L2 flushed before each call "
                        f"{extra['flushed_ms'] * 1e3:.1f} us; per-colour "
                        f"oracle (device) "
                        f"{extra['per_colour_device_ms'] * 1e3:.1f} us, L2 "
                        f"flushed {extra['per_colour_flushed_ms'] * 1e3:.1f}"
                        " us")
                for path, row in extra["ladder_ms"].items():
                    print(f"[ladder] {path} at {'x'.join(map(str, shape))}, "
                          f"device us per call by sweeps: "
                          f"{ {s: round(v * 1e3, 1) for s, v in row.items()} }"
                          f"  ({card})")
            add_time(kname, label, record(
                "x".join(map(str, shape)), t[0], t[1],
                stencil_bytes(kname, shape, logical), per[1] * npts,
                **extra), note)
        del u, bb
        torch.cuda.empty_cache()
    # the fused smoother's 2-sweep call at config 4's coarser z-marching
    # levels, each with its bound (bytes: a few microseconds there)
    for shape in COARSE_LEVELS_3D:
        u, bb, h = kernel_inputs_3d(torch, shape, None, seed=95)
        npts = math.prod(shape)

        def smooth2(u=u, bb=bb, h=h):
            return c3.red_black_gauss_seidel_3d(u, bb, 1.0, h, sweeps=2)

        t = (median_ms(torch, smooth2, runs=10), median_ms(
            torch, lambda u=u, bb=bb, h=h: c3.red_black_gauss_seidel_3d_plain(
                u, bb, 1.0, h, 2), runs=10))
        extra = {"device_ms": device_ms(torch, smooth2, npts),
                 "flushed_ms": flushed_ms(torch, smooth2)}
        add_time("rbgs3d_fused", "sweeps 2", record(
            "x".join(map(str, shape)), t[0], t[1],
            stencil_bytes("rbgs3d_fused", shape, None),
            STENCIL_COST["rbgs3d_fused"][1] * npts, **extra),
            f"; L2 flushed before each call "
            f"{extra['flushed_ms'] * 1e3:.1f} us; z-chunks of "
            f"{c3.rbgs3d_tile(4, shape)[6]} planes")
        del u, bb
    bshape = CONFIG4_BOTTOM
    u, bb, h = kernel_inputs_3d(torch, bshape, None, seed=96)
    npts = bshape[0] * bshape[1] * bshape[2]

    def fused_bottom():
        return c3.red_black_gauss_seidel_3d(u, bb, 1.0, h,
                                            sweeps=BOTTOM_SWEEPS)

    def colour_bottom():
        return c3._rbgs3d_per_colour(u, bb, 1.0, h, BOTTOM_SWEEPS)

    t_k, t_c = median_ms(torch, fused_bottom), median_ms(torch, colour_bottom,
                                                          runs=10)
    t_p = median_ms(torch, lambda: c3.red_black_gauss_seidel_3d_plain(
        u, bb, 1.0, h, BOTTOM_SWEEPS), runs=5)
    d_k = graph_ms(torch, fused_bottom, reps=10, runs=5)
    d_c = graph_ms(torch, colour_bottom, reps=2, runs=5)
    per = STENCIL_COST["rbgs3d_fused"]  # per point for 2 sweeps
    add_time("rbgs3d_fused", f"sweeps {BOTTOM_SWEEPS} (resident)", record(
        f"{'x'.join(map(str, bshape))} (the bottom)", t_k, t_p,
        per[0] * npts, per[1] * npts * BOTTOM_SWEEPS // 2, device_ms=d_k,
        per_colour_ms=t_c, per_colour_device_ms=d_c),
        f"; {2 * BOTTOM_SWEEPS} rbgs3d_color launches {t_c * 1e3:.1f} us "
        f"(device {d_c * 1e3:.1f} us)")

    def jacobi_bottom():
        return c3.jacobi_3d(u, bb, 1.0, h, omega=JACOBI_OMEGA,
                            sweeps=BOTTOM_SWEEPS)

    def sweep_bottom():
        return c3._jacobi3d_per_sweep(u, bb, 1.0, h, JACOBI_OMEGA,
                                      BOTTOM_SWEEPS)

    t_k, t_o = median_ms(torch, jacobi_bottom), median_ms(torch, sweep_bottom,
                                                           runs=10)
    t_p = median_ms(torch, lambda: c3.jacobi_3d_plain(
        u, bb, 1.0, h, JACOBI_OMEGA, BOTTOM_SWEEPS), runs=5)
    d_k = graph_ms(torch, jacobi_bottom, reps=10, runs=5)
    d_o = graph_ms(torch, sweep_bottom, reps=2, runs=5)
    per = STENCIL_COST["jacobi3d"]  # per point for 2 sweeps
    add_time("jacobi3d", f"sweeps {BOTTOM_SWEEPS}, omega {JACOBI_OMEGA} "
             "(resident)", record(
                 f"{'x'.join(map(str, bshape))} (the bottom)", t_k, t_p,
                 per[0] * npts, per[1] * npts * BOTTOM_SWEEPS // 2,
                 device_ms=d_k, point_ms=t_o, point_device_ms=d_o),
             f"; {BOTTOM_SWEEPS} jacobi3d_sweep launches {t_o * 1e3:.1f} us "
             f"(device {d_o * 1e3:.1f} us)")
    del u, bb
    torch.cuda.empty_cache()
    # the sharded smoother's kernel on one 8192-row slab with its 8-row
    # halos (README.md's 8192^2 on one rank): 4 sweeps and the path's 2,
    # against its twin, against 2 x sweeps rbgs_color launches on the same
    # slab (the per-colour oracle, its clone of u included) and against the
    # fused smoother's one launch there (the same sweeps without the row
    # offset, on the same tile); the ladder, sweeps 1-4 from graph replays,
    # against the fused smoother
    ne, m = EXT_TIME_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(98)
    ue, be = (torch.randn(EXT_TIME_SHAPE, generator=gen, device="cuda")
              for _ in range(2))
    lg = SHARD_KW["shape"]
    h_e = 10.0 / (lg[0] - 1)
    ext_paths = {
        "rbgs_fused_ext": lambda s: cs.rbgs_fused_extended(
            ue, be, -8, lg, 10.0, h_e, s),
        "rbgs_fused": lambda s: cs.red_black_gauss_seidel(
            ue, be, 10.0, h_e, sweeps=s)}
    ext_ladder = {k: {s: device_ms(torch, lambda s=s, f=f: f(s), ne * m)
                      for s in (1, 2, 3, 4)} for k, f in ext_paths.items()}
    for k, row in ext_ladder.items():
        print(f"[ladder] {k} at {ne}x{m} (row0 -8 for the slab kernels), "
              f"device us per call by sweeps: "
              f"{ {s: round(v * 1e3, 1) for s, v in row.items()} }  ({card})")
    per = STENCIL_COST["rbgs_fused_ext"]  # per point for 4 sweeps
    for sw in (4, 2):
        t_k = median_ms(torch, lambda sw=sw: cs.rbgs_fused_extended(
            ue, be, -8, lg, 10.0, h_e, sw))
        t_p = median_ms(torch, lambda sw=sw: cs.rbgs_fused_extended_plain(
            ue, be, -8, lg, 10.0, h_e, sw), runs=10)
        t_c = median_ms(torch, lambda sw=sw: cs._rbgs_per_colour(
            ue, be, 10.0, h_e, sw))
        t_f = ext_ladder["rbgs_fused"][sw]
        t_l2 = flushed_ms(torch, lambda sw=sw: cs.rbgs_fused_extended(
            ue, be, -8, lg, 10.0, h_e, sw))
        add_time("rbgs_fused_ext", f"sweeps {sw}", record(
            f"{ne}x{m} ({sw} sweeps, row0 -8)", t_k, t_p, per[0] * ne * m,
            per[1] * ne * m * sw // 4, colour_launches_ms=t_c,
            rbgs_fused_device_ms=t_f, flushed_ms=t_l2,
            device_ms=ext_ladder["rbgs_fused_ext"][sw],
            **({"ladder_ms": ext_ladder} if sw == 4 else {})),
            f"; L2 flushed {t_l2 * 1e3:.1f} us; {2 * sw} rbgs_color launches "
            f"{t_c * 1e3:.1f} us; the fused smoother on the slab "
            f"{t_f * 1e3:.1f} us (device)")
    del ue, be, ext_paths
    torch.cuda.empty_cache()
    # bench.py's measure_ell_spmm: 4 vectors on banded_csr(2**20), against
    # 4 SpMV launches and one cuSPARSE CSR product
    lib = csr_library(torch, banded)
    cols = [X0[:, j].contiguous() for j in range(SPMM_NVEC)]
    t_k = median_ms(torch, lambda: E_b.spmm(X0))
    t_p = median_ms(torch, lambda: cv.ell_spmm_plain(E_b.colsT, E_b.valsT,
                                                     X0), runs=10)
    t_4 = median_ms(torch, lambda: [E_b.spmv(c) for c in cols])
    t_l = median_ms(torch, lambda: lib @ X0)
    nbytes, flops = ell_cost("ell_spmm", E_b, SPMM_NVEC)
    rec = record(f"{SPMM_N} rows x {SPMM_NVEC} vectors (banded_csr, K "
                 f"{E_b.k})", t_k, t_p, nbytes, flops, t_l,
                 device_ms=device_ms(torch, lambda: E_b.spmm(X0), SPMM_N),
                 spmv_calls_ms=t_4,
                 effective_nnz_per_s=E_b.nnz_dense * SPMM_NVEC / (t_k * 1e-3))
    add_time("ell_spmm", f"{SPMM_NVEC} vectors", rec,
             f"; {SPMM_NVEC} spmv launches {t_4 * 1e3:.1f} us; "
             f"{rec['effective_nnz_per_s']:.4g} effective nnz/s "
             "(bench.py's count)")
    del lib, cols, X0
    # the design probes (PERF.md rows 20-21): both harnesses' mains at full
    # size are the probes' path (launches counted); then each kernel per R /
    # block size against its twin, with its bound: device time per call from
    # CUDA-graph replays, since an SpMV probe (~20 us) is shorter than its
    # Python wrapper's launch
    pgm.reset_program_counts()
    (st_out, sp_out), c_pr = run_counted(lambda: (sab.main([]),
                                                  spab.main([])))
    ran = pgm.executed_launches()
    print(f"[probes] launches of the harness run: wrapper calls (eager + "
          f"captured) {({k: c_pr[k] for k in (*PROBES, 'spmv')})}; executed "
          f"on the card (eager + graph replays) "
          f"{({k: ran[k] for k in (*PROBES, 'spmv')})}")
    for label, r, dt in st_out:
        print(f"[probes] stencil_ablation {label} R={r}: {dt * 1e3:.4f} ms "
              f"per apply, {8.0 * n_p * n_p / dt / 1e9:.1f} GB/s effective "
              f"((5+{sab.ITERS})-chain minus 5-chain, each one CUDA graph, "
              f"best of 4)  ({card})")
    for rec in sp_out:
        print(f"[probes] spmv_ablation {rec['variant']}: "
              f"{rec['us_per_spmv']:.3f} us per SpMV, {rec['gb_s']:.1f} GB/s "
              f"of slots (50 chained in one CUDA graph, best of 3)  ({card})")
    missing = [k for k in PROBES if c_pr[k] == 0]
    check(not missing and c_pr["spmv"] > 0,
          f"probes the harnesses did not launch: {missing}")
    npts = n_p * n_p
    for label, mk, rs in sab.VARIANTS:
        kind = mk.__name__[2:]
        for r in rs:
            t_k = graph_ms(torch, lambda mk=mk, r=r: mk(r)(u_p))
            t_p = graph_ms(torch, lambda t=probe_twins[kind, r]: t(u_p),
                           reps=2, runs=5)
            t_l = (graph_ms(torch, lambda: torch.add(u_p, 1.0))
                   if kind == "copy" else None)
            add_time(f"probe_{kind}", f"R={r}", record(
                f"{n_p}x{n_p}, R={r}", t_k, t_p, 8 * npts,
                PROBE_FLOPS[kind] * npts, t_l))
    copy_ms = min(rec["ms"] for rec in times["probe_copy"])
    print(f"[roofline] measured copy (probe_copy, u + 1 at {n_p}^2, best R, "
          f"CUDA-graph replays): {8 * npts / (copy_ms * 1e-3) / 1e12:.3f} TB/s = "
          f"{8 * npts / (copy_ms * 1e-3) / HBM_BYTES_PER_S:.1%} of the "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s datasheet rate  ({card})")
    K_b, n_b2 = E_b.colsT.shape
    x_bytes = {"probe_stream": 0, "probe_staticwin": 4 * 1024,
               "probe_noshuffle": 4 * x_p.shape[0]}
    # orig, the SpMV kernel on the same matrix: the gap to probe_stream is
    # the cost of the gather
    t_orig = graph_ms(torch, lambda: E_b.spmv(x_p[:SPMM_N]))
    for tag, kern, _ in spab.VARIANTS[1:]:
        for br in spab.BLOCK_ROWS:
            t_k = graph_ms(torch, lambda k=kern, br=br: spab.spmv_variant(
                E_b, x_p, k, br))
            t_p = graph_ms(torch, lambda tag=tag: spab._PLAIN[tag](
                E_b.colsT, E_b.valsT, x_p), reps=5)
            add_time(tag, f"block rows {br}", record(
                f"banded_csr({SPMM_N}), K {K_b}, block rows {br}", t_k, t_p,
                8 * K_b * n_b2 + x_bytes[tag] + 4 * n_b2, 2 * K_b * n_b2,
                orig_ms=t_orig), f"; orig (ell_spmv) {t_orig * 1e3:.1f} us")
    del u_p, x_p, E_b
    torch.cuda.empty_cache()

    # the 1025^2 and 8193^2 solves, unfused (U), fused (F) and on the
    # per-colour path (P), in the order U F P P F U U P F: median of 3 each,
    # after one warm run of each
    for tag, group, iters in [
            ("1025^2", (solver, fsolver, psolver, b), res.iterations),
            ("8193^2", (big, big_f, big_p, big_b),
             big_res[0][0].iterations)]:
        su, sf, sp, bvec = group
        fns = {"unfused": lambda su=su, bvec=bvec: su.solve_refined(bvec),
               "fuse_downleg": lambda sf=sf, bvec=bvec: sf.solve_refined(bvec),
               "per-colour": lambda sp=sp, bvec=bvec: sp.solve_refined(bvec)}
        walls = {k: [] for k in fns}
        for k in fns:
            fns[k]()
        for k in ("unfused", "fuse_downleg", "per-colour", "per-colour",
                  "fuse_downleg", "unfused", "unfused", "per-colour",
                  "fuse_downleg"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fns[k]()
            torch.cuda.synchronize()
            walls[k].append(time.perf_counter() - t0)
            check(out.iterations == iters, f"timed {tag} {k} differs")
        for k, w in walls.items():
            print(f"[time] solve_refined {tag} {k}: median wall "
                  f"{statistics.median(w) * 1e3:.2f} ms over 3 "
                  f"({[round(x * 1e3, 2) for x in w]} ms, alternating), "
                  f"{iters} iterations  ({card})")
    # config 4 (A) and 513^3 (C): fused (F) against the per-colour path (P),
    # F P P F F P, median of 3 each, after one warm run of each
    colour3d["C 513^3"] = per_colour3d(GMGSolver(**SCALE3D_KW,
                                                 device="cuda"))
    for tag, ps3 in colour3d.items():
        s3, b3, res3 = paths3d[tag]
        fns = {"fused": lambda s3=s3, b3=b3: s3.solve_refined(b3),
               "per-colour": lambda ps3=ps3, b3=b3: ps3.solve_refined(b3)}
        walls = {k: [] for k in fns}
        for k in fns:
            fns[k]()
        for k in ("fused", "per-colour", "per-colour", "fused", "fused",
                  "per-colour"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fns[k]()
            torch.cuda.synchronize()
            walls[k].append(time.perf_counter() - t0)
            check(out.iterations == res3.iterations, f"timed {tag} {k}")
        for k, w in walls.items():
            print(f"[time] solve_refined 3D {tag} {k}: median wall "
                  f"{statistics.median(w) * 1e3:.2f} ms over 3 "
                  f"({[round(x * 1e3, 2) for x in w]} ms, alternating), "
                  f"{res3.iterations} iterations  ({card})")
        if tag[0] == "A":
            for k, fn in fns.items():
                try:
                    wall, busy, nev, top = profile_run(torch, fn)
                except Exception as exc:  # the trace is a measurement aid
                    print(f"[profile] config 4 {k}: not measured ({exc!r})")
                    continue
                print(f"[profile] config 4 solve_refined {k}: {nev} device "
                      f"ops, device busy {busy * 1e3:.2f} ms = "
                      f"{busy / max(wall, 1e-12):.1%} of the profiled wall "
                      f"{wall * 1e3:.2f} ms  ({card})")
                for kname, (us, cnt) in top[:6]:
                    print(f"[profile]   {us / 1e3:8.3f} ms  {cnt:5d}x  "
                          f"{kname[:90]}")
    del colour3d
    walls_3d = [(f"solve_refined 3D {tag}",
                 lambda s3=s3, b3=b3: s3.solve_refined(b3), res3.iterations)
                for tag, (s3, b3, res3) in paths3d.items() if tag[0] == "B"]
    for tag, fn, iters in [
            ("solve_refined 8193^2 inner_cg=4",
             lambda: big.solve_refined(big_b, inner_cg=4),
             big_res[4][0].iterations)] + walls_3d:
        med, walls, out = median_wall(torch, fn)
        check(out.iterations == iters, f"timed {tag} differs")
        print(f"[time] {tag}: median wall {med * 1e3:.2f} ms over 3 "
              f"({[round(w * 1e3, 2) for w in walls]} ms), {iters} "
              f"iterations  ({card})")
    # the 1025^2 and config 4 Jacobi solves against the per-sweep kernel
    # swapped in, the 8193^2 solve against the point prolong-add swapped in,
    # config 4's inner_cg=4 against the point apply: kernel (K) and oracle
    # (O) in the order K O O K K O, median of 3 each, after one warm run of
    # each; every history equal to the kernel's bit for bit
    for tag, names, solvers, bvec, iters, skw in [
            ("1025^2 jacobi", ("fused", "per-sweep"), (jac, jac_o), b,
             res_jac.iterations, {}),
            ("8193^2", ("stream prolong-add", "point prolong-add"),
             (big, big_pt), big_b, big_res[0][0].iterations, {}),
            ("257^3 jacobi (config 4)", ("march", "per-sweep"),
             (jac3, jac3_o), b_c4, res_j3.iterations, {}),
            ("257^3 inner_cg=4 (config 4)", ("apply march", "point apply"),
             (cg3, cg3_o), b_c4, res_c3.iterations, dict(inner_cg=4))]:
        fns = {k: (lambda s=s, bvec=bvec, skw=skw: s.solve_refined(bvec,
                                                                   **skw))
               for k, s in zip(names, solvers)}
        want = fns[names[0]]().history
        check(np.array_equal(fns[names[1]]().history, want),
              f"timed {tag}: the oracle's history differs")
        walls = {k: [] for k in names}
        for i in (0, 1, 1, 0, 0, 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fns[names[i]]()
            torch.cuda.synchronize()
            walls[names[i]].append(time.perf_counter() - t0)
            check(out.iterations == iters
                  and np.array_equal(out.history, want),
                  f"timed {tag} {names[i]} differs")
        for k, w in walls.items():
            print(f"[time] solve_refined {tag} {k}: median wall "
                  f"{statistics.median(w) * 1e3:.2f} ms over 3 "
                  f"({[round(x * 1e3, 2) for x in w]} ms, alternating), "
                  f"{iters} iterations, histories equal bit for bit  "
                  f"({card})")
    print(f"[time] 1025^2 solve: {main_launches} kernel launches, "
          f"{fused_launches} with fuse_downleg, {colour_launches} on the "
          "per-colour path (wrapper counts)")
    for tag, s in (("unfused", solver), ("fuse_downleg", fsolver),
                   ("per-colour", psolver)):
        try:
            wall, busy, nev, top = profile_run(
                torch, lambda s=s: s.solve_refined(b))
        except Exception as exc:  # the trace is a measurement aid only
            print(f"[profile] 1025^2 {tag}: not measured ({exc!r})")
            continue
        print(f"[profile] 1025^2 solve_refined {tag}: {nev} device ops, "
              f"device busy {busy * 1e3:.2f} ms = "
              f"{busy / max(wall, 1e-12):.1%} of the profiled wall "
              f"{wall * 1e3:.2f} ms  ({card})")
        for kname, (us, cnt) in top[:6]:
            print(f"[profile]   {us / 1e3:8.3f} ms  {cnt:5d}x  {kname[:90]}")
    time_amg(torch, amg_ctx, card, times)
    times["spmv"].extend(samg_times)  # row 19 at the sharded path's blocks
    phases.next(None)
    print(f"[time] chip_smoke total {time.perf_counter() - phases.t_start:.1f}"
          " s")

    def timing(k):
        """The kernel's first timed shape at the top level, the others
        under ``more``."""
        first, *rest = times[k]
        out = {key: first[key] for key in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms")}
        out["ms_at"] = first["at"]
        out.update({key: v for key, v in first.items()
                    if key not in out and key != "at"})
        if rest:
            out["more"] = rest
        return out

    print(card)
    every = {**KERNELS, **PROBES}
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": every[k][1],
         "replaces": every[k][0], "launches": launches[k],
         "max_abs_err": max_err[k], **timing(k),
         **({"also_replaces": ALSO_REPLACES[k]} if k in ALSO_REPLACES
            else {}),
         **({"via": VIA[k]} if k in VIA else {}),
         **({"path": f"none: the reference of {ON_NO_PATH[k]}"}
            if k in ON_NO_PATH else {}),
         **({"launches_executed": ran[k]} if k in PROBES else {})}
        for k in every]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
