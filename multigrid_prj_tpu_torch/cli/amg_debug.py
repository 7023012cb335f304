"""AMG debug harness (port of ``multigrid_prj_tpu/cli/amg_debug.py``) -- the
standalone diagnostic driver the reference ships as its second binary
(``AMG/debugtest.cpp``).

Step by step, as the JAX harness, printing the same lines in the same
order:

* mesh import + P1 assembly;
* an N-level AMG setup exercised by hand with per-level diagnostics:
  strength graph size, C/F split counts, prolongation shape, Galerkin
  coarse-operator size (host NumPy, the same functions as ``AMGSolver``);
* the cross-level composition check: the restricted RHS chain
  ``P_l^T ... P_0^T b`` matches restricting in one shot through the
  composed prolongation ``(P_0 P_1 ... P_l)^T b``;
* coarse-system smoothing: ``-sweeps`` multicolour Gauss-Seidel sweeps
  (``amg.mc_gs_sweep``) on the coarsest system, on the device, with the
  residual printed before and after;
* VTU export of the smoothed-then-interpolated solution.

The device is the card (``-device cuda``, the default) unless ``-device
cpu`` asks for the CPU; without a card and without ``-device cpu`` the CLI
fails and says so.  The coarse system is f64 on the CPU and f32 on the
card.  Its one-level ``AMGSolver`` takes ``smoother="mcgs"``, the JAX
CLI's CPU default, so that it carries the colour blocks the sweeps walk
(the JAX CLI's TPU default, Chebyshev, builds none, and its sweeps there
change nothing).  The sweeps are a plain loop of ``mc_gs_sweep`` calls,
where the JAX CLI jits one sweep.

Usage:
  python -m multigrid_prj_tpu_torch.cli.amg_debug -mesh mesh1.msh -levels 2 -sweeps 5000
"""

from __future__ import annotations

import argparse
import sys


def coarse_smooth(level, x, b, sweeps: int):
    """``sweeps`` multicolour Gauss-Seidel sweeps of ``A x = b`` on one
    device level (the harness's coarse smoothing)."""
    from multigrid_prj_tpu_torch.amg import mc_gs_sweep

    for _ in range(sweeps):
        x = mc_gs_sweep(level, x, b)
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="amg_debug", description=__doc__)
    ap.add_argument("-mesh", required=True)
    ap.add_argument("-levels", type=int, default=2,
                    help="levels to set up (reference harness: 2)")
    ap.add_argument("-sweeps", type=int, default=5000,
                    help="coarse GS sweeps (reference: 5000)")
    ap.add_argument("-theta", type=float, default=0.2)
    ap.add_argument("-o", default="debug_output.vtu")
    ap.add_argument("-device", choices=("cuda", "cpu"), default="cuda",
                    help="where the coarse smoothing runs (default: the "
                         "card; -device cpu for the CPU)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from multigrid_prj_tpu_torch.amg import (
        AMGSolver,
        build_prolongation,
        coarsen_greedy,
        strength_mask,
    )
    from multigrid_prj_tpu_torch.cli.gmg_main import NO_CARD
    from multigrid_prj_tpu_torch.models.fem import (
        assemble_p1,
        export_vtu,
        parse_msh,
    )
    from multigrid_prj_tpu_torch.ops.sparse import rap, to_device

    if args.device == "cuda" and not torch.cuda.is_available():
        print(NO_CARD)
        return 1

    mesh = parse_msh(args.mesh)
    print(f"Mesh imported! {mesh.n_nodes} nodes, {mesh.n_elements} elements")
    A, rhs = assemble_p1(mesh)
    print(f"Assembled: {A.shape[0]} dofs, {A.nnz} nnz")

    # manual setup loop with diagnostics (debugtest.cpp:155-199)
    mats, Ps, rhss = [A], [], [np.asarray(rhs)]
    cur = A
    for l in range(args.levels - 1):
        s = strength_mask(cur, args.theta)
        labels = coarsen_greedy(cur, args.theta, seed=0)
        nc = int(labels.sum())
        print(f"level {l}: n={cur.shape[0]} nnz={cur.nnz} "
              f"strong={int(s.sum())} coarse={nc} fine={cur.shape[0] - nc}")
        P = build_prolongation(cur, labels, args.theta)
        cur = rap(P, cur)
        Ps.append(P)
        mats.append(cur)
        rhss.append(P.transpose().spmv(rhss[-1]))
        print(f"  -> P {P.shape}, coarse operator n={cur.shape[0]} "
              f"nnz={cur.nnz}")

    # cross-level composition invariant (debugtest.cpp:167-174): chained
    # P^T restriction == composed one-shot
    if Ps:
        comp = Ps[0]
        for P in Ps[1:]:
            comp = comp.matmul(P)
        one_shot = comp.transpose().spmv(rhss[0])
        err = np.abs(one_shot - rhss[-1]).max()
        denom = max(1.0, np.abs(rhss[-1]).max())
        ok = err / denom < 1e-12
        print(f"cross-level composition check: max diff {err:.3e} "
              f"-> {'PASSED' if ok else 'FAILED'}")
        if not ok:
            return 1

    # coarse smoothing with residual before/after (debugtest.cpp:229-246)
    Ac, bc = mats[-1], rhss[-1]
    solver = AMGSolver(Ac, num_levels=1, smoother="mcgs", use_pallas=False,
                       reorder="none", device=args.device)
    x = np.zeros(Ac.shape[0])
    r0 = solver.residual_norm(x, bc)
    print(f"coarse residual before: {r0:.6e}")
    xt = coarse_smooth(solver.levels[0],
                       to_device(x, solver.dtype, solver.device),
                       to_device(bc, solver.dtype, solver.device),
                       args.sweeps)
    r1 = solver.residual_norm(xt, bc)
    print(f"coarse residual after {args.sweeps} GS sweeps: {r1:.6e} "
          f"(reduction {r1 / max(r0, 1e-300):.3e})")

    # interpolate back to the fine level and export (debugtest.cpp epilogue)
    xf = xt.cpu().numpy().astype(np.float64)
    for P in reversed(Ps):
        xf = P.spmv(xf)
    export_vtu(args.o, mesh, xf)
    print(f"Debug solution saved in {args.o}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
