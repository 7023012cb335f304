"""AMG command-line interface (port of ``multigrid_prj_tpu/cli/amg_main.py``:
the same flags and outputs).

Reproduces the reference AMG executable's end-to-end flow
(``AMG/src/main.cpp``): import a gmsh mesh, assemble the P1 system with
Dirichlet lifting, run AMG, export ``output.vtu`` — but with a real CLI
(the reference hard-codes everything, ``AMG/README.md:41``) and a proper
V-cycle iteration to tolerance in place of the reference's single sawtooth
pass (available via ``--reference-pass``).

The device is the card (``-device cuda``, the default) unless ``-device
cpu`` asks for the CPU; without a card and without ``-device cpu`` the CLI
fails and says so.  ``-precision auto`` is f64 on the CPU and ff32 (f32
cycles, float-float outer residuals) on CUDA.

Usage:
  python -m multigrid_prj_tpu_torch.cli.amg_main -mesh mesh1.msh -levels 5
  python -m multigrid_prj_tpu_torch.cli.amg_main -matrix system.mtx -rhs b.mtx

The second form skips FEM assembly and runs AMG directly on an imported
MatrixMarket (or reference-triplet) system — BASELINE config 3's
"AMG on imported MatrixMarket system".
"""

from __future__ import annotations

import argparse
import sys
import time


def _host(x):
    """A solution (tensor on any device, or numpy) as a numpy array."""
    return x.cpu().numpy() if hasattr(x, "cpu") else x


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="amg_main", description=__doc__)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("-mesh", help="gmsh 4.1 ASCII .msh file")
    src.add_argument("-matrix",
                     help="pre-assembled system: MatrixMarket .mtx "
                          "(coordinate/array, general/symmetric) or the "
                          "reference's 'rows cols nnz' triplet text "
                          "(BASELINE config 3: AMG on an imported "
                          "MatrixMarket system)")
    p.add_argument("-rhs", default=None,
                   help="with -matrix: right-hand side as a vector file "
                        "(reference x.mtx layout: n then one value/line) or "
                        "MatrixMarket array; default: b = A @ ones")
    p.add_argument("-levels", type=int, default=5,
                   help="max AMG levels (reference: 5, AMG/src/main.cpp:126)")
    p.add_argument("-order", type=int, choices=(1, 2, 3), default=1,
                   help="FE polynomial degree: 1 = reference-parity P1; "
                        "2/3 = quadratic/cubic elements (complete the "
                        "reference's unimplemented QuadraticFE/ThirdOrderFE, "
                        "FEM.hpp:261-327)")
    p.add_argument("-theta", type=float, default=0.2,
                   help="strength threshold (reference EPSILON, AMG.hpp:21)")
    p.add_argument("-coarsening", choices=("pmis", "greedy"), default="pmis")
    p.add_argument("-smoother",
                   choices=("auto", "mcgs", "jacobi", "chebyshev"),
                   default="auto",
                   help="auto = multicolor GS on CPU, Chebyshev on CUDA "
                        "(the SpMV-based smoother rides the CUDA kernel)")
    p.add_argument("-hist", default="amg_history.txt",
                   help="residual-history artifact (MGGS4.txt layout); "
                        "'none' to skip")
    p.add_argument("-metrics", default=None,
                   help="write per-solve SolveMetrics JSON to this path")
    p.add_argument("-accel", choices=("none", "pcg"), default="none",
                   help="Krylov acceleration: AMG-preconditioned CG")
    p.add_argument("-tol", type=float, default=1e-10)
    p.add_argument("-maxit", type=int, default=100)
    p.add_argument("-precision", choices=("auto", "f64", "f32", "ff32"),
                   default="auto",
                   help="auto = f64 on the CPU, ff32 iterative refinement "
                        "on CUDA; f32 = plain single precision (residual "
                        "floor ~eps_f32 * kappa)")
    p.add_argument("-device", choices=("cuda", "cpu"), default="cuda",
                   help="where the solver runs: the card unless asked for "
                        "the CPU")
    p.add_argument("-o", default="output.vtu")
    p.add_argument("--reference-pass", action="store_true",
                   help="run ONE reference-style sawtooth pass (10/200/10 GS "
                        "solution-restriction scheme) instead of V-cycles")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from multigrid_prj_tpu_torch.amg import AMGSolver
    from multigrid_prj_tpu_torch.cli.gmg_main import NO_CARD
    from multigrid_prj_tpu_torch.models.fem import (
        assemble_p1,
        assemble_p2,
        assemble_p3,
        export_vtu,
        export_vtu_p2,
        export_vtu_p3,
        p2_mesh,
        p3_mesh,
        parse_msh,
    )

    device = args.device
    if device == "cuda" and not torch.cuda.is_available():
        print(NO_CARD)
        return 1
    use_f64 = args.precision == "f64" or (args.precision == "auto"
                                          and device == "cpu")
    t0 = time.perf_counter()
    mesh = None
    if args.matrix is not None:
        from multigrid_prj_tpu_torch.ops.sparse import HostCSR
        from multigrid_prj_tpu_torch.utils.io import (
            load_matrix_coo,
            load_vector,
        )

        try:
            rows, cols, vals, shape = load_matrix_coo(args.matrix)
        except (OSError, ValueError) as e:
            print(f"Error: cannot read matrix {args.matrix!r}: {e}")
            return 1
        if shape[0] != shape[1]:
            print(f"Error: system matrix must be square, got {shape}")
            return 1
        A = HostCSR.from_coo(rows, cols, vals, shape)
        if args.rhs is not None:
            try:
                try:
                    rhs = load_vector(args.rhs)
                except (OSError, ValueError):
                    r2, c2, v2, s2 = load_matrix_coo(args.rhs)
                    rhs = np.zeros(s2[0] * s2[1])
                    # accumulate duplicate triplets (COO semantics, matching
                    # HostCSR.from_coo) instead of last-write-wins
                    np.add.at(rhs, r2 * s2[1] + c2, v2)
            except (OSError, ValueError) as e:
                print(f"Error: cannot read rhs {args.rhs!r}: {e}")
                return 1
            if rhs.size != shape[0]:
                print(f"Error: rhs has {rhs.size} entries, matrix has "
                      f"{shape[0]} rows")
                return 1
        else:
            rhs = A.spmv(np.ones(shape[0]))
        print(f"Matrix imported! {A.shape[0]} dofs, {A.nnz} non zero "
              "elements.")
    else:
        try:
            mesh = parse_msh(args.mesh)
        except (OSError, ValueError) as e:
            print(f"Error: cannot read mesh {args.mesh!r}: {e}")
            return 1
        print(f"Mesh imported! There are {mesh.n_nodes} nodes and "
              f"{mesh.n_elements} elements.")
    if mesh is None:
        pass
    elif args.order == 2:
        hmesh = p2_mesh(mesh)
        print(f"P2 dofs: {hmesh.n_dofs} ({hmesh.n_dofs - mesh.n_nodes} edge "
              "midpoints)")
        A, rhs = assemble_p2(hmesh)
    elif args.order == 3:
        hmesh = p3_mesh(mesh)
        print(f"P3 dofs: {hmesh.n_dofs} "
              f"({hmesh.n_dofs - mesh.n_nodes - mesh.n_elements} edge "
              f"third-points, {mesh.n_elements} barycenters)")
        A, rhs = assemble_p3(hmesh)
    elif mesh is not None:
        A, rhs = assemble_p1(mesh)
    if mesh is not None:
        print(f"Matrix created succesfully! {A.shape[0]} dofs, "
              f"{A.nnz} non zero elements.")

    solver = AMGSolver(
        A, num_levels=args.levels, theta=args.theta,
        coarsening=args.coarsening, smoother=args.smoother, rhs=rhs,
        dtype=torch.float64 if use_f64 else torch.float32, device=device,
    )
    print(f"AMG setup: levels {solver.level_sizes}, "
          f"operator complexity {solver.operator_complexity:.2f}")
    t1 = time.perf_counter()
    print(f"Initialization time: {t1 - t0:.3f} seconds")

    use_ff32 = args.precision == "ff32" or (
        args.precision == "auto" and not use_f64
    )
    if (args.precision == "f32" and args.tol < 1e-5
            and not args.reference_pass):
        print("Warning: tol below the plain-f32 residual floor "
              "(~eps_f32 * kappa); consider -precision ff32")

    t0 = time.perf_counter()
    result = None
    if args.reference_pass:
        x = solver.reference_sawtooth_pass(np.zeros(A.shape[0]))
        print(f"Residual norm after reference pass: "
              f"{solver.residual_norm(x, rhs):.6e}")
    elif use_ff32 and args.accel == "none":
        result = solver.solve_refined(rhs, tol=args.tol, maxit=args.maxit)
        x, iters, rel = result
        print(f"ff32-refined V-cycle iterations: {iters}, "
              f"relative residual {rel:.3e}")
        if rel > args.tol:
            print("Warning: not converged")
    elif args.accel == "pcg":
        result = solver.solve_pcg(rhs, tol=args.tol, maxit=args.maxit)
        x, iters, rel = result
        print(f"AMG-PCG iterations: {iters}, relative residual {rel:.3e}")
        if rel > args.tol:
            print("Warning: not converged")
    else:
        result = solver.solve(rhs, tol=args.tol, maxit=args.maxit)
        x, iters, rel = result
        print(f"V-cycle iterations: {iters}, relative residual {rel:.3e}")
        if rel > args.tol:
            print("Warning: not converged")
    t1 = time.perf_counter()
    print(f"||Solving elapsed time: {t1 - t0:.3f} sec<br>")

    if result is not None:
        from multigrid_prj_tpu_torch.utils.metrics import SolveMetrics

        m = SolveMetrics(history=result.history, wall_time_s=t1 - t0,
                         nnz=A.nnz, cycles=result.iterations,
                         extra={"levels": solver.level_sizes,
                                "smoother": solver.smoother_name})
        print(f"Convergence factor: {m.convergence_factor:.4f}")
        if args.hist != "none":
            from multigrid_prj_tpu_torch.utils.io import save_history

            save_history(args.hist, result.history)
        if args.metrics:
            m.write_json(args.metrics)

    if mesh is None:
        # no geometry to export — write the solution vector in the
        # reference's x.mtx layout instead
        from multigrid_prj_tpu_torch.utils.io import save_vector

        out = args.o if args.o != "output.vtu" else "x.mtx"
        save_vector(out, _host(x))
        print(f"Solution correctly saved in {out}")
        return 0
    if args.order == 2:
        export_vtu_p2(args.o, hmesh, _host(x))
    elif args.order == 3:
        export_vtu_p3(args.o, hmesh, _host(x))
    else:
        export_vtu(args.o, mesh, _host(x))
    print(f"Solution correctly saved in {args.o}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
