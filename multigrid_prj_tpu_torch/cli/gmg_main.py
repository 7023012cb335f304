"""GMG command-line driver (port of ``multigrid_prj_tpu/cli/gmg_main.py``).

Reference flags ``-n -a -w -ml -test -smt`` plus ``-cycle -tol -pad
-device``; the outer loop runs to ``TOL = 1e-11`` / 1000 iterations; prints
the ``||``-prefixed timing line and writes ``MGGS4.txt`` and ``x.mtx``.

The device is the card (``-device cuda``, the default) unless ``-device
cpu`` asks for the CPU; without a card and without ``-device cpu`` the CLI
fails and says so.  Auto dtype is f64 on the CPU and f32 on CUDA,
where the tolerance is raised to at least 1e-6.  ``-smt 1`` runs the Jacobi
smoother; ``-smt 2`` runs BiCGSTAB on the plain operator apply, preconditioned
by one multigrid step, exactly as the JAX CLI does (which also fails with
``-pad``: the preconditioner gets logical-shape vectors).

Usage: ``python -m multigrid_prj_tpu_torch.cli.gmg_main -n 385 -ml 4 -test 1``
"""

from __future__ import annotations

import sys
import time

import torch

NO_CARD = ("Error: no CUDA device found; the solver runs on the card unless "
           "asked for the CPU: run with -device cpu")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    from multigrid_prj_tpu_torch.gmg import GMGSolver
    from multigrid_prj_tpu_torch.models.poisson import assemble_rhs
    from multigrid_prj_tpu_torch.ops.krylov import bicgstab
    from multigrid_prj_tpu_torch.ops.stencil import poisson_apply
    from multigrid_prj_tpu_torch.utils.config import parse_gmg_args
    from multigrid_prj_tpu_torch.utils.io import save_history, save_vector

    cfg = parse_gmg_args(argv)
    device = cfg.device
    if device == "cuda" and not torch.cuda.is_available():
        print(NO_CARD)
        return 1
    dtype = cfg.dtype
    if dtype == "auto":
        dtype = "float64" if device == "cpu" else "float32"
    tdtype = getattr(torch, dtype)

    t0 = time.perf_counter()
    tol = cfg.tol if dtype == "float64" else max(cfg.tol, 1e-6)
    solver = GMGSolver(
        shape=(cfg.n, cfg.n),
        length=cfg.width,
        alpha=cfg.alpha,
        num_levels=cfg.levels,
        smoother="jacobi" if cfg.smoother == 1 else "gs",
        cycle=cfg.cycle,
        tol=tol,
        maxit=cfg.maxit,
        pad_align=cfg.pad or None,
        device=device,
    )
    if solver.levels[0].padded_shape is not None:
        print(f"Aligned layout: logical {solver.levels[0].shape} in "
              f"padded {solver.levels[0].padded_shape}")
    b = assemble_rhs(solver.levels[0], cfg.width, test=cfg.test,
                     dtype=tdtype, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    print(f"Initialization time: {t1 - t0} seconds")

    t0 = time.perf_counter()
    if cfg.smoother == 2:
        print("BiCGSTAB iters")
        h0 = solver.levels[0].h
        res = bicgstab(lambda x: poisson_apply(x, cfg.alpha, h0), b, tol=tol,
                       maxit=cfg.maxit,
                       M=lambda r: solver.step(torch.zeros_like(r), r))
        x, hist = res.x, [res.rel_residual]
        iters, converged = res.iterations, res.converged
    else:
        print("GS iters" if cfg.smoother == 0 else "Jacobi iters")
        out = solver.solve(b)
        x, hist = out.u, out.history
        iters, converged = out.iterations, out.converged
    u = x.cpu().numpy()  # waits for the device
    t1 = time.perf_counter()

    print(f"||Solving elapsed time: {t1 - t0} sec<br>")
    print(f"Tol: {tol}<br>")
    print(f"Max iter: {cfg.maxit}<br>")
    if not converged:
        print(f"Warning: not converged after {iters} iterations "
              f"(final rel. residual {float(hist[-1]):.3e})")

    save_history("MGGS4.txt", hist)
    save_vector("x.mtx", u.reshape(-1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
