"""Visualization CLI (port of ``multigrid_prj_tpu/cli/viz_main.py``) -- the
reference's notebook/pyvista drivers as a command.

``--solution`` (heatmap + 3D surface of ``x.mtx``), ``--history`` (semilog
``MGGS4.txt``), ``--vtu`` (FEM field render of ``output.vtu``) and
``--gif`` (a small GMG solve whose sawtooth-cycle stages are animated),
with the JAX CLI's flags, files, messages and exit codes.

``-device`` says where the ``--gif`` solve runs: the card (``cuda``, the
default) unless ``-device cpu`` asks for the CPU; without a card and
without ``-device cpu`` a ``--gif`` run fails and says so.  The solve is
f32, as the JAX CLI's (its ``assemble_rhs`` default).  The drawings are
made on the host with matplotlib.

Usage:
  python -m multigrid_prj_tpu_torch.cli.viz_main --solution x.mtx --history MGGS4.txt
  python -m multigrid_prj_tpu_torch.cli.viz_main --vtu output.vtu
  python -m multigrid_prj_tpu_torch.cli.viz_main --gif -n 65 -ml 4 -test 0
"""

from __future__ import annotations

import argparse
import math
import os
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="viz_main")
    ap.add_argument("--solution", help="x.mtx vector file (square grid)")
    ap.add_argument("--history", help="MGGS4.txt residual history file")
    ap.add_argument("--vtu", help="output.vtu FEM solution")
    ap.add_argument("--gif", action="store_true",
                    help="run a small GMG solve and animate the cycle stages")
    ap.add_argument("-n", type=int, default=65)
    ap.add_argument("-ml", type=int, default=4)
    ap.add_argument("-test", type=int, default=0)
    ap.add_argument("-w", type=float, default=10.0)
    ap.add_argument("--out", default=".", help="output directory")
    ap.add_argument("-device", choices=("cuda", "cpu"), default="cuda",
                    help="where the --gif solve runs (default: the card; "
                         "-device cpu for the CPU)")
    args = ap.parse_args(argv)

    import torch

    from multigrid_prj_tpu_torch.cli.gmg_main import NO_CARD

    if args.gif and args.device == "cuda" and not torch.cuda.is_available():
        print(NO_CARD)
        return 1
    os.makedirs(args.out, exist_ok=True)
    made = []

    from multigrid_prj_tpu_torch.viz.plots import (
        make_gif,
        plot_convergence,
        plot_fem_solution,
        plot_solution,
        record_cycle_stages,
    )

    if args.solution:
        from multigrid_prj_tpu_torch.utils.io import load_vector

        v = load_vector(args.solution)
        n = int(math.isqrt(v.size))
        if n * n != v.size:
            print(f"Error: {args.solution} has {v.size} values, not a square grid")
            return 1
        made.append(plot_solution(v.reshape(n, n), args.w,
                                  os.path.join(args.out, "solution.png")))

    if args.history:
        from multigrid_prj_tpu_torch.utils.io import load_vector

        made.append(plot_convergence(load_vector(args.history),
                                     os.path.join(args.out, "convergence.png")))

    if args.vtu:
        import xml.etree.ElementTree as ET

        root = ET.parse(args.vtu).getroot()
        pts = np.fromstring(
            root.find(".//Points/DataArray").text.replace("\n", " "), sep=" "
        ).reshape(-1, 3)[:, :2]
        conn = np.fromstring(
            root.find(".//Cells/DataArray[@Name='connectivity']").text
            .replace("\n", " "), sep=" ", dtype=int,
        ).reshape(-1, 3)
        u = np.fromstring(
            root.find(".//PointData/DataArray").text.replace("\n", " "), sep=" "
        )
        made.append(plot_fem_solution(pts, conn, u,
                                      os.path.join(args.out, "fem_solution.png")))

    if args.gif:
        from multigrid_prj_tpu_torch.gmg import GMGSolver
        from multigrid_prj_tpu_torch.models.poisson import assemble_rhs

        solver = GMGSolver(shape=(args.n, args.n), length=args.w,
                           num_levels=args.ml, device=args.device)
        b = assemble_rhs(solver.levels[0], args.w, test=args.test,
                         dtype=torch.float32, device=args.device)
        frames = record_cycle_stages(solver, b, iterations=2)
        made.append(make_gif(frames, os.path.join(args.out, "cycle.gif"),
                             length=args.w))
        made.append(make_gif(frames, os.path.join(args.out, "cycle3d.gif"),
                             length=args.w, three_d=True))

    if not made:
        print("nothing to do: pass --solution/--history/--vtu/--gif")
        return 1
    for p in made:
        print(f"wrote {p}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
