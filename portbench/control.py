"""Readings that set the limit of ``u_rel_err``, at a cell's own size.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 3] [--device cuda]

For each seed it makes the cell's pool and compares ``sample`` of its
right-hand sides, as a run does, for the program's timed entry (the sound
reading) and, on the first ``--control-seeds`` seeds, for the controls
(each the largest ``||u - u*|| / ||u*||`` of the sample, with its
iterations and last residual):

* ``program-f32``: the program's own lower-precision path,
  ``GMGSolver.solve``, whose outer residual is plain float32 and not
  float-float;
* ``reference-f32`` / ``reference-bf16``: the plain reference put in the
  program's place, its residual and cycle in float32 / bfloat16.

One JSON line per seed and entry goes to standard output.  The benchmark's
runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

CONTROLS = ("program-f32", "reference-f32", "reference-bf16")


def readings(cell: dict, seed: int, device, controls: bool):
    """``{name: {"u_rel_err", "iterations", "residual"}}`` for the
    program's entry and, with ``controls``, each control: the largest
    error, iterations and residual over the first ``sample`` right-hand
    sides of the seed's pool."""
    import torch

    from portbench import registry
    from portbench import traffic as traffic_gen

    config = cell["config"]
    kw = config["solver"]
    family = registry.load_module("solvers", config["family"])
    problem = registry.load_module("problems", config["problem"])
    reference = registry.load_module("reference", config["reference"])
    pool = traffic_gen.make_pool(problem, kw["shape"], kw["length"],
                                 cell["traffic"], seed, device)
    solver = family.build(config, device)
    names = ("program",) + (CONTROLS if controls else ())
    out = {name: {"u_rel_err": 0.0, "iterations": 0, "residual": 0.0}
           for name in names}
    for b in pool[:int(cell["sample"])]:
        exact = reference.solve(b, kw["alpha"], kw["length"])
        for name in names:
            if name == "program":
                ans = family.solve(solver, cell["entry"], b)
                u, its, res = ans.u, ans.iterations, ans.residual
            elif name == "program-f32":
                ans = family.solve(solver, "solve", b)
                u, its, res = ans.u, ans.iterations, ans.residual
            else:
                dtype = (torch.float32 if name == "reference-f32"
                         else torch.bfloat16)
                u, its, res = reference.defect_correction(
                    b, kw["alpha"], kw["length"], dtype, float(kw["tol"]),
                    int(kw["maxit"]))
            err = float(torch.linalg.vector_norm(u.to(exact.dtype) - exact)
                        / torch.linalg.vector_norm(exact))
            r = out[name]
            r["u_rel_err"] = err if err != err else max(r["u_rel_err"], err)
            r["iterations"] = max(r["iterations"], int(its))
            r["residual"] = max(r["residual"], float(res))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from portbench import registry

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = registry.cell(args.workload)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = readings(cell, seed, args.device, i < args.control_seeds)
        for name, r in out.items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "entry": name, **r}), flush=True)
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
