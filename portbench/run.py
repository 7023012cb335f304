"""Run one benchmark cell once on the card and print one JSON line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Untraced, the line's metrics are the cell's end-to-end metrics; traced,
its per-layer metrics (``BENCHMARK.json``).  The numbers that decide
``correct`` are printed last on standard error, each beside its limit, and
last in the line under ``checks``.  A run without a CUDA card, or with
fewer cards than the cell asks for, prints no result and exits 2; one that
finds JAX or the JAX package loaded once its window has closed exits 3.
"""

import time

T_START = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness, registry
    from portbench import trace as tracing

    bench = registry.benchmark()
    entry = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    cell = registry.cell(args.workload)
    if (cell["config_name"], cell["traffic_name"]) != (entry["config"],
                                                       entry["traffic"]):
        print(f"workloads/{args.workload}.json disagrees with "
              f"BENCHMARK.json on its config or traffic", file=sys.stderr)
        return 2
    chips = int(entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              ": no result", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    run, checks = harness.run_cell(cell, args.seed, args.seconds,
                                   bool(args.trace), device, T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package are loaded: {found}",
              file=sys.stderr)
        return 3
    names = registry.metrics_of(bench, args.workload, bool(args.trace))
    out = {"correct": harness.passed(checks),
           "attempted": run.attempted, "failed": run.failed,
           "metrics": harness.read_metrics(run, names),
           "device": {"platform": "gpu",
                      "kind": torch.cuda.get_device_name(device),
                      "count": chips,
                      "memory_peak_bytes": run.memory_peak_bytes}}
    if run.trace is not None:
        out["device"].update(busy_s=run.trace.busy_s,
                             window_s=run.trace.window_s)
        out["breakdown"] = tracing.breakdown(run.trace)
    out["checks"] = {name: {"value": _finite(value), "limit": limit}
                     for name, value, limit in checks}
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out, allow_nan=False))
    return 0


def _finite(value):
    """``value``, or ``None`` for a NaN or an infinity (not JSON)."""
    if value is None or value != value or abs(value) == float("inf"):
        return None
    return value


if __name__ == "__main__":
    sys.exit(main())
