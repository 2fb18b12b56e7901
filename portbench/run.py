"""One run of one benchmark cell on the card; prints the result as the last
line of standard output.

    python3 -m portbench.run --workload iemocap_gdf16.grid16 --seed 7 \\
        --seconds 10 --trace 0

Run from the root of a checkout that holds ``BENCHMARK.json``.  It exits
with code 2, printing no result, where no card is present (or fewer than
the cell asks for), and with another code than 0 where the program cannot
be loaded or the run fails.  ``--trace 1`` reports the cell's per-layer
metrics and the traced sub-window's breakdown in place of its end-to-end
metrics.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    with open("BENCHMARK.json") as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    cell = cells[args.workload]

    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    per_layer = [(m["name"], m["unit"]) for m in bench["per_layer"]
                 if args.workload in m.get("workloads", [args.workload])]
    from portbench.harness import run_cell

    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   per_layer=per_layer, t_start=T_START)
    checks = out["checks"]
    for name, c in checks.items():
        print(f"{name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
