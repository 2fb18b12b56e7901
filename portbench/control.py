"""The check's control, and its planted faults, at a cell's own size.

    python3 -m portbench.control --workload iemocap_gdf16.grid16 \\
        --seeds 11 12 13 > control.jsonl

For each seed it runs the reference three times over the cell's checked
steps and evaluation: in f32 (TF32 off), as the control in the nearest
precision below the configuration's (TF32 on), and in f32 with half of
each training batch left out (the mean taken over the rest).  It prints
one JSON line a seed with the check's numbers (``check.numbers``) of the
control and of the fault against the f32 reference; the limits in
``limits/<cell>.json`` are set below the least of these.  A state left
unchanged reads 1 on ``grad`` and ``change`` by their definition and
needs no run.  The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys


def readings(conf: dict, traffic: dict, seed: int, device) -> dict:
    from portbench import check, follow

    ref = follow.run(conf, traffic, seed, device)
    ctl = follow.run(conf, traffic, seed, device, tf32=True)
    half = follow.run(conf, traffic, seed, device, half_batch=True)
    return {"seed": seed,
            "control_tf32": check.numbers(ctl, ref, ref["umasks"]),
            "half_batch": check.numbers(half, ref, ref["umasks"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch

    from portbench.harness import HERE, load_json

    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    with open("BENCHMARK.json") as f:
        cell = {w["name"]: w for w in json.load(f)["workloads"]}[
            args.workload]
    conf = load_json(HERE, "configs", cell["config"])
    traffic = load_json(HERE, "traffic", cell["traffic"])
    for s in args.seeds:
        print(json.dumps(readings(conf, traffic, s, torch.device("cuda"))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
