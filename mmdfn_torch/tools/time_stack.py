"""Times kernels B (training mode: dropout, residual slabs) and D alone at
the flagship's training shapes: one configuration, B = 32 dialogues of 240
nodes (3 modalities x 80 turns), H = 100, 16 layers, the reason-LSTM, rate
0.4.  Run it on a card, once per tree, to set two versions of the kernels
side by side in one machine (one process a tree, since each imports its
own ``mmdfn_torch``):

    python mmdfn_torch/tools/time_stack.py --root . --label change
    python mmdfn_torch/tools/time_stack.py --root /path/to/parent --label parent

``--mode`` names the numerics modes to time, comma-separated or ``all``:
``f32`` (the default), ``bf16`` (``--tpu_fast``'s fused-kernel numerics,
three bf16 residual slabs) and ``bf16_scan`` (JAX's bf16 layer scan,
``gcn_compute_dtype='bfloat16'``; the LSTM's two biases apart); each on
the same operands, one after the other in this process.  A tree whose
wrappers take ``bf16=`` (no ``mode``) times ``bf16`` through it; one
that has neither times ``f32`` only.  It prints one JSON line: the
label, the card's name and power limit, and each mode's kernels' stream
time per call (CUDA events, ``--reps`` chained calls after one
warm-up)."""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys

MODES = ("f32", "bf16", "bf16_scan")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".",
                    help="the checkout whose mmdfn_torch is timed")
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--mode", default="f32",
                    help="comma-separated of f32, bf16, bf16_scan, or all")
    args = ap.parse_args()
    modes = MODES if args.mode == "all" else tuple(args.mode.split(","))
    if not set(modes) <= set(MODES):
        ap.error(f"--mode {args.mode}: each one of {MODES}")
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from mmdfn_torch.device import resolve_device
    from mmdfn_torch.ops import gcnii_stack_bwd, gcnii_stack_fwd
    from mmdfn_torch.ops.gcnii import RESIDUALS

    dev = resolve_device("cuda")
    B, N, H, nl = 32, 240, 100, 16
    g = torch.Generator().manual_seed(0)
    rnd = lambda *s, scale=1.0: (torch.randn(*s, generator=g)
                                 * scale).to(dev)
    adj = (torch.rand(B, N, N, generator=g) / N).to(dev)
    h, h0 = rnd(B, N, H), rnd(B, N, H)
    W = rnd(nl, 2 * H, H, scale=0.1)
    theta = (torch.rand(nl, generator=g) * 0.5).to(dev)
    ih, hh = rnd(H, 4 * H, scale=0.1), rnd(H, 4 * H, scale=0.1)
    lb = rnd(2, 4 * H, scale=0.1)
    seed = torch.tensor([2021], dtype=torch.int64, device=dev)
    dh = rnd(B, N, H)
    takes = inspect.signature(gcnii_stack_fwd).parameters

    def calls(mode):
        """(forward, backward) of one mode, as the tree's wrappers take it."""
        opts = dict(alpha=0.2, reason=True, rate=0.4, seed=seed)
        b = lb if mode == "bf16_scan" else lb[0] + lb[1]
        if mode == "f32":
            res = [torch.empty(B, nl, N, H, device=dev) for _ in RESIDUALS]
        else:
            res = [torch.empty(B, nl, N, H, device=dev, dtype=torch.bfloat16)
                   for _ in RESIDUALS[:3]]
            if "mode" in takes:
                opts["mode"] = mode
            elif mode == "bf16" and "bf16" in takes:
                opts["bf16"] = True
            else:
                return None
        return (lambda: gcnii_stack_fwd(adj, h, h0, W, theta, ih, hh, b,
                                        residuals=res, **opts),
                lambda: gcnii_stack_bwd(adj, h0, W, theta, ih, hh, b, res,
                                        dh, **opts))

    def ms(fn):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / args.reps

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    times = {}
    for mode in modes:
        fb = calls(mode)
        if fb is None:
            times[mode] = "not in this tree"
            continue
        fwd, bwd = fb
        fwd()              # the slabs the backward reads
        times[mode] = {"fwd_ms": ms(fwd), "bwd_ms": ms(bwd)}
    print(json.dumps({"label": args.label, "card": card,
                      "shape": f"B={B} N={N} H={H} layers={nl} reason "
                               f"rate 0.4", "modes": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
