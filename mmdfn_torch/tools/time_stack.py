"""Times kernels B (training mode: dropout, residual slabs) and D alone at
the flagship's training shapes: one configuration, B = 32 dialogues of 240
nodes (3 modalities x 80 turns), H = 100, 16 layers, the reason-LSTM, rate
0.4.  Run it on a card, once per tree, to set two versions of the kernels
side by side in one machine (one process a tree, since each imports its
own ``mmdfn_torch``):

    python mmdfn_torch/tools/time_stack.py --root . --label change
    python mmdfn_torch/tools/time_stack.py --root /path/to/parent --label parent

``--bf16`` times the kernels' bf16 mode (``--tpu_fast``; the three bf16
residual slabs) instead of the f32 one.  It prints one JSON line: the
label, the card's name and power limit, and each kernel's stream time per
call (CUDA events, ``--reps`` chained calls after one warm-up)."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".",
                    help="the checkout whose mmdfn_torch is timed")
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--bf16", action="store_true",
                    help="time the bf16 mode")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from mmdfn_torch.device import resolve_device
    from mmdfn_torch.ops import gcnii_stack_bwd, gcnii_stack_fwd

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
    lb = rnd(4 * H, scale=0.1)
    seed = torch.tensor([2021], dtype=torch.int64, device=dev)
    opts = dict(alpha=0.2, reason=True, rate=0.4, seed=seed)
    if args.bf16:
        from mmdfn_torch.ops.gcnii import residual_slabs
        opts["bf16"] = True
        res = residual_slabs((B, nl, N, H), True, dev)
    else:   # the f32 mode, as every version of the port writes it
        from mmdfn_torch.ops.gcnii import RESIDUALS
        res = [torch.empty(B, nl, N, H, device=dev) for _ in RESIDUALS]
    dh = rnd(B, N, H)
    fwd = lambda: gcnii_stack_fwd(adj, h, h0, W, theta, ih, hh, lb,
                                  residuals=res, **opts)
    bwd = lambda: gcnii_stack_bwd(adj, h0, W, theta, ih, hh, lb, res, dh,
                                  **opts)

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
    print(json.dumps({"label": args.label, "card": card,
                      "shape": f"B={B} N={N} H={H} layers={nl} reason "
                               f"rate 0.4" + (" bf16" if args.bf16 else ""),
                      "fwd_ms": ms(fwd), "bwd_ms": ms(bwd)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
