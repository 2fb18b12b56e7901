"""Times kernels B (training mode: dropout, residual slabs) and D alone at
a GCNII stack's training shapes, by default the flagship's: one
configuration, B = 32 dialogues of 240 nodes (3 modalities x 80 turns),
H = 100, 16 layers, the reason-LSTM, rate 0.4.  Run it on a card, once per
tree, to set two versions of the kernels side by side in one machine (one
process a tree, since each imports its own ``mmdfn_torch``):

    python mmdfn_torch/tools/time_stack.py --root . --label change
    python mmdfn_torch/tools/time_stack.py --root /path/to/parent --label parent

``--shape`` names the stack, comma-separated or ``all``: ``flagship``;
``meld`` (N = 99, 64 layers, the reason-LSTM); ``gf2`` (N = 240, 64
layers, no LSTM, alpha 0.1); ``deepgcn`` (N = 80, 16 layers, no LSTM,
alpha 0.1, rate 0); ``iemocap_grid`` and ``meld_grid`` (the benchmark
cells' 16 configurations of 32 dialogues as one batch of 512: N = 288,
16 layers; N = 96, 64 layers).  ``--mode`` names the numerics modes to time,
comma-separated or ``all``: ``f32`` (the default), ``bf16``
(``--tpu_fast``'s fused-kernel numerics, three bf16 residual slabs) and
``bf16_scan`` (JAX's bf16 layer scan, ``gcn_compute_dtype='bfloat16'``;
the LSTM's two biases apart); each on the same operands, one after the
other in this process.  A tree whose wrappers take ``bf16=`` (no
``mode``) times ``bf16`` through it; one that has neither times ``f32``
only.  ``--products`` adds each product's device milliseconds a call
(torch.profiler, the kernels named by their epilogue), ``--digest`` the
SHA-256 of every output of one forward and one backward (the bits two
trees must share where their kernels compute alike).  It prints one JSON
line: the label, the card's name and power limit, and for each shape and
mode the kernels' stream time per call (CUDA events, ``--reps`` chained
calls after one warm-up)."""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import os
import re
import subprocess
import sys
from collections import defaultdict

MODES = ("f32", "bf16", "bf16_scan")
# B, N, layers, the reason-LSTM, alpha, rate
SHAPES = {"flagship": (32, 240, 16, True, 0.2, 0.4),
          "meld": (32, 99, 64, True, 0.2, 0.4),
          "gf2": (32, 240, 64, False, 0.1, 0.4),
          "deepgcn": (32, 80, 16, False, 0.1, 0.0),
          # the benchmark cells' group steps: K = 16 configurations of B = 32
          # as one batch of 512 (IEMOCAP's bucket 96; MELD's bucket 32)
          "iemocap_grid": (512, 288, 16, True, 0.2, 0.4),
          "meld_grid": (512, 96, 64, True, 0.2, 0.4)}
H = 100
# the words of a kernel's name that are not its epilogue's
_NOT_PART = {"void", "gemm", "OperandT", "float",
             "true", "false", "bf16", "__nv_bfloat16", "gemm_kernel",
             "gemm_tc_kernel", "unsigned", "int", "long"}


def part_of(kernel: str) -> str:
    """A kernel's short name: its epilogue's type for a tiled product
    (``F1CellT``, ``P3Pre``; ``tc`` after it on the tensor cores), else
    the kernel's own name."""
    head = kernel.replace("(anonymous namespace)::", "").split("(")[0]
    words = [w for w in re.findall(r"[A-Za-z_]\w*", head)
             if w not in _NOT_PART]
    name = words[-1] if words else head[:40]
    return name + (" tc" if "gemm_tc_kernel" in head else "")


def operands(torch, dev, shape: str):
    """The stack's operands at ``shape``, drawn from a fixed seed on the
    host."""
    B, N, nl, reason, _, rate = SHAPES[shape]
    g = torch.Generator().manual_seed(0)
    rnd = lambda *s, scale=1.0: (torch.randn(*s, generator=g)
                                 * scale).to(dev)
    adj = (torch.rand(B, N, N, generator=g) / N).to(dev)
    h, h0 = rnd(B, N, H), rnd(B, N, H)
    W = rnd(nl, 2 * H, H, scale=0.1)
    theta = (torch.rand(nl, generator=g) * 0.5).to(dev)
    ih, hh = rnd(H, 4 * H, scale=0.1), rnd(H, 4 * H, scale=0.1)
    lb = rnd(2, 4 * H, scale=0.1)
    seed = (torch.tensor([2021], dtype=torch.int64, device=dev) if rate
            else None)
    dh = rnd(B, N, H)
    return adj, h, h0, W, theta, ih, hh, lb, seed, dh


def calls(torch, dev, shape: str, mode: str, ops, takes):
    """(forward, backward, residuals) of one mode at one shape, as the
    tree's wrappers take it; None where the tree has no such mode."""
    from mmdfn_torch.ops.gcnii import RESIDUALS

    B, N, nl, reason, alpha, rate = SHAPES[shape]
    adj, h, h0, W, theta, ih, hh, lb, seed, dh = operands(torch, dev, shape)
    opts = dict(alpha=alpha, reason=reason, rate=rate, seed=seed)
    b = lb if mode == "bf16_scan" else lb[0] + lb[1]
    if not reason:
        ih = hh = b = None
    if mode == "f32":
        res = [torch.zeros(B, nl, N, H, device=dev) for _ in RESIDUALS]
    else:
        res = [torch.zeros(B, nl, N, H, device=dev, dtype=torch.bfloat16)
               for _ in RESIDUALS[:3]]
        if "mode" in takes:
            opts["mode"] = mode
        elif mode == "bf16" and "bf16" in takes:
            opts["bf16"] = True
        else:
            return None
    return (lambda: ops.gcnii_stack_fwd(adj, h, h0, W, theta, ih, hh, b,
                                        residuals=res, **opts),
            lambda: ops.gcnii_stack_bwd(adj, h0, W, theta, ih, hh, b, res,
                                        dh, **opts),
            res)


def digest(tensors) -> str:
    """The SHA-256 of the tensors' bytes, in order (None skipped)."""
    import torch

    sha = hashlib.sha256()
    for t in tensors:
        if t is not None:
            sha.update(t.detach().reshape(-1).view(torch.uint8).cpu()
                       .numpy().tobytes())
    return sha.hexdigest()


def digests(torch, dev, shape: str = "flagship",
            modes=("bf16", "bf16_scan")) -> dict:
    """For each mode, the SHA-256 of one forward's output and residual
    slabs and of the backward's gradients on the shape's operands."""
    from mmdfn_torch import ops

    takes = inspect.signature(ops.gcnii_stack_fwd).parameters
    out = {}
    for mode in modes:
        fb = calls(torch, dev, shape, mode, ops, takes)
        if fb is None:
            out[mode] = "not in this tree"
            continue
        fwd, bwd, res = fb
        y = fwd()
        grads = bwd()
        torch.cuda.synchronize()
        out[mode] = {"fwd": digest([y, *res]), "bwd": digest(grads)}
    return out


def products_ms(torch, fn, reps: int) -> dict:
    """Each kernel's device milliseconds a call of ``fn``, by
    :func:`part_of`, over ``reps`` calls under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by = defaultdict(float)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False):
            by[part_of(e.name)] += (e.time_range.end
                                    - e.time_range.start) / 1e3 / reps
    return dict(sorted(by.items(), key=lambda x: -x[1]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".",
                    help="the checkout whose mmdfn_torch is timed")
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--mode", default="f32",
                    help="comma-separated of f32, bf16, bf16_scan, or all")
    ap.add_argument("--shape", default="flagship",
                    help="comma-separated of " + ", ".join(SHAPES)
                    + ", or all")
    ap.add_argument("--products", action="store_true",
                    help="each product's device ms a call (torch.profiler)")
    ap.add_argument("--digest", action="store_true",
                    help="the SHA-256 of each mode's outputs")
    args = ap.parse_args()
    modes = MODES if args.mode == "all" else tuple(args.mode.split(","))
    shapes = (tuple(SHAPES) if args.shape == "all"
              else tuple(args.shape.split(",")))
    if not set(modes) <= set(MODES):
        ap.error(f"--mode {args.mode}: each one of {MODES}")
    if not set(shapes) <= set(SHAPES):
        ap.error(f"--shape {args.shape}: each one of {tuple(SHAPES)}")
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from mmdfn_torch import ops
    from mmdfn_torch.device import resolve_device

    dev = resolve_device("cuda")
    takes = inspect.signature(ops.gcnii_stack_fwd).parameters

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
    result = {}
    for shape in shapes:
        times = {}
        for mode in modes:
            fb = calls(torch, dev, shape, mode, ops, takes)
            if fb is None:
                times[mode] = "not in this tree"
                continue
            fwd, bwd, _ = fb
            fwd()              # the slabs the backward reads
            times[mode] = {"fwd_ms": ms(fwd), "bwd_ms": ms(bwd)}
            if args.products:
                times[mode]["fwd_products_ms"] = products_ms(torch, fwd, 5)
                times[mode]["bwd_products_ms"] = products_ms(torch, bwd, 5)
        if args.digest:
            times["digest"] = digests(torch, dev, shape, modes)
        B, N, nl, reason, alpha, rate = SHAPES[shape]
        result[shape] = {"shape": f"B={B} N={N} H={H} layers={nl} "
                                  f"reason={int(reason)} alpha {alpha} "
                                  f"rate {rate}", "modes": times}
    line = {"label": args.label, "card": card}
    if shapes == ("flagship",):   # the line earlier trees printed
        line.update(result["flagship"])
    else:
        line["shapes"] = result
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
