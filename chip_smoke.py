#!/usr/bin/env python3
"""Run the port's serve path and training step on one NVIDIA card and hold
every kernel against its plain PyTorch version.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero:

1. toolchain and card: torch, CUDA, nvcc and Triton versions; the card's
   name and power limit from nvidia-smi;
2. build: all four kernels from ``mmdfn_torch/csrc`` (one nvcc each, at
   once); each kernel's registers, stack and spill bytes (``-Xptxas -v``)
   are printed, and the bi-GRU time loops must not spill;
3. kernels: each kernel against its plain version at the shapes the serve
   path (buckets 32, 64 and 200, i.e. N = 600 for the GCNII stack) and the
   training step (B = 32 text rows and 192 party streams of L = 80; the
   GCNII stack at B = 32, N = 240, 16 layers, dropout 0.4) give it, timed
   on the card (a sleep kernel gives the host a head start) beside the
   plain version and, for the bi-GRU, cuDNN's GRU, timed by the time
   torch.profiler shows its kernels busy on the card (so that autograd's
   host time does not set its pace): kernel A beside its forward, kernel
   C beside its backward alone, and kernel A's training mode plus kernel
   C beside its forward plus backward; the bound is computed from the
   same inputs.  Kernels C and D are checked on the
   residuals their forwards wrote (kernel C also for the same dW_hh bits
   from two launches), and kernel B's training-mode dropout mask against
   the plain Philox mask, bit for bit;
4. serve: the flagship MM-DFN (IEMOCAP GDF with the reason-LSTM, 16 GCNII
   layers, full widths, weights fresh from a seed) answers every utterance
   of three synthetic dialogues through ``StreamingSession``; the launch
   counts, zeroed just before, must show both forward kernels on every
   append, and every append's log-probs must match the same model run with
   the plain versions on the card (``ops.plain_ops()``); a torch.profiler
   window shows where one forward's time goes (device busy sums the
   kernels, not the GPU-side user annotations around them); then the stdio
   server answers a few requests;
5. train: the flagship training step at ``bench.py``'s production settings
   (B = 32 dialogues of U[20, 80] turns, class weights, focal loss, dropout
   0.4, Adam) through ``Trainer.train_step``: one step with the kernels and
   one under ``ops.plain_ops()`` from the same weights and seeds must agree
   in loss and every gradient; then 2 warm-up and 10 timed steps, whose
   launch counts (zeroed just before) must show all four kernels; a
   profiled window (device time by kernel, the bi-GRU kernels by name);
   and 20 steps on one batch, whose loss must fall.

It prints a ``{"kernels": [...]}`` line, the nvidia-smi line and, last,
``{"ok": true, "device": {...}}``.  Without a card, or without the
``mmdfn_torch`` package beside it, it exits nonzero before any result.
"""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, at the full 700 W power limit)
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

NLAYERS = 16             # the flagship's GCNII depth, for the kernel checks
H = 100
SEED = 0
TRAIN_B, TRAIN_L = 32, 80   # bench.py: batch 32, dialogues of 20-80 turns
RATE = 0.4               # the training dropout (mmdfn_tpu config default)
KERNEL_A_TOL = 1e-5      # f32 both sides; summation order of h @ W_hh only
KERNEL_B_RTOL = 1e-5     # of max |h|: f32, summation order over 16 layers
KERNEL_C_RTOL = 1e-5     # of each gradient's max |.| (at least 1): f32, the
                         # dW_hh sums over B L terms in another order
KERNEL_D_RTOL = 1e-4     # of each gradient's max |.|: f32, sums over B N
                         # rows and 16 layers in another order
SERVE_TOL = 1e-4         # log-probs, kernels vs plain through the model
HEAD_START_CYCLES_PER_CALL = 400_000   # ~0.2 ms of the card's clock
CLI_TOL = 2e-4           # the server rounds log-probs to 4 decimals
STEP_LOSS_RTOL = 1e-5    # training step, kernels vs plain: the loss
STEP_GRAD_RTOL = 1e-4    # and every gradient, of its max |.|


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def bound(nbytes: float, flops: float) -> dict:
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FP32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def ptxas_report(outputs: dict) -> list:
    """Registers, stack and spill bytes of every kernel, from the
    ``-Xptxas -v`` output of each build."""
    import re

    rows = []
    for lib, text in outputs.items():
        cur = None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                cur = {"lib": lib, "kernel": m.group(1)}
                rows.append(cur)
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores,"
                          r" (\d+) bytes spill loads", line)
            if m and cur is not None:
                cur.update(stack=int(m[1]), spill_stores=int(m[2]),
                           spill_loads=int(m[3]))
            m = re.search(r"Used (\d+) registers", line)
            if m and cur is not None:
                cur["registers"] = int(m[1])
    if shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(
            r["kernel"] for r in rows), capture_output=True, text=True,
            check=True).stdout.splitlines()
        for r, n in zip(rows, names):
            n = n.replace("(anonymous namespace)::", "").replace("void ", "")
            r["kernel"] = n.split("(")[0]
    return rows


def time_ms(torch, fn, reps: int) -> float:
    """Stream time per call over ``reps`` chained calls.  A sleep kernel
    first gives the host a head start, so that a kernel shorter than its
    wrapper's host time is timed on the card and not at the host's pace."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HEAD_START_CYCLES_PER_CALL * reps)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, reps: int) -> float:
    """Device time per call: the union of the intervals in which the kernels
    that ``fn`` launches ran, from torch.profiler over ``reps`` calls.  For
    library calls whose host time (autograd's engine) may exceed their
    device time: the gaps in which the card waits for the host are not
    counted, and kernels that run at once on several streams (cuDNN runs a
    bidirectional GRU's two directions side by side) are counted once."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    check(bool(spans), "torch.profiler saw no device time")
    busy, until = 0.0, -math.inf
    for a, b in spans:
        if b > until:
            busy += b - max(a, until)
            until = b
    return busy / 1e3 / reps


def kernel_name(key: str) -> str:
    """A profiler key without its namespace and argument list."""
    return key.replace("void ", "").replace("(anonymous namespace)::",
                                            "").split("(")[0]


def toolchain(torch, _build) -> dict:
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    return {"python": sys.version.split()[0], "torch": torch.__version__,
            "cuda": torch.version.cuda, "nvcc": nvcc[-1],
            "triton": triton_version}


def serve_phase(torch, dev) -> dict:
    from mmdfn_torch import ops
    from mmdfn_torch.config import flagship_config
    from mmdfn_torch.data.batching import bucket_length
    from mmdfn_torch.data.datasets import IEMOCAPDataset
    from mmdfn_torch.data.synthetic import make_synthetic_iemocap_pickle
    from mmdfn_torch.serve import StreamingSession, measure_latency
    from mmdfn_torch.weights import build_model

    cfg = flagship_config(seed=SEED)
    model = build_model(cfg)
    with tempfile.TemporaryDirectory() as tmp:
        make_synthetic_iemocap_pickle(f"{tmp}/iem.pkl", n_train=1, n_test=3,
                                      min_len=20, max_len=60, seed=SEED)
        dialogues = IEMOCAPDataset(f"{tmp}/iem.pkl", train=False).dialogues()
    session = StreamingSession(model, cfg, device=dev)
    session.warmup()

    def replay(sess):
        out, lat, used = [], [], []
        for d in dialogues:
            sess.reset()
            for t in range(len(d)):
                t0 = time.perf_counter()
                _, logp = sess.append(d.text[t], d.audio[t], d.visual[t],
                                      int(d.qmask[t].argmax()))
                lat.append((time.perf_counter() - t0) * 1e3)
                used.append(bucket_length(t + 1, sess.buckets))
                out.append(logp)
        return out, lat, used

    ops.reset_launch_counts()
    logps, lat, used = replay(session)          # the main path
    counts = ops.launch_counts()
    n = len(logps)
    check(counts["bigru_fwd"] == 4 * n,
          f"bi-GRU launches {counts['bigru_fwd']} != 4 x {n} appends")
    per_fwd = cfg.Deep_GCN_nlayers + 1          # + layer 0's LSTM step
    check(counts["gcnii_fwd"] == per_fwd * n,
          f"GCNII launches {counts['gcnii_fwd']} != {per_fwd} x {n} appends")
    for lp in logps:
        check(lp.shape == (6,) and bool(all(math.isfinite(v) for v in lp)),
              "log-probs not finite of shape (6,)")
        check(abs(math.log(sum(math.exp(v) for v in lp))) < 1e-4,
              "log-probs do not normalize")

    with ops.plain_ops():
        ref_logps, _, _ = replay(StreamingSession(model, cfg, device=dev))
    err = max(float(abs(a - b).max()) for a, b in zip(logps, ref_logps))
    check(err <= SERVE_TOL, f"serve log-probs vs plain: {err} > {SERVE_TOL}")

    lat_sorted = sorted(lat)
    pct = lambda q: lat_sorted[min(n - 1, int(round(q / 100 * (n - 1))))]
    stats = measure_latency(model, cfg, dialogues, device=dev)
    cli = cli_phase(dialogues[0], logps[:3])
    return {"appends": n, "launches": counts,
            "profile": profile_phase(torch, session, 64),
            "wall_p50_ms": pct(50), "wall_p90_ms": pct(90),
            "buckets_used": sorted(set(used)),
            "max_abs_err_vs_plain": err, "tolerance": SERVE_TOL,
            "device_ms_by_bucket": stats["device_ms_by_bucket"],
            "latency_bench_p50_ms": stats["p50_ms"], "cli": cli}


def device_events(torch, prof):
    """The profile's device work by name, and apart from it the GPU-side
    user annotations (``Optimizer.step#Adam.step``): spans that cover
    kernels already counted, so they stay out of the busy sums."""
    cuda = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    notes = [e for e in cuda if getattr(e, "is_user_annotation", False)]
    return [e for e in cuda if e not in notes], notes


def profile_phase(torch, session, L: int, reps: int = 10) -> dict:
    """Where one forward's time goes at bucket L: device-busy time summed
    over the CUDA kernels torch.profiler saw, against the stream time of
    unprofiled chained forwards (idle share) and the host's enqueue time."""
    from torch.profiler import ProfilerActivity, profile

    session._forward(L, L - 1)
    torch.cuda.synchronize()
    # unprofiled: the host's time to enqueue one forward beside the stream
    # time of the chained forwards; when they agree, the host sets the pace
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        session._forward(L, L - 1)
    enqueue = (time.perf_counter() - t0) * 1e3 / reps
    end.record()
    end.synchronize()
    stream = start.elapsed_time(end) / reps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            session._forward(L, L - 1)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    kern, notes = device_events(torch, prof)
    if not kern:
        return {"bucket": L, "host_enqueue_ms_per_forward": enqueue,
                "stream_ms_per_forward": stream,
                "device_busy_ms_per_forward": "not measured"}
    busy = sum(e.self_device_time_total for e in kern) / 1e3 / reps
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:5]
    return {"bucket": L, "forwards": reps,
            "host_enqueue_ms_per_forward": enqueue,
            "stream_ms_per_forward": stream,
            "wall_ms_per_forward_profiled": wall,
            "device_busy_ms_per_forward": busy,
            "idle_share": 1.0 - busy / stream,
            "device_ops_per_forward": sum(e.count for e in kern) / reps,
            "annotations_left_out": [[e.key[:40], e.self_device_time_total
                                      / 1e3 / reps] for e in notes],
            "top": [[e.key[:40], e.self_device_time_total / 1e3 / reps,
                     e.count / reps] for e in top]}


def cli_phase(d, want) -> dict:
    """The stdio server (same model: flagship, fresh weights from SEED)
    answers three utterances, a reset and one more."""
    utt = lambda t: json.dumps({"text": d.text[t].tolist(),
                                "audio": d.audio[t].tolist(),
                                "visual": d.visual[t].tolist(),
                                "speaker": int(d.qmask[t].argmax())})
    lines = [utt(0), utt(1), utt(2), json.dumps({"reset": True}), utt(0)]
    proc = subprocess.Popen(
        [sys.executable, "-m", "mmdfn_torch.cli.serve", "--seed", str(SEED)],
        cwd=ROOT, stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out, errs = proc.communicate("\n".join(lines) + "\n", timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(proc.returncode == 0, f"serve CLI exited {proc.returncode}: {errs}")
    resp = [json.loads(line) for line in out.splitlines()]
    check(len(resp) == 6 and resp[0].get("ready") and resp[4] == {
        "reset": True}, f"serve CLI responses: {resp}")
    answers = [resp[1], resp[2], resp[3], resp[5]]
    err = max(max(abs(a - float(b)) for a, b in zip(r["log_probs"], w))
              for r, w in zip(answers, [*want, want[0]]))
    check(err <= CLI_TOL, f"serve CLI log-probs differ by {err}")
    return {"responses": len(resp), "max_abs_err": err,
            "latency_ms": [r["latency_ms"] for r in answers]}


def bigru_inputs(torch, dev, B, L, holes=True, seed=1):
    g = torch.Generator().manual_seed(seed)
    u = lambda *s: (torch.rand(*s, generator=g) * 0.2 - 0.1).to(dev)
    xg_f = torch.randn(B, L, 3 * H, generator=g).to(dev)
    xg_b = torch.randn(B, L, 3 * H, generator=g).to(dev)
    mask = ((torch.rand(B, L, generator=g) > 0.4).float() if holes
            else torch.ones(B, L)).to(dev)
    return (xg_f, xg_b, u(3 * H, H).t(), u(3 * H), u(3 * H, H).t(), u(3 * H),
            mask)


def cudnn_gru(torch, dev, args):
    """cuDNN's bidirectional GRU set up to compute the bi-GRU kernels'
    function for an all-valid mask and xg_b = xg_f: identity input weights,
    zero input bias, the kernels' hidden weights and biases."""
    _, _, w_f, b_f, w_b, b_b, _ = args
    gru = torch.nn.GRU(3 * H, H, batch_first=True, bidirectional=True).to(dev)
    with torch.no_grad():
        for suf, w, b in (("", w_f, b_f), ("_reverse", w_b, b_b)):
            getattr(gru, f"weight_ih_l0{suf}").copy_(torch.eye(3 * H))
            getattr(gru, f"bias_ih_l0{suf}").zero_()
            getattr(gru, f"weight_hh_l0{suf}").copy_(w.t())
            getattr(gru, f"bias_hh_l0{suf}").copy_(b)
    return gru


def bigru_case(torch, dev, B, L, train=False) -> dict:
    """Kernel A at (B, L): the party streams have holes in their masks.
    With ``train`` also its training mode, which writes hg for kernel C:
    checked against the plain forward's hg and timed beside the serve
    launch."""
    from mmdfn_torch.ops import bigru_layer_fwd, bigru_layer_plain
    from mmdfn_torch.ops.bigru import _forward

    args = bigru_inputs(torch, dev, B, L, holes=B > 1)
    got = bigru_layer_fwd(*args)
    torch.cuda.synchronize()
    want = bigru_layer_plain(*args, with_hg=train)
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    extra = {}
    if train:
        got_hg = _forward(*args, with_hg=True)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, got_hg)),
              f"bi-GRU training mode changed ys at B={B} L={L}")
        err = max(err, *(float((a - b).abs().max())
                         for a, b in zip(got_hg[2:], want[2:])))
        extra["train_ms"] = time_ms(
            torch, lambda: _forward(*args, with_hg=True), 50)
    check(err <= KERNEL_A_TOL, f"bi-GRU kernel vs plain at B={B} L={L}: {err}")
    ms = time_ms(torch, lambda: bigru_layer_fwd(*args), 50)
    plain_ms = time_ms(torch, lambda: bigru_layer_plain(*args), 3)

    xg_f, _, w_f, b_f, w_b, b_b, _ = args
    gru = cudnn_gru(torch, dev, args)
    with torch.no_grad():
        lib_out, _ = gru(xg_f)
        ones = torch.ones(B, L, device=dev)
        ref = bigru_layer_fwd(xg_f, xg_f, w_f, b_f, w_b, b_b, ones)
        lib_err = float((lib_out - torch.cat(ref, -1)).abs().max())
        check(lib_err <= 1e-4, f"cuDNN GRU vs kernel at B={B} L={L}: "
                               f"{lib_err}")
        library_ms = device_ms(torch, lambda: gru(xg_f), 50)

    G = 3 * H
    nbytes = 4 * (2 * B * L * G + 2 * (H * G + G) + B * L + 2 * B * L * H)
    # per step, row and direction: h @ W_hh (2 H G) and ~12 H of gate math
    flops = 2 * L * B * (2 * H * G + 12 * H)
    return {"shape": f"B={B} L={L} H={H}", "max_abs_err": err, "ms": ms,
            **extra, "plain_ms": plain_ms, "library_ms": library_ms,
            **bound(nbytes, flops)}


def gcnii_case(torch, dev, L, reason=True) -> dict:
    """Kernel B at bucket L: one dialogue, N = 3L nodes, 16 layers."""
    from mmdfn_torch.graph.adjacency import mm_big_adjacency
    from mmdfn_torch.ops import gcnii_stack_fwd, gcnii_stack_plain

    g = torch.Generator().manual_seed(L)
    umask = torch.ones(1, L)
    adj = mm_big_adjacency([torch.randn(1, L, 2 * H, generator=g)
                            for _ in range(3)], umask).to(dev)
    N, nl = 3 * L, NLAYERS
    u = lambda *s: (torch.rand(*s, generator=g) * 0.2 - 0.1).to(dev)
    h = torch.relu(torch.randn(1, N, H, generator=g)).to(dev)
    theta = torch.log(0.5 / torch.arange(1, nl + 1) + 1.0).to(dev)
    lstm = (u(4 * H, H).t(), u(4 * H, H).t(), u(4 * H)) if reason else ()
    args = (adj, h, h, u(nl, 2 * H, H), theta, *lstm)
    run = lambda: gcnii_stack_fwd(*args, alpha=0.2, reason=reason)
    plain = lambda: gcnii_stack_plain(*args, alpha=0.2, reason=reason)
    got = run()
    torch.cuda.synchronize()
    want = plain()
    err = float((got - want).abs().max())
    tol = KERNEL_B_RTOL * max(1.0, float(want.abs().max()))
    check(err <= tol, f"GCNII kernel vs plain at N={N}: {err} > {tol}")
    nbytes = 4 * (N * N + 3 * N * H + nl * (2 * H * H + 1)
                  + (2 * H * 4 * H + 4 * H if reason else 0))
    # per layer: adj @ h1, the two support products, the update (~6 N H);
    # with reason, the LSTM step's two (N, H) @ (H, 4H) products and gates
    flops = nl * (2 * N * N * H + 4 * N * H * H + 6 * N * H)
    if reason:
        flops += nl * (16 * N * H * H + 12 * N * H)
    return {"shape": f"B=1 N={N} H={H} layers={nl} reason={reason}",
            "max_abs_err": err, "tolerance": tol,
            "ms": time_ms(torch, run, 20), "plain_ms": time_ms(torch, plain, 5),
            "library_ms": None, **bound(nbytes, flops)}


def bigru_bwd_case(torch, dev, B, L, a_train_ms) -> dict:
    """Kernel C at (B, L) with holed masks, on the ys and hg that kernel
    A's training mode wrote, against the plain backward (which recomputes
    the gates); two launches must give the same dW_hh and db_hh bits.
    Yardsticks: cuDNN's bidirectional GRU (all-valid mask, identity input
    weights) backward alone, and its forward plus backward beside kernel A's
    training mode plus kernel C."""
    from mmdfn_torch.ops import bigru_layer_bwd, bigru_layer_bwd_plain
    from mmdfn_torch.ops.bigru import _forward

    args = bigru_inputs(torch, dev, B, L, seed=2)
    ys_f, ys_b, hg_f, hg_b = _forward(*args, with_hg=True)
    g = torch.Generator().manual_seed(3)
    dy = [torch.randn(B, L, H, generator=g).to(dev) for _ in range(2)]
    run = lambda: bigru_layer_bwd(*args, ys_f, ys_b, *dy, hg_f, hg_b)
    plain = lambda: bigru_layer_bwd_plain(*args, ys_f, ys_b, *dy)
    got = [t.clone() for t in run()]
    again = run()
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got[2:], again[2:])),
          f"bi-GRU bwd dW_hh / db_hh differ between launches at B={B}")
    want = plain()
    err = 0.0
    for a, b in zip(got, want):
        e = float((a - b).abs().max())
        tol = KERNEL_C_RTOL * max(1.0, float(b.abs().max()))
        check(e <= tol, f"bi-GRU bwd kernel vs plain at B={B} L={L}: "
                        f"{e} > {tol}")
        err = max(err, e)
    ms = time_ms(torch, run, 20)
    run_device_ms = device_ms(torch, run, 20)
    plain_ms = time_ms(torch, plain, 2)

    gru = cudnn_gru(torch, dev, args)
    x = args[0].clone().requires_grad_()
    dout = torch.cat(dy, dim=-1)
    out, _ = gru(x)
    wrt = [x, gru.weight_hh_l0, gru.bias_hh_l0, gru.weight_hh_l0_reverse,
           gru.bias_hh_l0_reverse]
    library_ms = device_ms(torch, lambda: torch.autograd.grad(
        out, wrt, dout, retain_graph=True), 20)

    def fwd_bwd():
        o, _ = gru(x)
        torch.autograd.grad(o, wrt, dout)
    library_fwd_bwd_ms = device_ms(torch, fwd_bwd, 20)

    G = 3 * H
    # xg, hg (3H each), ys, dy (H each), mask, W_hh in; dxg, dW_hh, db_hh
    # out.  The dhg scratch that the kernel writes and reads back is its
    # own choice, not the function's work, so it is not counted
    nbytes = 4 * (2 * (2 * B * L * G + 2 * B * L * H + H * G) + B * L
                  + 2 * B * L * G + 2 * (H * G + G))
    # per step, row and direction: dhg @ W_hh^T (2 H G) and ~30 H of gate
    # math; after the loop, [h_prev, 1]^T dhg (2 (H + 1) G)
    flops = 2 * L * B * (2 * H * G + 2 * (H + 1) * G + 30 * H)
    # the count for a backward that recomputes the gates (three products a
    # step, hg not read), which earlier measurements were held against
    old_bytes = 4 * (2 * B * L * G + 4 * B * L * H + 2 * (H * G + G) + B * L
                     + 2 * B * L * G + 2 * (H * G + G))
    old_flops = 2 * L * B * (6 * H * G + 30 * H)
    return {"shape": f"B={B} L={L} H={H}", "max_abs_err": err, "ms": ms,
            "device_ms": run_device_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "a_train_plus_c_ms": a_train_ms + ms,
            "library_fwd_bwd_ms": library_fwd_bwd_ms,
            **bound(nbytes, flops),
            "bound_ms_recompute_basis":
                bound(old_bytes, old_flops)["bound_ms"]}


def gcnii_train_inputs(torch, dev, B, L, seed=4):
    from mmdfn_torch.graph.adjacency import mm_big_adjacency

    g = torch.Generator().manual_seed(seed)
    lengths = torch.randint(20, L + 1, (B,), generator=g)
    umask = (torch.arange(L)[None] < lengths[:, None]).float()
    adj = mm_big_adjacency([torch.randn(B, L, 2 * H, generator=g)
                            * umask[..., None] for _ in range(3)],
                           umask).to(dev)
    N = 3 * L
    u = lambda *s: (torch.rand(*s, generator=g) * 0.2 - 0.1).to(dev)
    h0 = torch.relu(torch.randn(B, N, H, generator=g)).to(dev)
    h = h0 * (torch.rand(B, N, H, generator=g) < 1 - RATE).to(dev) \
        / (1 - RATE)
    theta = torch.log(0.5 / torch.arange(1, NLAYERS + 1) + 1.0).to(dev)
    args = (adj, h, h0, u(NLAYERS, 2 * H, H), theta, u(4 * H, H).t(),
            u(4 * H, H).t(), u(4 * H))
    return args, g


def gcnii_train_case(torch, dev, B, L) -> dict:
    """Kernel B's training mode (dropout, residuals) and kernel D at the
    training shapes, each against its plain version; kernel D on the
    residuals kernel B wrote."""
    from mmdfn_torch.ops import (gcnii_stack_bwd, gcnii_stack_bwd_plain,
                                 gcnii_stack_fwd, gcnii_stack_plain)
    from mmdfn_torch.ops.gcnii import RESIDUALS

    args, g = gcnii_train_inputs(torch, dev, B, L)
    adj, h, h0, W, theta, ih, hh, lb = args
    N = 3 * L
    seed = torch.tensor([SEED + 12345], dtype=torch.int64, device=dev)
    slabs = lambda: [torch.empty(B, NLAYERS, N, H, device=dev)
                     for _ in RESIDUALS]
    res, res_p = slabs(), slabs()
    opts = dict(alpha=0.2, reason=True, rate=RATE, seed=seed)
    fwd = lambda: gcnii_stack_fwd(*args, residuals=res, **opts)
    fwd_plain = lambda: gcnii_stack_plain(*args, residuals=res_p, **opts)
    out = fwd()
    torch.cuda.synchronize()
    want = fwd_plain()
    scale = max(1.0, float(want.abs().max()))
    fwd_err = max(float((a - b).abs().max())
                  for a, b in zip([out, *res], [want, *res_p]))
    fwd_tol = KERNEL_B_RTOL * scale
    check(fwd_err <= fwd_tol, f"GCNII training forward vs plain: {fwd_err}")

    dh = torch.randn(B, N, H, generator=g).to(dev)
    bwd_args = (adj, h0, W, theta, ih, hh, lb, res, dh)
    bwd = lambda: gcnii_stack_bwd(*bwd_args, **opts)
    bwd_plain = lambda: gcnii_stack_bwd_plain(*bwd_args, **opts)
    got = bwd()
    torch.cuda.synchronize()
    ref = bwd_plain()
    bwd_err = 0.0
    for name, a, b in zip(("d_adj", "d_h", "d_h0", "dW", "dW_ih", "dW_hh",
                           "db"), got, ref):
        e = float((a - b).abs().max())
        tol = KERNEL_D_RTOL * float(b.abs().max())
        check(e <= tol, f"GCNII bwd kernel vs plain, {name}: {e} > {tol}")
        bwd_err = max(bwd_err, e)

    R, nl = B * N, NLAYERS
    layer_fwd = 2 * B * N * N * H + 4 * R * H * H + 16 * R * H * H
    fwd_flops = nl * (layer_fwd + 20 * R * H)
    # adj, h, h0, W, theta, LSTM in; h and four residual slabs out
    fwd_bytes = 4 * (B * N * N + 2 * R * H + nl * (2 * H * H + 1)
                     + 2 * 4 * H * H + 4 * H + R * H + 4 * nl * R * H)
    # per layer: adj @ h1, adj^T d_hi, d_hi h1^T (6 B N^2 H); the support
    # products, their transposes and dW (12 B N H^2); the LSTM recompute,
    # its input gradients and dW_ih, dW_hh (48 B N H^2 - not counting the
    # bias row); elementwise ~40 B N H
    bwd_flops = nl * (6 * B * N * N * H + 60 * R * H * H + 40 * R * H)
    # adj, h0, W, the LSTM, four residual slabs and dh in; d_adj, d_h,
    # d_h0, dW and the LSTM gradients out
    bwd_bytes = 4 * (2 * B * N * N + 4 * R * H + 2 * nl * 2 * H * H
                     + 2 * (8 * H * H + 4 * H) + 4 * nl * R * H)
    return {
        "fwd": {"shape": f"B={B} N={N} H={H} layers={nl} rate={RATE} "
                         "residuals", "max_abs_err": fwd_err,
                "tolerance": fwd_tol, "ms": time_ms(torch, fwd, 10),
                "plain_ms": time_ms(torch, fwd_plain, 2),
                "library_ms": None, **bound(fwd_bytes, fwd_flops)},
        "bwd": {"shape": f"B={B} N={N} H={H} layers={nl} rate={RATE}",
                "max_abs_err": bwd_err, "ms": time_ms(torch, bwd, 10),
                "plain_ms": time_ms(torch, bwd_plain, 2),
                "library_ms": None, **bound(bwd_bytes, bwd_flops)}}


def mask_check(torch, dev) -> dict:
    """Kernel B's training-mode dropout mask against the plain Philox mask,
    bit for bit, for all 16 layers at B = 32, N = 240: with W = 0, alpha =
    1 and no reason-LSTM a layer's output is keep * (1 - theta) h0 /
    (1 - rate), so layer l + 1's residual h shows layer l's mask."""
    from mmdfn_torch.ops import gcnii_stack_fwd, philox
    from mmdfn_torch.ops.gcnii import RESIDUALS

    B, N, nl = TRAIN_B, 3 * TRAIN_L, NLAYERS
    g = torch.Generator().manual_seed(6)
    h0 = (torch.rand(B, N, H, generator=g) + 0.5).to(dev)
    adj = (torch.rand(B, N, N, generator=g) / N).to(dev)
    theta = torch.log(0.5 / torch.arange(1, nl + 1) + 1.0).to(dev)
    seed = torch.tensor([SEED + 777], dtype=torch.int64, device=dev)
    res = [torch.zeros(B, nl, N, H, device=dev) for _ in RESIDUALS]
    out = gcnii_stack_fwd(adj, h0, h0, torch.zeros(nl, 2 * H, H, device=dev),
                          theta, alpha=1.0, reason=False, rate=RATE,
                          seed=seed, residuals=res)
    torch.cuda.synchronize()
    kept = 0
    for l in range(nl):
        got = (res[0][:, l + 1] if l + 1 < nl else out) != 0
        want = philox.keep_mask(seed, RATE, B, l, N, H)
        check(torch.equal(got, want), f"dropout mask of layer {l} differs")
        kept += int(want.sum())
    return {"layers": nl, "elements": nl * B * N * H,
            "keep_fraction": kept / (nl * B * N * H)}


def train_batch(torch, rng, dev, B=TRAIN_B, L=TRAIN_L) -> dict:
    """bench.py's make_batch recipe: lengths U[20, L], random speakers,
    standard-normal features, random labels; on the card."""
    import numpy as np

    lengths = rng.integers(20, L + 1, size=B)
    umask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32)
    spk = rng.integers(0, 2, size=(B, L))
    qmask = np.zeros((B, L, 2), np.float32)
    qmask[np.arange(B)[:, None], np.arange(L)[None, :], spk] = 1.0
    qmask *= umask[..., None]
    feat = lambda D: (rng.standard_normal((B, L, D), dtype=np.float32)
                      * umask[..., None])
    label = (rng.integers(0, 6, size=(B, L)) * umask).astype(np.int64)
    arrays = dict(text=feat(100), audio=feat(1582), visual=feat(342),
                  qmask=qmask, umask=umask, label=label)
    return {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}


def train_phase(torch, dev) -> dict:
    """The flagship training step at bench.py's production settings."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from mmdfn_torch import ops
    from mmdfn_torch.config import ExperimentConfig
    from mmdfn_torch.train import Trainer

    cfg = ExperimentConfig(dataset="IEMOCAP", graph_type="GDF",
                           reason_flag=True, class_weight=True,
                           Deep_GCN_nlayers=NLAYERS, batch_size=TRAIN_B,
                           speaker_weights="3-0-1", dropout=RATE, seed=SEED)
    rng = np.random.default_rng(SEED)
    batches = [train_batch(torch, rng, dev) for _ in range(4)]

    # one step with the kernels, one with the plain versions: same weights
    # (cfg.seed), same step seed
    def one_step(plain):
        tr = Trainer(cfg, device=dev)
        if plain:
            with ops.plain_ops():
                loss, _ = tr.train_step(batches[0], seed=1)
        else:
            loss, _ = tr.train_step(batches[0], seed=1)
        torch.cuda.synchronize()
        return float(loss), {n: p.grad for n, p in
                             tr.model.named_parameters()}
    loss_k, grads_k = one_step(plain=False)
    loss_p, grads_p = one_step(plain=True)
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    check(loss_err <= STEP_LOSS_RTOL, f"step loss kernels {loss_k} vs plain "
                                      f"{loss_p}")
    grad_err = 0.0
    for name, gp in grads_p.items():
        gk = grads_k[name]
        check(gk is not None and float(gk.abs().max()) > 0,
              f"no gradient reached {name}")
        e = float((gk - gp).abs().max()) / float(gp.abs().max())
        check(e <= STEP_GRAD_RTOL, f"gradient of {name}: {e} of its scale")
        grad_err = max(grad_err, e)

    # the main path: 2 warm-up steps, then 10 timed steps with the counts
    # zeroed just before and read just after
    tr = Trainer(cfg, device=dev)
    for i in range(2):
        tr.train_step(batches[i % 4], seed=100 + i)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    wall, enqueue, losses = [], [], []
    for i in range(10):
        t0 = time.perf_counter()
        loss, _ = tr.train_step(batches[i % 4], seed=200 + i)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        enqueue.append((t1 - t0) * 1e3)
        losses.append(float(loss))
    counts = ops.launch_counts()
    per_step = {k: v / 10 for k, v in counts.items()}
    check(all(v > 0 for v in counts.values()),
          f"a kernel was not launched by the training step: {counts}")
    check(all(math.isfinite(v) for v in losses), f"losses {losses}")
    step_ms = sorted(wall)[len(wall) // 2]

    # chained steps: the stream's time per step; then a profiled window
    K = 5
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(K):
        tr.train_step(batches[i % 4], seed=300 + i)
    end.record()
    end.synchronize()
    stream_ms = start.elapsed_time(end) / K
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(3):
            tr.train_step(batches[i % 4], seed=400 + i)
        torch.cuda.synchronize()
    kern, notes = device_events(torch, prof)
    if kern:
        busy = sum(e.self_device_time_total for e in kern) / 1e3 / 3
        top = sorted(kern, key=lambda e: -e.self_device_time_total)[:10]
        bigru = [[kernel_name(e.key), e.self_device_time_total / 1e3 / 3,
                  e.count / 3] for e in kern if "bigru" in e.key]
        profiled = {"device_busy_ms_per_step": busy,
                    "bigru_kernels": sorted(bigru),
                    "idle_share": 1.0 - busy / stream_ms,
                    "device_ops_per_step": sum(e.count for e in kern) / 3,
                    "annotations_left_out": [
                        [e.key[:40], e.self_device_time_total / 1e3 / 3]
                        for e in notes],
                    "top": [[e.key[:40], e.self_device_time_total / 1e3 / 3,
                             e.count / 3] for e in top]}
    else:
        profiled = {"device_busy_ms_per_step": "not measured",
                    "idle_share": "not measured"}

    # 20 steps on one fixed batch: the loss must fall
    tr = Trainer(cfg, device=dev)
    fit = [float(tr.train_step(batches[0], seed=500 + i)[0])
           for i in range(20)]
    check(sum(fit[-5:]) < sum(fit[:5]),
          f"the loss did not fall over 20 steps on one batch: {fit}")
    return {"shape": f"B={TRAIN_B} L<={TRAIN_L} layers={NLAYERS} "
                     f"dropout={RATE}",
            "step_loss_rel_err_vs_plain": loss_err,
            "step_grad_max_rel_err_vs_plain": grad_err,
            "launches": counts, "launches_per_step": per_step,
            "step_ms_median": step_ms, "step_ms_all": wall,
            "dialogues_per_sec": TRAIN_B / (step_ms / 1e3),
            "host_enqueue_ms_per_step": sorted(enqueue)[len(enqueue) // 2],
            "stream_ms_per_step": stream_ms, **profiled,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "fixed_batch_losses": fit}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (ROOT / "mmdfn_torch" / "csrc").is_dir():
        print("chip_smoke: the mmdfn_torch package is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from mmdfn_torch import ops
    from mmdfn_torch.device import resolve_device
    from mmdfn_torch.ops import _build

    dev = resolve_device("cuda")        # also sets the f32 (no TF32) policy
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"toolchain": toolchain(torch, _build)}), flush=True)
    print(smi, flush=True)

    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    ptxas = ptxas_report(_build.build_all())
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "kernels": list(_build.KERNELS)}), flush=True)
    print(json.dumps({"ptxas": ptxas}), flush=True)
    # the time loops of kernels A and C keep W_hh in registers: no spills
    loops = [r for r in ptxas if r["lib"] in ("bigru_fwd", "bigru_bwd")
             and ("bigru_fwd_kernel" in r["kernel"]
                 or "bigru_bwd_kernel" in r["kernel"])]
    check(len(loops) == 9 and all(
        r.get("spill_stores", 1) == 0 and r.get("spill_loads", 1) == 0
        for r in loops), f"bi-GRU time-loop kernels spill: {loops}")

    # the kernel checks first, so that the serve and train lines stand near
    # the end of the output; their launches are zeroed before those runs
    cases_a = {(B, L): bigru_case(torch, dev, B, L)
               for L in (32, 64, 200) for B in (1, 6)}
    for B in (TRAIN_B, 6 * TRAIN_B):     # lstm_l, and rnn_parties' streams
        cases_a[(B, TRAIN_L)] = bigru_case(torch, dev, B, TRAIN_L, train=True)
    cases_b = {L: gcnii_case(torch, dev, L) for L in (32, 64, 200)}
    cases_b["200_no_reason"] = gcnii_case(torch, dev, 200, reason=False)
    cases_c = {B: bigru_bwd_case(torch, dev, B, TRAIN_L,
                                 cases_a[(B, TRAIN_L)]["train_ms"])
               for B in (TRAIN_B, 6 * TRAIN_B)}
    case_bd = gcnii_train_case(torch, dev, TRAIN_B, TRAIN_L)
    mask = mask_check(torch, dev)
    print(json.dumps({"kernel_cases": {
        "bigru_fwd (library: torch.nn.GRU, cuDNN, all-valid mask, device "
        "time)": list(cases_a.values()),
        "gcnii_fwd": list(cases_b.values()),
        "bigru_bwd (library: torch.nn.GRU backward alone, cuDNN; "
        "library_fwd_bwd: its forward + backward, beside kernel A's "
        "training mode + kernel C; both device time)": list(cases_c.values()),
        "gcnii_fwd training mode": case_bd["fwd"],
        "gcnii_bwd": case_bd["bwd"],
        "dropout mask vs plain Philox": mask}}), flush=True)

    serve = serve_phase(torch, dev)
    print(json.dumps({"serve": serve}), flush=True)
    train = train_phase(torch, dev)
    print(json.dumps({"train": train}), flush=True)

    # the line's numbers: the training step's shapes (the party streams'
    # B = 192 for the bi-GRU kernels; B = 32, N = 240 for the GCNII stack);
    # launches from the training step's main-path run
    big = (6 * TRAIN_B, TRAIN_L)
    report = [
        ("bigru_fwd", "cuda", "mmdfn_torch/csrc/bigru_fwd.cu",
         "mmdfn_tpu/ops/pallas_rnn.py:266", cases_a[big],
         max(c["max_abs_err"] for c in cases_a.values()), KERNEL_A_TOL),
        ("bigru_bwd", "cuda", "mmdfn_torch/csrc/bigru_bwd.cu",
         "mmdfn_tpu/ops/pallas_rnn.py:298", cases_c[6 * TRAIN_B],
         max(c["max_abs_err"] for c in cases_c.values()),
         f"{KERNEL_C_RTOL} x max(1, max|grad|) of each gradient"),
        ("gcnii_fwd", "cuda", "mmdfn_torch/csrc/gcnii_fwd.cu",
         "mmdfn_tpu/ops/pallas_gcnii_train.py:472", case_bd["fwd"],
         max([c["max_abs_err"] for c in cases_b.values()]
             + [case_bd["fwd"]["max_abs_err"]]),
         f"{KERNEL_B_RTOL} x max|h|"),
        ("gcnii_bwd", "cuda", "mmdfn_torch/csrc/gcnii_bwd.cu",
         "mmdfn_tpu/ops/pallas_gcnii_train.py:526", case_bd["bwd"],
         case_bd["bwd"]["max_abs_err"],
         f"{KERNEL_D_RTOL} x max|grad| of each gradient"),
    ]
    kernels = []
    for name, route, source, replaces, case, err, tol in report:
        kernels.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": train["launches"][name],
            "max_abs_err": err, "tolerance": tol, "shape": case["shape"],
            "ms": case["ms"], "plain_ms": case["plain_ms"],
            "bound_ms": case["bound_ms"], "bound_by": case["bound_by"],
            "library_ms": case["library_ms"]})
    check(set(ops.WRAPPERS) == {k["name"] for k in kernels},
          "every kernel of the path is in the report")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
