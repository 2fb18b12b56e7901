#!/usr/bin/env python3
"""Run the port's serve path and training step on one NVIDIA card and hold
every kernel against its plain PyTorch version.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero:

1. toolchain and card: torch, CUDA, nvcc and Triton versions; the card's
   name and power limit from nvidia-smi;
2. build: all four kernels from ``mmdfn_torch/csrc`` (one nvcc each, at
   once); each kernel's registers, stack and spill bytes (``-Xptxas -v``)
   are printed, and neither the bi-GRU time loops nor any kernel of the
   GCNII stack (B, D, the resident one included) may spill;
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
   the plain Philox mask, bit for bit.  Kernel D is held against the plain
   backward at its own ReLU decisions, which must differ from the plain
   recompute's only where the ReLU's input is within the forward's
   tolerance of 0.  Kernel B's serve cases (one dialogue at every serve
   bucket, N = 24 ... 600, and N = 600 without the reason-LSTM) check and
   time each of its three designs (three tiled products a layer, one
   row-wise launch a layer, or the whole stack in one launch on a cluster
   of CTAs) and report the one the wrapper picks, and a table does the
   same at N = 240 for B = 1 ... 32 dialogues, in inference and in
   training mode; its training case times the row-wise design beside the
   tiled one;
4. serve: the flagship MM-DFN (IEMOCAP GDF with the reason-LSTM, 16 GCNII
   layers, full widths, weights fresh from a seed) answers every utterance
   of three synthetic dialogues through ``StreamingSession``; the launch
   counts, zeroed just before, must show both forward kernels on every
   append (kernel B: its documented CUDA launches per forward), and every
   append's log-probs must match the same model run with
   the plain versions on the card (``ops.plain_ops()``); a torch.profiler
   window shows where one forward's time goes (device busy sums the
   kernels, not the GPU-side user annotations around them);
   ``serve/latency_bench.py`` over two 200-utterance dialogues gives the
   wall p50 / p90 / p99 an append and each bucket's stream and busy time a
   forward (``profiling.device_busy_ms``); then the stdio server answers a
   few requests;
5. train: the flagship training step at ``bench.py``'s production settings
   (B = 32 dialogues of U[20, 80] turns, class weights, focal loss, dropout
   0.4, Adam) through ``Trainer.train_step``: one step with the kernels and
   one under ``ops.plain_ops()`` from the same weights and seeds must agree
   in loss and every gradient; then 2 warm-up and 10 timed steps, whose
   launch counts (zeroed just before) must show all four kernels, and
   whose own peak memory is read (``step_peak_mem_gb``); a profiled
   window (device time by kernel, the bi-GRU kernels by name, kernels B
   and D by product); and 20 steps on one batch, whose loss must fall.
   The step is checked once more on bench.py's own draw order, where a few
   ReLU decisions of the GCNII stack lie within rounding of 0 (see 6);
6. meld: MELD at its published depth (GDF with the reason-LSTM, 64 GCNII
   layers, 9 speakers, full widths, the first combination of the
   reference's MELD grid) on ``benchmarks/bench_meld.py``'s batch (B = 32
   dialogues of U[5, 33] turns): the training step against the plain step
   (loss and every gradient; the ReLU decisions of the stack that differ
   between the two are counted, and the plain step is held at the
   kernels' decisions only if the gradients disagree and every differing
   decision lies within the forward's tolerance of 0), 10 timed steps with
   launch counts and a profile; ``StreamingSession`` over three synthetic
   MELD dialogues against the plain model; kernels A and C alone at the
   CRN's 864 party streams (L = 33) beside cuDNN, kernels B (training
   mode) and D at B = 32, N = 99, 64 layers, kernel B's serve designs at
   N = 192, 64 layers; and the command lines: one epoch of
   ``run_train_erc --dataset MELD``, ``--test_label`` on its directory and
   the server answering from it;
7. families: every other multimodal graph family at the flagship's
   widths and batch (GF2 at its fixed 64 layers on the raw-arccos graph,
   DeepGCN at 16 layers with and without the reason-LSTM, GCN3, relation,
   None, each with concat_subsequently): the training step against the
   plain step (GF2's and DeepGCN's held at the kernels' ReLU decisions as
   MELD's), 5 timed steps whose kernel B and D launches must equal the
   documented counts of each GCNII stack call (none for GCN3, relation
   and None), and one served dialogue against the plain model; the fusion
   heads gated, mfn, tfn_only and lmf_only each serve it; kernels B
   (training and serve mode) and D alone at GF2's and DeepGCN's shapes;
8. nonvariant: the original GCNII update (``variant=False``: each
   layer's weight (H, H), kernels B and D on its fold ``[(1-α) W; α W]``):
   kernel B serving at bucket 64 (N = 192, 16 layers, the reason-LSTM)
   and, at the training shapes (B = 32, N = 240, rate 0.4), its training
   mode and kernel D through autograd, each against the unfolded plain
   version (at the kernels' ReLU decisions) and timed beside the same
   call on the variant's weights, with the non-variant function's bound;
   the flagship's step with ``MMGCN(variant=False, reason_flag=True)``
   against the plain step, 3 timed steps (B 49, D 116 a step) and one
   served dialogue against the plain model; DeepGCN's three non-variant
   stacks (N = 80) against the plain step; and the native packer beside
   numpy's at the IEMOCAP and MELD training batches, the same bytes;
9. single: the single-stream path and the non-graph baselines at the
   flagship's batch and settings: early-fusion DeepGCN (a,v,l
   concatenated, 2024 wide, into ``linear_`` and the LSTM base with the
   CRN, 16 layers with the reason-LSTM) against its plain step (held at
   the kernels' ReLU decisions as MELD's) and 10 timed steps with kernels
   A, C, B and D launched and profiled; the GRU, LSTM and DialogRNN
   baselines (general attention) each against its plain step, 5 timed
   steps and one served dialogue of 37 utterances against the plain
   model; the single-stream DeepGCN of the text served (kernel B's serve
   mode); a step check each of the single-stream relation, GCN3 and None
   heads and of relation on the DialogRNN base; and the plain bi-LSTM
   (beside cuDNN's ``nn.LSTM``) and bidirectional DialogueRNN recurrences
   alone at B = 32, L = 80;
10. learn: ``tests/test_torch_learning.py``'s whole run through kernels
   A-D with dropout 0.4 (the flagship, 12 epochs at B = 8 on 96 dialogues
   of a separable synthetic task): best test F1 >= 95, train F1 at the
   best epoch >= 95, epoch-0 train F1 < 60; the per-epoch history, then
   the step alone timed and profiled on the run's batches (median wall,
   device busy and idle share, launches a step);
11. sweep: the grouped sweep (``train/vmap_sweep.py``: one batched step
   over the K configurations' stacked parameters) at the flagship's
   widths on 64 dialogues of U[20, 80] turns.  First kernels A-D with
   their config axis at the training shapes, K = 4: each config-axis
   launch against 4 solo launches, bit for bit, and against the plain
   versions (A, C, B under vmap; D per configuration at its own ReLU
   decisions); B and D with the rates 0, 0.2, 0.4, 0.4 read per
   configuration (B tiled in training mode, and in its eval forwards
   tiled at B = 32 and resident at one dialogue); each configuration's
   layer-0 mask equal to its run alone's, the rate-0 one keeping all;
   the config-axis launches' stream times beside 4 solo launches'.  Then
   the first group of the IEMOCAP grid cut to K = 4 (dropout 0.2 and 0.4
   at two learning rates) trains 2 epochs at B = 32; one combination
   trained alone twice says whether a run repeats itself bit for bit on
   the card, the group's first step against the solo step of two configs
   (one at each dropout) whether the batched step sums as the solo step
   does, and those two configs are held against their runs alone bit for
   bit where both hold (else equal test F-scores and losses within 1e-5
   relative); the group's batch is timed beside the solo step (launches
   a batch equal to one solo step's, peak memory, device busy and idle
   share), and the grid's whole first group (K = 16) over 3 batches; and
   ``cli.sweep --vmap --limit 4 --epochs 1`` runs twice on one directory,
   the second skipping the finished group with the same
   ``summary.jsonl``;
12. daily: DailyDialogue at the JAX package's default widths (the
   TextCNN over 20 words of a 5000-word table, 300-wide embeddings, 50
   filters of widths 3, 4, 5; D_e 100, D_g = D_p 150, windows 10/10) on
   ``make_synthetic_daily_pickle``'s token batches (B = 32 dialogues of
   U[3, 35] turns, bucket 48): the GRU base's step against its plain step
   and 10 timed steps (launches a step exactly A 2, C 2, B 0, D 0; the
   convolutions and the embedding backward named in the profile),
   kernels A and C alone at that shape; the LSTM, None and DialogRNN
   bases each one step on the card against the same step on the CPU
   (dropout off, the TextCNN's included: the card's and the CPU's
   generators draw different bits), and 3 timed LSTM steps; the command
   lines (one epoch of ``run_train_erc --dataset DailyDialogue
   --base_model GRU``, ``--test_label`` on its directory, whose
   predictions must equal ``DailyTrainer.evaluate``'s of the saved
   weights); a frozen pretrained table bit-equal after a step that moved
   ``fc``;
13. raw: the raw-input model (``RawInputDialogueGNN``: a log-mel
   frontend over 3 s of 16 kHz audio and a DenseNet-BC over 48 x 48 x 3
   face crops, in front of the flagship at its widths, 16 layers with the
   reason-LSTM, dropout 0.4) on the train phase's batch recipe (B = 32, L
   <= 80): its log-probs with the kernels against the plain versions, the
   step against the plain step (held at the kernels' ReLU decisions as
   MELD's), 10 timed steps (exactly A 4, C 4, B 49, D 116 a step; cuDNN's
   convolutions, GroupNorm and the products by operator), the busy time
   and idle share of 3 steps (``profiling.device_time_ms``), the log-mel
   spectrogram alone at the step's 2560 waveforms (before the model runs
   and after the steps, by kernel), both frontends' gradients nonzero, one
   step's gradient histograms (64 bins, reduced on the card) against
   numpy's of the same gradients on the host, and 6 Adam steps without
   dropout at the flagship's lr 3e-4 whose loss must fall (and 6 at 3e-3,
   with the kernels and with the plain versions, reported);
14. cores: which core runs kernels B's and D's tiled products (the f32
   mode's on the tensor cores as 3xTF32, the bf16 modes' on the CUDA
   cores): at the flagship's and GF2's shapes the program's counter
   ``ops.gcnii_tc_products`` equals the tensor-core launches a profile
   shows, every product in the f32 mode and none in the bf16 modes; and
   the bf16 modes' outputs carry the digests the CUDA-core core recorded
   (``mmdfn_torch/tools/cuda_core_digests.json``) where the toolchain and
   card are that file's;
15. fast: the JAX package's production configuration (``--tpu_fast``,
   ``gcn_backend='pallas'``), kernels B and D in their bf16 mode (the TPU
   training kernel's numerics; one tiled design): at the training shapes
   (B = 32, N = 240, 16 layers, rate 0.4) B's training mode against its
   plain bf16 version (the three bf16 residual slabs too) and D against
   its plain bf16 backward at its own ReLU decisions (read from its tdpre
   slab; each that differs from the plain recompute on the same slabs
   within ``BF16_RTOL`` of max |h| of 0), each held by ``bf16_agree`` (at
   most ``BF16_SHARE`` of the elements past ``BF16_RTOL`` of the scale,
   one bf16 step of the element beside it for the outputs that are
   rounded to bf16, none past ``BF16_CAP`` of the scale beside that step)
   and timed beside the f32 mode in the same call;
   the residual bytes of both modes; B serving one dialogue at bucket 64
   against plain, beside the f32 mode's design; a config axis of 4
   (rates 0, 0.2, 0.4, 0.4) bit for bit its 4 solo calls; then the
   flagship step built by ``run_train_erc``'s ``--tpu_fast`` on the train
   phase's batch recipe: exactly A 4, C 4, B 49, D 116, its loss and
   gradients against the plain bf16 step held at kernel D's decisions, 10
   timed steps beside 10 parity steps (busy, host enqueue, idle share,
   peak), and one served 37-utterance dialogue against the plain model
   (49 launches of B an append);
16. scan: JAX's bf16 layer scan (``gcn_compute_dtype='bfloat16'`` where no
   fused kernel runs), kernels B and D in their bf16 scan mode (every op
   rounded to bf16, the carries bf16; the tiled design): at GF2's shape
   (B = 32, N = 240, 64 layers, no LSTM, rate 0.4, the last dropout in
   f32), the flagship's (16 layers, the reason-LSTM), DeepGCN's (N = 80,
   rate 0) and the non-variant MMGCN's (W (H, H) unfolded), B's training
   mode and its slabs against the plain scan and D on them against the
   plain walk at its own ReLU decisions (each that differs from the plain
   recompute within ``SCAN_DECISION_STEPS`` bf16 steps of max |h| of 0),
   every output a bf16 value, each held by ``scan_agree`` (at most
   ``SCAN_SHARE`` of the elements differ, none by more than
   ``SCAN_CAP_STEPS`` bf16 steps of the scale), timed beside the f32 and
   bf16 modes in the same call; then the GF2 and DeepGCN steps built by
   ``run_train_erc``'s ``--tpu_fast`` and the flagship's with
   ``variant=False`` stacks, each against its plain step held at kernel
   D's decisions of every stack call (the launches of the scan mode, the
   loss, every gradient within ``SCAN_GRAD_STEPS`` bf16 steps of its max
   |.|), 10 timed steps, and one served 37-utterance dialogue of GF2 and
   of DeepGCN against the plain model;
17. rnn_bf16: the encoders' bf16 recurrence (``rnn_compute_dtype=
   'bfloat16'``), kernels A and C in their bf16 scan mode (JAX's bf16
   ``_gru_scan``: every op rounded to bf16, h and dh carried in bf16,
   dW_hh and db_hh summed step by step and then over the steps in bf16):
   A at the serve shapes (B = 6, L = 64 and 200) and A and C at the
   training step's (B = 32 and 192, L = 80) against the plain scan and
   the plain walk, each held by ``scan_agree`` (dW_hh and db_hh within
   ``RNN_W_STEPS`` bf16 steps of their max), C twice for the same bits,
   timed beside the f32 mode in the same call, the plain versions and
   cuDNN's GRU on bf16 tensors; a config axis of 4 bit for bit its 4
   solo launches; then the flagship step built by ``run_train_erc`` with
   ``--rnn_compute_dtype bfloat16`` alone (the encoders in the scan mode)
   and with ``--tpu_fast`` (their bf16 mode: the f32 kernels on bf16
   operands), each against its plain step (loss, every gradient within
   ``SCAN_GRAD_STEPS`` bf16 steps of its max), exactly A 4, C 4, B 49, D
   116 a step, 10 timed steps each (the train phase times the parity
   step in the same call), and one served 37-utterance dialogue each
   against the plain model;
18. parallel: the multi-device layer on the one card, its ranks started
   by ``runtime/launch.py`` (two ranks share the card over gloo, so their
   walls measure sharing, not scaling): (a) the flagship at the train
   phase's settings, dropout 0, on 2 data ranks of 16 dialogues (B = 32
   global), 2 steps each through kernels A-D (exactly A 4, C 4, B 49, D
   116 a step on each rank), held against the one-process step on the
   same batches (loss, and every gradient of the first step); (b) the same
   at dropout 0.4: finite losses, and on a batch whose two halves hold the
   same dialogues the two data ranks' training forwards differ (each draws
   its own dropout masks, kernel B's among them); (c) 2 model ranks,
   the GCNII stack node-sharded (its plain version with the sharded
   product; kernels A and C only), one step against the one-process plain
   step, held at the sharded step's ReLU decisions only where the
   gradients disagree and every differing decision lies within the
   forward's tolerance of 0; each rank's step wall, device busy and host
   ms in collectives; (d) one epoch of ``run_train_erc --n_data_devices
   1`` (NCCL, one rank) whose lines must equal the flagless run's; (e)
   ``cli.sweep --vmap`` on the first IEMOCAP group cut to K = 4, one
   epoch, over 2 ranks of the card (``--device cuda:0 --n_data_devices
   2``), whose configs' histories must equal the one-process group's, bit
   for bit.

It prints a line per phase, the seconds each took (``phase_s``, beside
the profiler windows that ``device_ms`` had to open again), a
``{"kernels": [...]}`` line, the nvidia-smi line and, last,
``{"ok": true, "device": {...}}``.  Without a card, or without the
``mmdfn_torch`` package beside it, it exits nonzero before any result.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, at the full 700 W power limit; bf16
# on the tensor cores, dense)
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
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
PROFILE_TRIES = 3        # torch.profiler windows that device_ms opens before
                         # it falls back to the stream time
PROFILE_MISSES = []      # the device_ms windows that saw no kernel
SMI = None               # the card's name and power limit (nvidia-smi)
CLI_TOL = 2e-4           # the server rounds log-probs to 4 decimals
STEP_LOSS_RTOL = 1e-5    # training step, kernels vs plain: the loss
STEP_GRAD_RTOL = 1e-4    # and every gradient, of its max |.|
MELD_NLAYERS = 64        # MELD's published depth (the reference's MELD grid)
MELD_B, MELD_L = 32, 33  # benchmarks/bench_meld.py: 32 dialogues of 5-33 turns


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def bound(nbytes: float, flops: float, bf16_flops: float = 0.0) -> dict:
    """The least time for the work: its bytes at the memory rate, or its
    f32 operations and its products on bf16 operands each at its type's
    peak, whichever is longer."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = (flops / PEAK_FP32_FLOPS + bf16_flops / PEAK_BF16_FLOPS) * 1e3
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


def wall_ms(torch, fn) -> float:
    """One call's wall time, ended by a synchronize: for a plain version of
    thousands of small launches, paced by the host, timed once."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def device_ms(torch, fn, reps: int) -> float:
    """Device time per call: the union of the intervals in which the kernels
    that ``fn`` launches ran, from torch.profiler over ``reps`` calls.  For
    library calls whose host time (autograd's engine) may exceed their
    device time: the gaps in which the card waits for the host are not
    counted, and kernels that run at once on several streams (cuDNN runs a
    bidirectional GRU's two directions side by side) are counted once.  A
    window in which the profiler saw no kernel is opened again, up to
    ``PROFILE_TRIES`` times, and is named in ``PROFILE_MISSES``; if none
    saw one, the stream time (``time_ms``) stands in."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and not getattr(e, "is_user_annotation", False))
        if spans:
            break
        PROFILE_MISSES.append(getattr(fn, "__qualname__", repr(fn)))
    if not spans:
        # the stream time over chained calls after a head start: it counts
        # kernels that overlap on two streams twice
        return time_ms(torch, fn, reps)
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


# the kernels of kernels B and D: each tiled product is named by its
# epilogue's type
# (the bf16 scan mode's, named ...S, first: a name may hold another)
KERNEL_B_PARTS = ("F1GateS", "F1CellS", "F2HiS", "F3UpdateS", "F1Cell",
                  "F2Hi", "F3Update", "gcnii_fwd_init", "gcnii_layer_kernel",
                  "gcnii_resident_kernel")
KERNEL_D_PARTS = ("P1GateS", "P1CellS", "P2HiS", "P3PreS", "P4DProjS",
                  "P5DAdjS", "P6LstmS", "P7LstmInS", "P1Gates", "P1CellB",
                  "P2Hi", "P3Pre", "P4DProj", "P5DAdj", "P6Lstm", "P7LstmIn",
                  "WgradW", "WgradLstm", "gcnii_reduce_kernel",
                  "gcnii_scan_lstm_reduce_kernel")


def kernel_label(key: str) -> str:
    """A short name for a profiler key: kernel B's or D's product, else the
    key's head."""
    for lib, parts in (("gcnii_fwd", KERNEL_B_PARTS),
                       ("gcnii_bwd", KERNEL_D_PARTS)):
        part = next((p for p in parts if p in key), None)
        if part:
            return f"{lib} {part}"
    return key[:40]


def by_part(kern, lib: str, per: int) -> list:
    """Device ms and launches per step (of ``per``) of one kernel's parts."""
    acc = {}
    for e in kern:
        if kernel_label(e.key).startswith(lib):
            t = acc.setdefault(kernel_label(e.key), [0.0, 0.0])
            t[0] += e.self_device_time_total / 1e3 / per
            t[1] += e.count / per
    return sorted([k, *v] for k, v in acc.items())


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
    from mmdfn_torch.config import flagship_config
    from mmdfn_torch.data.datasets import IEMOCAPDataset
    from mmdfn_torch.data.synthetic import make_synthetic_iemocap_pickle
    from mmdfn_torch.serve import measure_latency
    from mmdfn_torch.weights import build_model

    cfg = flagship_config(seed=SEED)
    model = build_model(cfg)
    with tempfile.TemporaryDirectory() as tmp:
        make_synthetic_iemocap_pickle(f"{tmp}/iem.pkl", n_train=1, n_test=3,
                                      min_len=20, max_len=60, seed=SEED)
        dialogues = IEMOCAPDataset(f"{tmp}/iem.pkl", train=False).dialogues()
    session, logps, out = serve_check(torch, dev, cfg, model, dialogues)
    stats = measure_latency(model, cfg, dialogues, device=dev)
    return {**out, "profile": profile_phase(torch, session, 64),
            "device_ms_by_bucket": stats["device_ms_by_bucket"],
            "latency_bench_p50_ms": stats["p50_ms"],
            "latency_bench_200": latency_200(dev),
            "cli": cli_phase(dialogues[0], logps[:3])}


def latency_200(dev) -> dict:
    """``serve/latency_bench.py`` on the flagship (weights from SEED) over
    two dialogues of 200 utterances (a third warms up): the wall p50 / p90
    / p99 per append against PERF.md's p99 <= 50 ms (reported, not held),
    and per bucket the stream time and the busy time of a forward
    (``profiling.device_busy_ms``)."""
    from mmdfn_torch.config import flagship_config
    from mmdfn_torch.data.batching import SERVE_BUCKETS
    from mmdfn_torch.serve import latency_bench

    bench = latency_bench.run(cfg=flagship_config(seed=SEED), n_dialogues=2,
                              min_len=200, max_len=200, seed=SEED,
                              device=dev)
    busy = bench["device_busy_ms_by_bucket"]
    check(bench["n"] == 400 and bench["buckets_used"] == list(SERVE_BUCKETS)
          and sorted(map(int, busy)) == list(SERVE_BUCKETS),
          f"latency bench over 200-utterance dialogues: {bench}")
    check(all(math.isfinite(bench[k]) and bench[k] > 0 for k in
              ("p50_ms", "p99_ms", "device_busy_p50_ms"))
          and all(v > 0 for v in busy.values()),
          f"latency bench readings: {bench}")
    keys = ("p50_ms", "p90_ms", "p99_ms", "mean_ms", "device_p50_ms",
            "device_p99_ms", "device_busy_p50_ms", "device_ms_by_bucket",
            "device_busy_ms_by_bucket", "model", "n")
    return {k: bench[k] for k in keys}


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
            "gcnii_fwd_kernels": by_part(kern, "gcnii_fwd", reps),
            "top": [[kernel_label(e.key), e.self_device_time_total / 1e3
                     / reps, e.count / reps] for e in top]}


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


def gcnii_case(torch, dev, L, reason=True, nl=NLAYERS,
               modalities=3) -> dict:
    """Kernel B at bucket L: one dialogue, N = modalities x L nodes (one
    modality: DeepGCN's block graph), ``nl`` layers; every design checked
    and timed, ``ms`` the one the wrapper picks."""
    from mmdfn_torch.graph.adjacency import mm_big_adjacency
    from mmdfn_torch.ops import gcnii_stack_fwd, gcnii_stack_plain
    from mmdfn_torch.ops.bigru import _sm_count
    from mmdfn_torch.ops.gcnii import DESIGNS, _design, _forward

    g = torch.Generator().manual_seed(L)
    umask = torch.ones(1, L)
    adj = mm_big_adjacency([torch.randn(1, L, 2 * H, generator=g)
                            for _ in range(modalities)], umask).to(dev)
    N = modalities * L
    u = lambda *s: (torch.rand(*s, generator=g) * 0.2 - 0.1).to(dev)
    h = torch.relu(torch.randn(1, N, H, generator=g)).to(dev)
    theta = torch.log(0.5 / torch.arange(1, nl + 1) + 1.0).to(dev)
    lstm = (u(4 * H, H).t(), u(4 * H, H).t(), u(4 * H)) if reason else ()
    args = (adj, h, h, u(nl, 2 * H, H), theta, *lstm)
    run = lambda: gcnii_stack_fwd(*args, alpha=0.2, reason=reason)
    plain = lambda: gcnii_stack_plain(*args, alpha=0.2, reason=reason)
    want = plain()
    tol = KERNEL_B_RTOL * max(1.0, float(want.abs().max()))
    err, ms_by_design = 0.0, {}
    for name, design in DESIGNS.items():
        fwd = lambda: _forward(*args, *(None,) * (8 - len(args)), alpha=0.2,
                               reason=reason, rate=0.0, seed=None,
                               residuals=None, design=design)
        got = fwd()
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        check(e <= tol, f"GCNII kernel ({name}) vs plain at N={N}: {e} > "
                        f"{tol}")
        err = max(err, e)
        ms_by_design[name] = time_ms(torch, fwd, 20)
    chosen = next(k for k, v in DESIGNS.items()
                  if v == _design(1, N, _sm_count(dev)))
    nbytes = 4 * (N * N + 3 * N * H + nl * (2 * H * H + 1)
                  + (2 * H * 4 * H + 4 * H if reason else 0))
    # per layer: adj @ h1, the two support products, the update (~6 N H);
    # with reason, the LSTM step's two (N, H) @ (H, 4H) products and gates
    flops = nl * (2 * N * N * H + 4 * N * H * H + 6 * N * H)
    if reason:
        flops += nl * (16 * N * H * H + 12 * N * H)
    return {"shape": f"B=1 N={N} H={H} layers={nl} reason={reason}",
            "max_abs_err": err, "tolerance": tol, "design": chosen,
            "ms": time_ms(torch, run, 20), "ms_by_design": ms_by_design,
            "plain_ms": time_ms(torch, plain, 5),
            "library_ms": None, **bound(nbytes, flops)}


def gcnii_crossover(torch, dev, L=TRAIN_L) -> list:
    """Kernel B's designs at N = 3L = 240 (16 layers, reason) for B = 1 ..
    32 dialogues of U[20, L] turns, in inference mode and in training mode
    (dropout, residual slabs): each checked against the plain version and
    timed, beside the one the wrapper picks."""
    from mmdfn_torch.ops import gcnii_stack_plain
    from mmdfn_torch.ops.bigru import _sm_count
    from mmdfn_torch.ops.gcnii import DESIGNS, RESIDUALS, _design, _forward

    N, rows = 3 * L, []
    for B in (1, 2, 4, 8, 16, 32):
        args, _ = gcnii_train_inputs(torch, dev, B, L, seed=40 + B)
        seed = torch.tensor([SEED + B], dtype=torch.int64, device=dev)
        ms, train_ms = {}, {}
        for mode, opts, out_ms in (
                ("inference", dict(rate=0.0, seed=None), ms),
                ("training", dict(rate=RATE, seed=seed), train_ms)):
            slabs = lambda: ([torch.empty(B, NLAYERS, N, H, device=dev)
                              for _ in RESIDUALS] if opts["seed"] is not None
                             else None)
            want = gcnii_stack_plain(*args, alpha=0.2, reason=True,
                                     residuals=slabs(), **opts)
            tol = KERNEL_B_RTOL * max(1.0, float(want.abs().max()))
            for name, design in DESIGNS.items():
                res = slabs()
                fwd = lambda: _forward(*args, alpha=0.2, reason=True,
                                       residuals=res, design=design, **opts)
                e = float((fwd() - want).abs().max())
                check(e <= tol, f"GCNII kernel ({name}, {mode}) vs plain at "
                                f"B={B} N={N}: {e} > {tol}")
                out_ms[name] = time_ms(torch, fwd, 10)
        chosen = next(k for k, v in DESIGNS.items()
                      if v == _design(B, N, _sm_count(dev)))
        rows.append({"B": B, "N": N, "ms_by_design": ms,
                     "train_ms_by_design": train_ms, "design": chosen})
    return rows


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


def gcnii_train_inputs(torch, dev, B, L, seed=4, nl=NLAYERS, lo=20,
                       wiring="GDF"):
    """The GCNII stack's operands for B dialogues of U[lo, L] turns as a
    wiring gives them: "GDF" (MM-DFN: the angular cross-modal graph, N =
    3L, the reason-LSTM, h = dropout(h0)); "GF2" (the raw-arccos graph with
    constant cross edges, N = 3L, no LSTM, h = dropout(h0)); "DeepGCN"
    (one modality's angular block graph, N = L, no LSTM, h = h0)."""
    from mmdfn_torch.graph.adjacency import (gcnii_block_adjacency,
                                             mm_big_adjacency)

    g = torch.Generator().manual_seed(seed)
    lengths = torch.randint(lo, L + 1, (B,), generator=g)
    umask = (torch.arange(L)[None] < lengths[:, None]).float()
    feats = [torch.randn(B, L, 2 * H, generator=g) * umask[..., None]
             for _ in range(3)]
    if wiring == "DeepGCN":
        adj, N = gcnii_block_adjacency(feats[0], umask).to(dev), L
    else:
        kw = (dict(variant="arccos", cross_constant=0.99999)
              if wiring == "GF2" else {})
        adj, N = mm_big_adjacency(feats, umask, **kw).to(dev), 3 * L
    u = lambda *s: (torch.rand(*s, generator=g) * 0.2 - 0.1).to(dev)
    h0 = torch.relu(torch.randn(B, N, H, generator=g)).to(dev)
    h = h0 * (torch.rand(B, N, H, generator=g) < 1 - RATE).to(dev) \
        / (1 - RATE)
    if wiring == "DeepGCN":
        h = h0
    theta = torch.log(0.5 / torch.arange(1, nl + 1) + 1.0).to(dev)
    W = u(nl, 2 * H, H)           # drawn before the LSTM's, as always
    lstm = ((u(4 * H, H).t(), u(4 * H, H).t(), u(4 * H)) if wiring == "GDF"
            else (None,) * 3)
    return (adj, h, h0, W, theta, *lstm), g


def gcnii_train_case(torch, dev, B, L, nl=NLAYERS, lo=20,
                     wiring="GDF") -> dict:
    """Kernel B's training mode (dropout, residuals) and kernel D at the
    training shapes (B dialogues of U[lo, L] turns, ``nl`` layers), each
    against its plain version; kernel D on the residuals kernel B wrote, at
    its own ReLU decisions.  ``wiring`` as in :func:`gcnii_train_inputs`:
    GF2's stack has no reason-LSTM and alpha 0.1, DeepGCN's also runs at
    rate 0 with no seed."""
    from mmdfn_torch.ops import (gcnii_stack_bwd, gcnii_stack_bwd_plain,
                                 gcnii_stack_fwd, gcnii_stack_plain)
    from mmdfn_torch.ops.gcnii import (ROWWISE, RESIDUALS, TILED, _forward,
                                       _lstm_step, gcnii_bwd_splits)

    args, g = gcnii_train_inputs(torch, dev, B, L, nl=nl, lo=lo,
                                 wiring=wiring)
    adj, h, h0, W, theta, ih, hh, lb = args
    N = h.shape[1]
    reason, r = wiring == "GDF", int(wiring == "GDF")
    rate = 0.0 if wiring == "DeepGCN" else RATE
    seed = (torch.tensor([SEED + 12345], dtype=torch.int64, device=dev)
            if rate else None)
    # the slabs without reason as GCNIIStackTrain gives them: lh, lc zero
    slabs = lambda: [torch.zeros(B, nl, N, H, device=dev)
                     for _ in RESIDUALS]
    res, res_p = slabs(), slabs()
    opts = dict(alpha=0.2 if reason else 0.1, reason=reason, rate=rate,
                seed=seed)
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
    # the row-wise design, the one before the tiled products, beside it
    res_r = slabs()
    fwd_rowwise = lambda: _forward(*args, residuals=res_r, design=ROWWISE,
                                   **opts)
    rowwise_err = max(float((a - b).abs().max()) for a, b in
                      zip([fwd_rowwise(), *res_r], [want, *res_p]))
    check(rowwise_err <= fwd_tol,
          f"GCNII training forward (row-wise) vs plain: {rowwise_err}")

    dh = torch.randn(B, N, H, generator=g).to(dev)
    bwd_args = (adj, h0, W, theta, ih, hh, lb, res, dh)
    bwd = lambda: gcnii_stack_bwd(*bwd_args, **opts)
    bwd_plain = lambda: gcnii_stack_bwd_plain(*bwd_args, **opts)
    got = bwd()
    torch.cuda.synchronize()

    # Kernel D's ReLU decisions.  Its hi and pre products (P2, P3) are
    # kernel B's tiled F2 and F3 on the same operands, so kernel B's tiled
    # path, one layer at a time on the stored h1 without reason or dropout,
    # returns relu(pre) as kernel D forms pre.  They may differ from the
    # plain recompute's only where pre is within the forward's tolerance of
    # 0, where the two summation orders may round either way; there one
    # flipped decision moves a gradient by up to several percent.
    alpha = opts["alpha"]
    masks, flips, flip_pre = [], 0, 0.0
    for l in range(nl):
        masks.append(_forward(
            adj, res[3][:, l].contiguous(), h0, W[l:l + 1], theta[l:l + 1],
            None, None, None, alpha=alpha, reason=False, rate=0.0,
            seed=None, residuals=None, design=TILED) > 0)
        h1 = (_lstm_step(res[0][:, l], res[1][:, l], res[2][:, l], ih, hh,
                         lb)[0] if reason else res[0][:, l])
        hi = adj @ h1
        pre = theta[l] * (hi @ W[l, :H] + h0 @ W[l, H:]) \
            + (1.0 - theta[l]) * ((1.0 - alpha) * hi + alpha * h0)
        differ = masks[l] != (pre > 0.0)
        flips += int(differ.sum())
        if bool(differ.any()):
            flip_pre = max(flip_pre, float(pre[differ].abs().max()))
    check(flip_pre <= fwd_tol, f"kernel D's ReLU decisions differ from the "
                               f"plain recompute at |pre| = {flip_pre}")
    ref = gcnii_stack_bwd_plain(*bwd_args, relu_masks=masks, **opts)
    at_plain = bwd_plain()
    bwd_err, plain_rel = 0.0, {}
    names = ("d_adj", "d_h", "d_h0", "dW", "dW_ih", "dW_hh", "db")
    for name, a, b, c in zip(names[:7 if reason else 4], got, ref,
                             at_plain):
        e = float((a - b).abs().max())
        tol = KERNEL_D_RTOL * float(b.abs().max())
        check(e <= tol, f"GCNII bwd kernel vs plain, {name}: {e} > {tol}")
        bwd_err = max(bwd_err, e)
        plain_rel[name] = float((a - c).abs().max() / c.abs().max())

    R = B * N
    # with r = 1 for the reason-LSTM: per layer adj @ h1, the support
    # products (4 B N H^2) and the LSTM step (16 B N H^2); elementwise
    layer_fwd = 2 * B * N * N * H + (4 + 16 * r) * R * H * H
    fwd_flops = nl * (layer_fwd + 20 * R * H)
    # adj, h, h0, W, theta, LSTM in; h and the residual slabs out (four
    # with the LSTM, h and h1 without)
    fwd_bytes = 4 * (B * N * N + 2 * R * H + nl * (2 * H * H + 1)
                     + r * (2 * 4 * H * H + 4 * H) + R * H
                     + (2 + 2 * r) * nl * R * H)
    # per layer: adj @ h1, adj^T d_hi, d_hi h1^T (6 B N^2 H); the support
    # products, their transposes and dW (12 B N H^2); the LSTM recompute,
    # its input gradients and dW_ih, dW_hh (48 B N H^2 - not counting the
    # bias row); elementwise ~40 B N H
    bwd_flops = nl * (6 * B * N * N * H + (12 + 48 * r) * R * H * H
                      + 40 * R * H)
    # adj, h0, W, the LSTM, four residual slabs and dh in; d_adj, d_h,
    # d_h0, dW and the LSTM gradients out; and what this design keeps
    # between its products, each written once and read once: the gates
    # (R, 4H) of every layer, the hi and tdpre slabs (nl, R, H), the dgates
    # slab (nl, R, 4H), and the weight-gradient partials (no transposed
    # weight copies)
    splits_w, splits_l = gcnii_bwd_splits(R, nl)
    scratch = (r * nl * R * 4 * H + 2 * nl * R * H + r * nl * R * 4 * H
               + nl * splits_w * 2 * H * H
               + r * splits_l * (2 * H + 1) * 4 * H)
    bwd_bytes = 4 * (2 * B * N * N + 4 * R * H + 2 * nl * 2 * H * H
                     + r * 2 * (8 * H * H + 4 * H) + (2 + 2 * r) * nl * R * H
                     + 2 * scratch)
    shape = f"B={B} N={N} H={H} layers={nl} reason={reason} rate={rate}"
    return {
        "fwd": {"shape": f"{shape} residuals", "max_abs_err": fwd_err,
                "tolerance": fwd_tol, "ms": time_ms(torch, fwd, 10),
                "rowwise_ms": time_ms(torch, fwd_rowwise, 10),
                "plain_ms": time_ms(torch, fwd_plain, 2),
                "library_ms": None, **bound(fwd_bytes, fwd_flops)},
        "bwd": {"shape": shape, "max_abs_err": bwd_err,
                "relu_decisions_differing_from_plain": flips,
                "max_abs_pre_where_they_differ": flip_pre,
                "rel_err_vs_plain_at_plain_decisions": plain_rel,
                "ms": time_ms(torch, bwd, 10),
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


def train_batch(torch, rng, dev, B=TRAIN_B, L=TRAIN_L,
                labels_last=False) -> dict:
    """bench.py's make_batch recipe: lengths U[20, L], random speakers,
    standard-normal features, random labels; on the card.  The labels are
    drawn before the features, or after them as bench.py draws them with
    ``labels_last``."""
    import numpy as np

    lengths = rng.integers(20, L + 1, size=B)
    umask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32)
    spk = rng.integers(0, 2, size=(B, L))
    qmask = np.zeros((B, L, 2), np.float32)
    qmask[np.arange(B)[:, None], np.arange(L)[None, :], spk] = 1.0
    qmask *= umask[..., None]
    feat = lambda D: (rng.standard_normal((B, L, D), dtype=np.float32)
                      * umask[..., None])
    label = lambda: (rng.integers(0, 6, size=(B, L)) * umask).astype(
        np.int64)
    first = None if labels_last else label()
    arrays = dict(text=feat(100), audio=feat(1582), visual=feat(342),
                  qmask=qmask, umask=umask)
    arrays["label"] = label() if labels_last else first
    return {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}


def meld_batch(torch, rng, dev, B=MELD_B, L=MELD_L, speakers=9) -> dict:
    """``benchmarks/bench_meld.py``'s make_batch recipe: lengths U[5, L],
    speakers of 9, standard-normal features of MELD's widths (text 600,
    audio 300, visual 342), then labels of 7 classes; on the card."""
    import numpy as np

    lengths = rng.integers(5, L + 1, size=B)
    umask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32)
    spk = rng.integers(0, speakers, size=(B, L))
    qmask = np.zeros((B, L, speakers), np.float32)
    qmask[np.arange(B)[:, None], np.arange(L)[None, :], spk] = 1.0
    qmask *= umask[..., None]
    feat = lambda D: (rng.standard_normal((B, L, D), dtype=np.float32)
                      * umask[..., None])
    arrays = dict(text=feat(600), audio=feat(300), visual=feat(342),
                  qmask=qmask, umask=umask)
    arrays["label"] = (rng.integers(0, 7, size=(B, L)) * umask).astype(
        np.int64)
    return {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}


class StackRecorder:
    """Within the block, keeps the operands of every GCNII stack call that
    the model makes (``nn/gcn.py``'s ``gcnii_stack_fwd``), detached."""

    def __enter__(self):
        from mmdfn_torch.nn import gcn

        self.calls, self._orig = [], gcn.gcnii_stack_fwd

        def record(*args, **kw):
            self.calls.append((tuple(None if a is None else a.detach()
                                     for a in args), dict(kw)))
            return self._orig(*args, **kw)
        gcn.gcnii_stack_fwd = record
        return self

    def __exit__(self, *exc):
        from mmdfn_torch.nn import gcn

        gcn.gcnii_stack_fwd = self._orig


def relu_decisions(torch, args, kw, plain_args):
    """The kernels' ReLU decisions in the GCNII stack call ``(args, kw)``
    (kernel B in training mode, then per layer kernel B's tiled F2 and F3
    on the stored h1, which are kernel D's P2 and P3 on the same operands),
    and where they differ from the plain recompute's ``pre > 0`` on the
    plain step's operands ``plain_args``: (masks, flips, max |pre| among
    the flips, the forward's tolerance).  Without the variant the kernels
    run on W's fold and the plain recompute takes ``r @ W``."""
    from mmdfn_torch.ops import (fold_weights, gcnii_stack_fwd,
                                 gcnii_stack_plain)
    from mmdfn_torch.ops.gcnii import RESIDUALS, TILED, _forward

    adj, h, h0, W, theta, ih, hh, lb = args
    B, N, Hh = h.shape
    nl = W.shape[0]
    slabs = lambda: [torch.zeros(B, nl, N, Hh, device=h.device)
                     for _ in RESIDUALS]
    res, res_p = slabs(), slabs()
    kw = {k: v for k, v in kw.items() if k != "folded"}
    variant, alpha = kw.get("variant", True), kw["alpha"]
    with torch.no_grad():
        gcnii_stack_fwd(*args, residuals=res, **kw)
        want = gcnii_stack_plain(*plain_args, residuals=res_p, **kw)
        tol = KERNEL_B_RTOL * max(1.0, float(want.abs().max()))
        adj_p, _, h0_p, W_p, theta_p = plain_args[:5]
        W_k = W if variant else fold_weights(W, alpha)
        masks, flips, flip_pre = [], 0, 0.0
        for l in range(nl):
            masks.append(_forward(
                adj, res[3][:, l].contiguous(), h0, W_k[l:l + 1],
                theta[l:l + 1], None, None, None, alpha=alpha, reason=False,
                rate=0.0, seed=None, residuals=None, design=TILED) > 0)
            hi = adj_p @ res_p[3][:, l]
            r = (1.0 - alpha) * hi + alpha * h0_p
            support = (hi @ W_p[l, :Hh] + h0_p @ W_p[l, Hh:] if variant
                       else r @ W_p[l])
            pre = theta_p[l] * support + (1.0 - theta_p[l]) * r
            differ = masks[l] != (pre > 0.0)
            flips += int(differ.sum())
            if bool(differ.any()):
                flip_pre = max(flip_pre, float(pre[differ].abs().max()))
    return masks, flips, flip_pre, tol


def stack_calls(cfg, L: int) -> list:
    """(layers, reason, nodes) of each GCNII stack call that the config's
    model makes in a forward at length L: one over the 3L nodes of the
    stacked modalities (GF, GDF; GF2 at its 64 layers), one per modality
    (DeepGCN; one for its single stream), or none."""
    gt, M = cfg.graph_type, len(cfg.modals)
    if not cfg.graph_model or cfg.dataset == "DailyDialogue":
        return []
    if gt == "GF2":
        return [(64, False, M * L)]
    if gt == "DeepGCN":
        return [(cfg.Deep_GCN_nlayers, cfg.reason_flag, L)] * (
            M if cfg.multi_modal_path else 1)
    if gt in ("GF", "GDF"):
        return [(cfg.Deep_GCN_nlayers, cfg.reason_flag and gt == "GDF",
                 M * L)]
    return []


def stack_mode(model) -> str:
    """The numerics mode of the model's GCNII stacks (``ops.gcnii``'s
    modes; one per model), or 'f32' where it has none."""
    from mmdfn_torch.nn.gcn import GCNIIStack

    modes = {m.mode for m in model.modules() if isinstance(m, GCNIIStack)}
    check(len(modes) <= 1, f"the model's stacks run in modes {modes}")
    return modes.pop() if modes else "f32"


def stack_design(model, B: int, N: int, sms: int) -> int:
    """Kernel B's design for the model's GCNII stacks at B dialogues of N
    nodes: the tiled design where they run in a bf16 mode, else the one
    ``_design`` picks by shape."""
    from mmdfn_torch.ops.gcnii import TILED, _design

    if stack_mode(model) != "f32":
        return TILED
    return _design(B, N, sms)


def gru_encoders(model) -> int:
    """The model's bi-GRU encoders: each launches kernel A (C in
    training) twice a forward; the bi-LSTM and the DialogueRNN launch no
    kernel."""
    from mmdfn_torch.nn.rnn import BiRNN

    return sum(isinstance(m, BiRNN) and m.cell == "gru"
               for m in model.modules())


def trainer_for(cfg, dev, build=None):
    """The trainer a user of the config runs: ``DailyTrainer`` for
    DailyDialogue's token batches, else ``Trainer``; on the model that
    ``build(cfg)`` makes, else on the config's own."""
    from mmdfn_torch.train import DailyTrainer, Trainer

    cls = DailyTrainer if cfg.dataset == "DailyDialogue" else Trainer
    return cls(cfg, device=dev, model=None if build is None else build(cfg))


def step_check(torch, dev, cfg, batch, hold_decisions=False,
               build=None, grad_rtol=STEP_GRAD_RTOL) -> dict:
    """One training step with the kernels and one under ``ops.plain_ops()``
    from the same weights (``cfg.seed``; ``build`` as in
    :func:`trainer_for`) and step seed: the loss to
    ``STEP_LOSS_RTOL`` relative and every parameter's gradient to
    ``grad_rtol`` of its max |.|; the kernel step must launch kernels
    A and C, and B and D where the model has a GCNII stack.

    With ``hold_decisions`` it also counts the GCNII stack's ReLU decisions
    that differ between the two steps; if the gradients then disagree, the
    plain step runs again at the kernels' decisions (kernel D and the plain
    backward recompute the ReLU's input in two f32 summation orders, and a
    flipped decision moves a gradient by up to percents), which is allowed
    only where every flipped decision's |pre| is within the forward's
    tolerance of 0."""
    import contextlib

    from mmdfn_torch import ops
    from mmdfn_torch.ops import gcnii as gcnii_ops

    def one_step(plain, masks=None):
        tr = trainer_for(cfg, dev, build)
        orig = gcnii_ops.gcnii_stack_plain
        if masks is not None:      # one list of layer masks a stack call
            held = iter(masks)
            gcnii_ops.gcnii_stack_plain = lambda *a, **k: orig(
                *a, relu_masks=next(held), **k)
        try:
            with StackRecorder() as rec, (ops.plain_ops() if plain
                                          else contextlib.nullcontext()):
                loss, _ = tr.train_step(batch, seed=1)
            torch.cuda.synchronize()
        finally:
            gcnii_ops.gcnii_stack_plain = orig
        grads = {n: p.grad for n, p in tr.model.named_parameters()}
        return float(loss), grads, rec.calls

    def compare(loss_k, grads_k, loss_p, grads_p):
        errs = {}
        for name, gp in grads_p.items():
            gk = grads_k[name]
            check(gk is not None and float(gk.abs().max()) > 0,
                  f"no gradient reached {name}")
            errs[name] = float((gk - gp).abs().max()) / float(gp.abs().max())
        return abs(loss_k - loss_p) / abs(loss_p), errs

    from mmdfn_torch.weights import build_model

    ops.reset_launch_counts()
    loss_k, grads_k, calls_k = one_step(plain=False)
    counts = ops.launch_counts()
    stack = bool(stack_calls(cfg, batch["umask"].shape[1]))
    gru = gru_encoders((build or build_model)(cfg)) > 0
    check(all((v > 0) == (stack if k.startswith("gcnii") else gru)
              for k, v in counts.items()),
          f"the kernel step did not launch its kernels: {counts}")
    loss_p, grads_p, calls_p = one_step(plain=True)
    loss_err, errs = compare(loss_k, grads_k, loss_p, grads_p)
    out = {"loss_kernels": loss_k, "loss_plain": loss_p,
           "loss_rel_err": loss_err, "grad_max_rel_err": max(errs.values()),
           "grad_rel_err_by_param_top": sorted(
               errs.items(), key=lambda kv: -kv[1])[:5],
           "launches": counts}
    ok = loss_err <= STEP_LOSS_RTOL and max(errs.values()) <= grad_rtol
    if hold_decisions:
        want = len(stack_calls(cfg, batch["umask"].shape[1]))
        check(len(calls_k) == len(calls_p) == want,
              f"{want} GCNII stack calls a step")
        per = [relu_decisions(torch, args, kw, plain_args)
               for (args, kw), (plain_args, _) in zip(calls_k, calls_p)]
        masks = [p[0] for p in per]
        flips = sum(p[1] for p in per)
        flip_pre = max(p[2] for p in per)
        tol = min(p[3] for p in per)
        out.update(relu_decisions_differing=flips,
                   max_abs_pre_where_they_differ=flip_pre,
                   forward_tolerance=tol, held_at_kernel_decisions=not ok)
        if not ok:
            print(json.dumps({"step_check_at_plain_decisions": out}),
                  flush=True)
            check(flip_pre <= tol, f"ReLU decisions differ at |pre| = "
                                   f"{flip_pre} > {tol}")
            loss_p, grads_p, _ = one_step(plain=True, masks=masks)
            loss_err, errs = compare(loss_k, grads_k, loss_p, grads_p)
            out.update(loss_rel_err=loss_err,
                       grad_max_rel_err=max(errs.values()),
                       grad_rel_err_by_param_top=sorted(
                           errs.items(), key=lambda kv: -kv[1])[:5])
    check(loss_err <= STEP_LOSS_RTOL,
          f"step loss kernels {loss_k} vs plain {loss_p}")
    for name, e in errs.items():
        check(e <= grad_rtol, f"gradient of {name}: {e} of its scale")
    return out


def timed_steps(torch, dev, cfg, batches, reps=10, named_ops=(),
                build=None) -> dict:
    """The training step's main path: 2 warm-up steps, then ``reps`` timed
    steps with the launch counts zeroed just before and read just after
    (kernels A and C must show, and kernels B and D with their documented
    launches for each GCNII stack call, or none),
    the step's own peak memory, the stream time of chained steps, and a
    torch.profiler window of 3 steps (device time by kernel; for each
    operator of ``named_ops``, the device time of the kernels it launched
    and its calls, a step).  ``build`` as in :func:`trainer_for`."""
    from torch.profiler import ProfilerActivity, profile

    from mmdfn_torch import ops
    from mmdfn_torch.ops.bigru import _sm_count
    from mmdfn_torch.ops.gcnii import gcnii_bwd_launches, gcnii_fwd_launches

    tr = trainer_for(cfg, dev, build)
    for i in range(2):
        tr.train_step(batches[i % len(batches)], seed=100 + i)
    torch.cuda.synchronize()
    script_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    wall, enqueue, losses = [], [], []
    for i in range(reps):
        t0 = time.perf_counter()
        loss, _ = tr.train_step(batches[i % len(batches)], seed=200 + i)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        enqueue.append((t1 - t0) * 1e3)
        losses.append(float(loss))
    counts = ops.launch_counts()
    step_peak = torch.cuda.max_memory_allocated() / 1e9
    grus = gru_encoders(tr.model)
    check(counts["bigru_fwd"] == counts["bigru_bwd"] == 2 * grus * reps,
          f"kernels A and C: {counts}, {grus} bi-GRUs a step")
    B, L = batches[0]["umask"].shape
    calls = stack_calls(cfg, L)
    sms = _sm_count(dev)
    mode = stack_mode(tr.model)
    want = {"gcnii_fwd": reps * sum(
                gcnii_fwd_launches(nl, reason,
                                   stack_design(tr.model, B, N, sms), mode)
                for nl, reason, N in calls),
            "gcnii_bwd": reps * sum(gcnii_bwd_launches(nl, reason, mode)
                                    for nl, reason, _ in calls)}
    for k, v in want.items():
        check(counts[k] == v, f"{k} launches {counts[k]} != {v}")
    check(all(math.isfinite(v) for v in losses), f"losses {losses}")
    step_ms = sorted(wall)[len(wall) // 2]

    # chained steps: the stream's time per step; then a profiled window
    K = 5
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(K):
        tr.train_step(batches[i % len(batches)], seed=300 + i)
    end.record()
    end.synchronize()
    stream_ms = start.elapsed_time(end) / K
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(3):
            tr.train_step(batches[i % len(batches)], seed=400 + i)
        torch.cuda.synchronize()
    kern, notes = device_events(torch, prof)
    if kern:
        busy = sum(e.self_device_time_total for e in kern) / 1e3 / 3
        top = sorted(kern, key=lambda e: -e.self_device_time_total)[:10]
        bigru = [[kernel_name(e.key), e.self_device_time_total / 1e3 / 3,
                  e.count / 3] for e in kern if "bigru" in e.key]
        profiled = {"device_busy_ms_per_step": busy,
                    "bigru_kernels": sorted(bigru),
                    "gcnii_fwd_kernels": by_part(kern, "gcnii_fwd", 3),
                    "gcnii_bwd_kernels": by_part(kern, "gcnii_bwd", 3),
                    "idle_share": 1.0 - busy / stream_ms,
                    "device_ops_per_step": sum(e.count for e in kern) / 3,
                    "annotations_left_out": [
                        [e.key[:40], e.self_device_time_total / 1e3 / 3]
                        for e in notes],
                    "top": [[kernel_label(e.key),
                             e.self_device_time_total / 1e3 / 3,
                             e.count / 3] for e in top]}
        if named_ops:
            profiled["named_ops"] = {
                e.key: [e.device_time_total / 1e3 / 3, e.count / 3]
                for e in prof.key_averages() if e.key in named_ops}
    else:
        profiled = {"device_busy_ms_per_step": "not measured",
                    "idle_share": "not measured"}
    return {"launches": counts,
            "launches_per_step": {k: v / reps for k, v in counts.items()},
            "step_ms_median": step_ms, "step_ms_all": wall,
            "dialogues_per_sec": B / (step_ms / 1e3),
            "host_enqueue_ms_per_step": sorted(enqueue)[len(enqueue) // 2],
            "stream_ms_per_step": stream_ms, **profiled,
            "step_peak_mem_gb": step_peak,
            "peak_mem_gb": max(script_peak,
                               torch.cuda.max_memory_allocated()) / 1e9}


def train_phase(torch, dev) -> dict:
    """The flagship training step at bench.py's production settings."""
    import numpy as np

    from mmdfn_torch.config import ExperimentConfig
    from mmdfn_torch.train import Trainer

    cfg = ExperimentConfig(dataset="IEMOCAP", graph_type="GDF",
                           reason_flag=True, class_weight=True,
                           Deep_GCN_nlayers=NLAYERS, batch_size=TRAIN_B,
                           speaker_weights="3-0-1", dropout=RATE, seed=SEED)
    rng = np.random.default_rng(SEED)
    batches = [train_batch(torch, rng, dev) for _ in range(4)]
    checked = step_check(torch, dev, cfg, batches[0])
    # bench.py draws the labels after the features: on that batch a few
    # ReLU decisions of the stack lie within rounding of 0
    bench_order = train_batch(torch, np.random.default_rng(SEED), dev,
                              labels_last=True)
    checked_bench = step_check(torch, dev, cfg, bench_order,
                               hold_decisions=True)
    timed = timed_steps(torch, dev, cfg, batches)

    # 20 steps on one fixed batch: the loss must fall
    tr = Trainer(cfg, device=dev)
    fit = [float(tr.train_step(batches[0], seed=500 + i)[0])
           for i in range(20)]
    check(sum(fit[-5:]) < sum(fit[:5]),
          f"the loss did not fall over 20 steps on one batch: {fit}")
    return {"shape": f"B={TRAIN_B} L<={TRAIN_L} layers={NLAYERS} "
                     f"dropout={RATE}",
            "step_loss_rel_err_vs_plain": checked["loss_rel_err"],
            "step_grad_max_rel_err_vs_plain": checked["grad_max_rel_err"],
            "step_check_bench_order": checked_bench,
            **timed, "fixed_batch_losses": fit}


def meld_config():
    """MELD at its published depth: GDF with the reason-LSTM, 64 GCNII
    layers, the first combination of the reference's MELD grid
    (``mmdfn_tpu/cli/sweep.py:40-44``)."""
    from mmdfn_torch.config import ExperimentConfig

    return ExperimentConfig(
        dataset="MELD", graph_type="GDF", reason_flag=True,
        Deep_GCN_nlayers=MELD_NLAYERS, batch_size=MELD_B,
        speaker_weights="0.5-0.5-1.5", class_weight=False, lr=5e-4, l2=1e-4,
        dropout=RATE, gamma=0.5, seed=SEED, buckets=(MELD_L,))


def serve_check(torch, dev, cfg, model, dialogues, tol=SERVE_TOL):
    """``model`` answers every utterance of ``dialogues`` through
    ``StreamingSession``, the launch counts zeroed just before and read
    just after: kernel A twice per bi-GRU a forward, kernel B its
    documented launches per GCNII stack call; every append's log-probs
    finite, normalized and within ``tol`` (``SERVE_TOL``) of the same
    model run with the plain versions.  Returns (the session, the
    log-probs, a summary)."""
    from mmdfn_torch import ops
    from mmdfn_torch.data.batching import bucket_length
    from mmdfn_torch.ops.bigru import _sm_count
    from mmdfn_torch.ops.gcnii import gcnii_fwd_launches
    from mmdfn_torch.serve import StreamingSession

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
    grus = gru_encoders(model)
    check(counts["bigru_fwd"] == 2 * grus * n,
          f"bi-GRU launches {counts['bigru_fwd']} != 2 x {grus} x {n}")
    sms = _sm_count(dev)
    mode = stack_mode(model)
    want = sum(gcnii_fwd_launches(nl, reason, stack_design(model, 1, N, sms),
                                  mode)
               for L in used for nl, reason, N in stack_calls(cfg, L))
    check(counts["gcnii_fwd"] == want,
          f"GCNII launches {counts['gcnii_fwd']} != {want}")
    C = cfg.info["n_classes"]
    for lp in logps:
        check(lp.shape == (C,) and bool(all(math.isfinite(v) for v in lp)),
              f"log-probs not finite of shape ({C},)")
        check(abs(math.log(sum(math.exp(v) for v in lp))) < 1e-4,
              "log-probs do not normalize")
    with ops.plain_ops():
        ref, _, _ = replay(StreamingSession(model, cfg, device=dev))
    err = max(float(abs(a - b).max()) for a, b in zip(logps, ref))
    check(err <= tol, f"served log-probs vs plain: {err}")
    lat_sorted = sorted(lat)
    pct = lambda q: lat_sorted[min(n - 1, int(round(q / 100 * (n - 1))))]
    return session, logps, {
        "appends": n, "dialogue_lengths": [len(d) for d in dialogues],
        "launches": counts, "buckets_used": sorted(set(used)),
        "wall_p50_ms": pct(50), "wall_p90_ms": pct(90),
        "max_abs_err_vs_plain": err, "tolerance": tol}


def meld_serve(torch, dev, cfg) -> dict:
    """The MELD model (fresh weights from the seed) answers every utterance
    of three synthetic MELD dialogues (:func:`serve_check`); then a
    profiled forward at bucket 64."""
    from mmdfn_torch.data.datasets import MELDDataset
    from mmdfn_torch.data.synthetic import make_synthetic_meld_pickle
    from mmdfn_torch.weights import build_model

    with tempfile.TemporaryDirectory() as tmp:
        make_synthetic_meld_pickle(f"{tmp}/meld.pkl", n_train=1, n_test=3,
                                   min_len=5, max_len=MELD_L, seed=SEED)
        dialogues = MELDDataset(f"{tmp}/meld.pkl", train=False).dialogues()
    session, _, out = serve_check(torch, dev, cfg, build_model(cfg),
                                  dialogues)
    return {**out, "profile": profile_phase(torch, session, 64)}


def run_cli(args, stdin=None, timeout=600):
    proc = subprocess.run([sys.executable, "-m", *args], cwd=ROOT,
                          input=stdin, capture_output=True, text=True,
                          timeout=timeout)
    check(proc.returncode == 0, f"{args[0]} exited {proc.returncode}: "
                                f"{proc.stderr[-2000:]}")
    return proc.stdout


def meld_cli() -> dict:
    """The user's commands on a synthetic MELD pickle, 64 layers on the
    card: one epoch of training, ``--test_label`` on its directory, and the
    server answering three requests from it."""
    from mmdfn_torch.data.datasets import MELDDataset
    from mmdfn_torch.data.synthetic import make_synthetic_meld_pickle

    with tempfile.TemporaryDirectory() as tmp:
        pkl, ckpt, out = f"{tmp}/meld.pkl", f"{tmp}/ckpt", f"{tmp}/out"
        make_synthetic_meld_pickle(pkl, n_train=MELD_B, n_test=8, min_len=5,
                                   max_len=MELD_L, seed=SEED)
        flags = ["--dataset", "MELD", "--data_dir", pkl, "--Deep_GCN_nlayers",
                 str(MELD_NLAYERS), "--reason_flag", "--speaker_weights",
                 "0.5-0.5-1.5", "--lr", "0.0005", "--buckets", str(MELD_L)]
        t0 = time.perf_counter()
        train_out = run_cli(["mmdfn_torch.cli.run_train_erc", *flags,
                             "--epochs", "1", "--save_model_dir", ckpt])
        train_s = time.perf_counter() - t0
        check("epoch: 0, train_loss: " in train_out, "no MELD epoch line")
        d = MELDDataset(pkl, train=False).dialogues()[0]
        lines = [json.dumps({"text": d.text[t].tolist(),
                             "audio": d.audio[t].tolist(),
                             "visual": d.visual[t].tolist(),
                             "speaker": int(d.qmask[t].argmax())})
                 for t in range(3)]
        # the evaluation and the server read the same directory: both at once
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(2) as pool:
            tested = pool.submit(run_cli, [
                "mmdfn_torch.cli.run_train_erc", *flags, "--test_label",
                "--load_model", ckpt, "--save_model_dir", out])
            serving = pool.submit(run_cli, [
                "mmdfn_torch.cli.serve", "--load_model", ckpt, "--buckets",
                "8,16,32,64"], "\n".join(lines) + "\n")
            test_out, served = tested.result(), serving.result()
        check("test_fscore:" in test_out, "no MELD test_fscore line")
        import numpy as np
        preds = np.load(f"{out}/test_pred.npy")
        check(len(preds) == len(np.load(f"{out}/test_label.npy")) > 0
              and Path(f"{out}/test_activations.npz").exists(),
              "--test_label did not write its files")
        resp = [json.loads(line) for line in served.splitlines()]
        check(len(resp) == 4 and resp[0].get("ready") and all(
            len(r["log_probs"]) == 7 for r in resp[1:]),
            f"MELD serve CLI responses: {resp}")
    return {"train_epoch_s": train_s, "cli_s": time.perf_counter() - t0,
            "test_line": [l for l in test_out.splitlines()
                          if l.startswith("test_acc")][0],
            "serve_latency_ms": [r["latency_ms"] for r in resp[1:]]}


def meld_phase(torch, dev) -> dict:
    """MELD end to end at its published depth: the training step against
    the plain step, its timing, serving, the kernels alone at MELD's shapes
    and the command-line tools."""
    import numpy as np

    cfg = meld_config()
    rng = np.random.default_rng(SEED)
    batches = [meld_batch(torch, rng, dev) for _ in range(4)]
    checked = step_check(torch, dev, cfg, batches[0], hold_decisions=True)
    timed = timed_steps(torch, dev, cfg, batches)
    serve = meld_serve(torch, dev, cfg)
    streams = MELD_B * 9 * 3          # B x P x M party streams of the CRN
    a = bigru_case(torch, dev, streams, MELD_L, train=True)
    c = bigru_bwd_case(torch, dev, streams, MELD_L, a["train_ms"])
    bd = gcnii_train_case(torch, dev, MELD_B, MELD_L, nl=MELD_NLAYERS, lo=5)
    resident = gcnii_case(torch, dev, 64, nl=MELD_NLAYERS)
    return {"config": f"MELD GDF reason {MELD_NLAYERS} layers, B={MELD_B} "
                      f"L<={MELD_L}, 9 speakers, dropout {RATE}",
            "step_check": checked, "train": timed, "serve": serve,
            "kernels": {"bigru_fwd": a, "bigru_bwd": c,
                        "gcnii_fwd_train": bd["fwd"], "gcnii_bwd": bd["bwd"],
                        "gcnii_fwd_serve_N192": resident},
            "cli": meld_cli()}


# graph families at the flagship's widths, each with concat_subsequently;
# DeepGCN at the flagship's 16 layers, GF2 at its fixed 64
FAMILIES = (("GF2", dict(graph_type="GF2")),
            ("DeepGCN", dict(graph_type="DeepGCN")),
            ("DeepGCN reason", dict(graph_type="DeepGCN", reason_flag=True)),
            ("GCN3", dict(graph_type="GCN3")),
            ("relation", dict(graph_type="relation")),
            ("None", dict(graph_type="None")))
# the fusion heads, each on a family whose features it takes (MFN: GF's
# fused 3 x 300; the others: DeepGCN's per-modality 300)
HEADS = (("gated", dict(graph_type="DeepGCN", mm_fusion_mthd="gated")),
         ("mfn", dict(graph_type="GF", mm_fusion_mthd="mfn")),
         ("tfn_only", dict(graph_type="DeepGCN", mm_fusion_mthd="tfn_only")),
         ("lmf_only", dict(graph_type="DeepGCN", mm_fusion_mthd="lmf_only")))
TIMED_KEYS = ("launches_per_step", "step_ms_median", "dialogues_per_sec",
              "host_enqueue_ms_per_step", "stream_ms_per_step",
              "device_busy_ms_per_step", "idle_share", "device_ops_per_step",
              "step_peak_mem_gb", "gcnii_fwd_kernels", "gcnii_bwd_kernels",
              "top")


def family_config(**kw):
    """IEMOCAP at the flagship's settings (class weights, focal loss,
    dropout 0.4, speaker weights 3-0-1, weights from the seed) with
    another graph family or head."""
    from mmdfn_torch.config import ExperimentConfig

    return ExperimentConfig(dataset="IEMOCAP", class_weight=True,
                            Deep_GCN_nlayers=NLAYERS, batch_size=TRAIN_B,
                            speaker_weights="3-0-1", dropout=RATE, seed=SEED,
                            **kw)


def families_phase(torch, dev) -> dict:
    """Every multimodal graph family at the flagship's widths: for each, the
    training step against the plain step (held at the kernels' ReLU
    decisions where GCNII stacks run, as the MELD step), 5 timed steps with
    launch counts and a profile, and one served dialogue against the plain
    model; each fusion head serves the dialogue; kernels B (training mode)
    and D alone at GF2's and DeepGCN's training shapes, and B's serve
    mode at their bucket-64 shapes."""
    import numpy as np

    from mmdfn_torch.data.datasets import IEMOCAPDataset
    from mmdfn_torch.data.synthetic import make_synthetic_iemocap_pickle
    from mmdfn_torch.weights import build_model

    rng = np.random.default_rng(SEED)
    batches = [train_batch(torch, rng, dev) for _ in range(2)]
    with tempfile.TemporaryDirectory() as tmp:
        make_synthetic_iemocap_pickle(f"{tmp}/iem.pkl", n_train=1, n_test=1,
                                      min_len=30, max_len=40, seed=SEED)
        dialogue = IEMOCAPDataset(f"{tmp}/iem.pkl", train=False).dialogues()
    out = {"shape": f"IEMOCAP B={TRAIN_B} L<={TRAIN_L} dropout={RATE}; "
                    f"serve one dialogue of {len(dialogue[0])} turns"}
    for name, kw in FAMILIES:
        t0 = time.perf_counter()
        cfg = family_config(**kw)
        stack = bool(stack_calls(cfg, TRAIN_L))
        checked = step_check(torch, dev, cfg, batches[0],
                             hold_decisions=stack)
        timed = timed_steps(torch, dev, cfg, batches, reps=5)
        served = serve_check(torch, dev, cfg, build_model(cfg), dialogue)[2]
        out[name] = {"step_check": checked,
                     "train": {k: timed[k] for k in TIMED_KEYS
                               if k in timed},
                     "serve": served, "seconds": time.perf_counter() - t0}
        print(json.dumps({"family": name, "step_ms_median":
                          timed["step_ms_median"],
                          "seconds": out[name]["seconds"]}), flush=True)
    out["heads"] = {name: serve_check(torch, dev, family_config(**kw),
                                      build_model(family_config(**kw)),
                                      dialogue)[2]
                    for name, kw in HEADS}
    gf2 = gcnii_train_case(torch, dev, TRAIN_B, TRAIN_L, nl=64,
                           wiring="GF2")
    deep = gcnii_train_case(torch, dev, TRAIN_B, TRAIN_L, wiring="DeepGCN")
    out["kernels"] = {
        "gcnii_fwd_train_GF2": gf2["fwd"], "gcnii_bwd_GF2": gf2["bwd"],
        "gcnii_fwd_train_DeepGCN": deep["fwd"],
        "gcnii_bwd_DeepGCN": deep["bwd"],
        # serve mode at bucket 64: GF2's N = 192, DeepGCN's N = 64 a call
        "gcnii_fwd_serve_GF2": gcnii_case(torch, dev, 64, reason=False,
                                          nl=64),
        "gcnii_fwd_serve_DeepGCN": gcnii_case(torch, dev, 64, reason=False,
                                              modalities=1)}
    return out


def nonvariant_build(kind: str):
    """``build`` (as :func:`trainer_for` takes it) of the config's model
    with its GCNII stacks built with ``variant=False``: "MMGCN" (GDF's
    ``graph_model``, the reason-LSTM) or "DeepGCN" (each modality's
    ``DeepGCNII``).  The rest of the model keeps the config seed's
    weights; the new stacks draw theirs from seed + 1."""
    import torch

    from mmdfn_torch.config import GRAPH_H
    from mmdfn_torch.models.dialogue_gnn import TAG
    from mmdfn_torch.models.mm_gcn import MMGCN, DeepGCNII
    from mmdfn_torch.weights import build_model

    def build(cfg):
        model = build_model(cfg)
        g = torch.Generator().manual_seed(cfg.seed + 1)
        if kind == "MMGCN":
            old = model.graph_model
            new = MMGCN(old.graph_net.fcs[0].in_features,
                        cfg.Deep_GCN_nlayers, GRAPH_H, lamda=cfg.lamda,
                        alpha=cfg.alpha, use_residue=old.use_residue,
                        modals=cfg.modals, reason_flag=True,
                        modal_weight=cfg.modal_weight, dropout=cfg.dropout,
                        rate_tag=TAG, variant=False,
                        backend=cfg.gcn_backend,
                        compute_dtype=cfg.gcn_compute_dtype)
            new.reset_parameters(g)
            model.graph_model = new
            return model
        for m in model.order:
            old = getattr(model, f"graph_net_{m}")
            new = DeepGCNII(old.fcs[0].in_features, cfg.Deep_GCN_nlayers,
                            GRAPH_H, lamda=0.5, alpha=0.1,
                            use_residue=old.use_residue,
                            reason_flag=cfg.reason_flag, dropout=cfg.dropout,
                            rate_tag=TAG, variant=False,
                            backend=cfg.gcn_backend,
                            compute_dtype=cfg.gcn_compute_dtype)
            new.reset_parameters(g)
            setattr(model, f"graph_net_{m}", new)
        return model
    return build


def nonvariant_kernels(torch, dev) -> dict:
    """Kernels B and D on the fold of the non-variant layer weights
    (``ops.fold_weights``), each against the unfolded plain version and
    timed beside the same call on the variant's (2H, H) weights: B's serve
    mode at bucket 64 (one dialogue, N = 192, 16 layers, the
    reason-LSTM), and at the training shapes (B = 32, N = 240, rate 0.4)
    B's training mode and, through autograd, D and the fold's backward,
    held at the kernels' ReLU decisions."""
    from mmdfn_torch import ops
    from mmdfn_torch.graph.adjacency import mm_big_adjacency
    from mmdfn_torch.ops import (fold_weights, gcnii_stack_bwd,
                                 gcnii_stack_fwd, gcnii_stack_plain)
    from mmdfn_torch.ops.bigru import _sm_count
    from mmdfn_torch.ops.gcnii import (RESIDUALS, _design, gcnii_bwd_launches,
                                       gcnii_fwd_launches)

    nl, L = NLAYERS, 64
    g = torch.Generator().manual_seed(L)
    u = lambda *s: (torch.rand(*s, generator=g) * 0.2 - 0.1).to(dev)
    adj = mm_big_adjacency([torch.randn(1, L, 2 * H, generator=g)
                            for _ in range(3)], torch.ones(1, L)).to(dev)
    N = 3 * L
    h = torch.relu(torch.randn(1, N, H, generator=g)).to(dev)
    theta = torch.log(0.5 / torch.arange(1, nl + 1) + 1.0).to(dev)
    lstm = (u(4 * H, H).t(), u(4 * H, H).t(), u(4 * H))
    W, W_v = u(nl, H, H), u(nl, 2 * H, H)
    kw = dict(alpha=0.2, reason=True)
    run = lambda W, variant: gcnii_stack_fwd(adj, h, h, W, theta, *lstm,
                                             variant=variant, **kw)
    plain = lambda: gcnii_stack_plain(adj, h, h, W, theta, *lstm,
                                      variant=False, **kw)
    want = plain()
    ops.reset_launch_counts()
    got = run(W, False)
    torch.cuda.synchronize()
    launches = ops.launch_counts()["gcnii_fwd"]
    design = _design(1, N, _sm_count(dev))
    check(launches == gcnii_fwd_launches(nl, True, design),
          f"kernel B's serve launches without the variant: {launches}")
    err = float((got - want).abs().max())
    tol = KERNEL_B_RTOL * max(1.0, float(want.abs().max()))
    check(err <= tol, f"kernel B (serve) without the variant vs plain at "
                      f"N={N}: {err} > {tol}")
    # the non-variant function's own work: per layer adj @ h, r @ W (2 N
    # H^2, where the fold's products do 4), the update; the LSTM step
    flops = nl * (2 * N * N * H + 2 * N * H * H + 6 * N * H
                  + 16 * N * H * H + 12 * N * H)
    nbytes = 4 * (N * N + 3 * N * H + nl * (H * H + 1)
                  + 2 * H * 4 * H + 4 * H)
    serve = {"shape": f"B=1 N={N} H={H} layers={nl} reason=True",
             "design": design, "launches": launches, "max_abs_err": err,
             "tolerance": tol, "ms": time_ms(torch, lambda: run(W, False), 20),
             "variant_ms": time_ms(torch, lambda: run(W_v, True), 20),
             "plain_ms": time_ms(torch, plain, 5), "library_ms": None,
             **bound(nbytes, flops)}

    args, g = gcnii_train_inputs(torch, dev, TRAIN_B, TRAIN_L, nl=nl)
    adj, h, h0, W_v, theta, ih, hh, lb = args
    B, N = h.shape[:2]
    W = (torch.rand(nl, H, H, generator=g) * 0.2 - 0.1).to(dev)
    seed = torch.tensor([SEED + 54321], dtype=torch.int64, device=dev)
    kw = dict(alpha=0.2, reason=True, rate=RATE, seed=seed)
    operands = (adj, h, h0, W, theta, ih, hh, lb)
    masks, flips, flip_pre, fwd_tol = relu_decisions(
        torch, operands, {**kw, "variant": False}, operands)
    check(flip_pre <= fwd_tol, f"ReLU decisions differ at |pre| = "
                               f"{flip_pre} > {fwd_tol}")
    dh = torch.randn(B, N, H, generator=g).to(dev)
    leaves = lambda: [t.detach().clone().requires_grad_() for t in operands]

    def step(fn, **more):
        a = leaves()
        out = fn(*a, **kw, variant=False, **more)
        grads = torch.autograd.grad(out, [t for i, t in enumerate(a)
                                          if i != 4], dh)
        return out, grads
    ops.reset_launch_counts()
    out_k, grads_k = step(gcnii_stack_fwd)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    design = _design(B, N, _sm_count(dev))
    check(counts["gcnii_fwd"] == gcnii_fwd_launches(nl, True, design)
          and counts["gcnii_bwd"] == gcnii_bwd_launches(nl, True),
          f"kernels B and D without the variant: {counts}")
    out_p, grads_p = step(gcnii_stack_plain, relu_masks=masks)
    fwd_err = float((out_k - out_p).detach().abs().max())
    check(fwd_err <= fwd_tol, f"kernel B (training) without the variant vs "
                              f"plain: {fwd_err} > {fwd_tol}")
    bwd_err = {}
    for name, a, b in zip(("d_adj", "d_h", "d_h0", "dW", "dW_ih", "dW_hh",
                           "db"), grads_k, grads_p):
        e = float((a - b).abs().max()) / float(b.abs().max())
        check(e <= KERNEL_D_RTOL, f"kernel D without the variant vs plain, "
                                  f"{name}: {e} of its scale")
        bwd_err[name] = e
    slabs = lambda: [torch.zeros(B, nl, N, H, device=dev)
                     for _ in RESIDUALS]
    res, res_v = slabs(), slabs()
    fwd = lambda W, variant, res: gcnii_stack_fwd(
        adj, h, h0, W, theta, ih, hh, lb, residuals=res, variant=variant,
        **kw)
    fwd(W, False, res)
    fwd(W_v, True, res_v)
    W_fold = fold_weights(W, kw["alpha"])
    bwd = lambda W, res: gcnii_stack_bwd(adj, h0, W, theta, ih, hh, lb, res,
                                         dh, **kw)
    # as gcnii_train_case counts them, with the non-variant function's
    # support products: r @ W forward (2 R H^2, the fold's 4), and its
    # recompute, its input gradient and dW backward (6 R H^2, the fold's
    # 12); the weights (nl, H, H)
    R = B * N
    fwd_flops = nl * (2 * B * N * N * H + 18 * R * H * H + 20 * R * H)
    fwd_bytes = 4 * (B * N * N + 3 * R * H + nl * (H * H + 1)
                     + 2 * 4 * H * H + 4 * H + 4 * nl * R * H)
    bwd_flops = nl * (6 * B * N * N * H + 54 * R * H * H + 40 * R * H)
    bwd_bytes = 4 * (2 * B * N * N + 4 * R * H + 2 * nl * H * H
                     + 2 * (8 * H * H + 4 * H) + 4 * nl * R * H)
    train = {"shape": f"B={B} N={N} H={H} layers={nl} reason=True "
                      f"rate={RATE}",
             "launches": counts, "relu_decisions_differing": flips,
             "max_abs_pre_where_they_differ": flip_pre,
             "fwd_max_abs_err": fwd_err, "fwd_tolerance": fwd_tol,
             "bwd_rel_err": bwd_err, "bwd_tolerance": KERNEL_D_RTOL,
             "fwd_ms": time_ms(torch, lambda: fwd(W, False, res), 10),
             "fwd_variant_ms": time_ms(torch, lambda: fwd(W_v, True, res_v),
                                       10),
             "fwd_bound": bound(fwd_bytes, fwd_flops),
             "bwd_ms": time_ms(torch, lambda: bwd(W_fold, res), 10),
             "bwd_variant_ms": time_ms(torch, lambda: bwd(W_v, res_v), 10),
             "bwd_bound": bound(bwd_bytes, bwd_flops),
             "fold_ms": time_ms(torch, lambda: fold_weights(W, 0.2), 10)}
    return {"serve": serve, "train": train}


def packer_times(reps: int = 5) -> dict:
    """The native packer (``data/_native.py``) beside ``data/batching.py``'s
    numpy path on the host, at the IEMOCAP and MELD training batches (B =
    32 dialogues of U[20, 80] and U[5, 33] turns, their buckets): the
    three modalities' features, the speakers, the mask and the labels, the
    same bytes both ways; the median seconds of ``reps`` packs each."""
    import numpy as np

    from mmdfn_torch.data import _native, batching

    if not _native.available():
        return {"available": False}
    rng = np.random.default_rng(SEED)
    out = {"available": True}
    for name, dims, lo, hi in (("IEMOCAP", (100, 1582, 342, 2), 20, TRAIN_L),
                               ("MELD", (600, 300, 342, 9), 5, MELD_L)):
        lengths = rng.integers(lo, hi + 1, TRAIN_B)
        L = batching.bucket_length(int(lengths.max()),
                                   batching.DEFAULT_BUCKETS)
        feats = [[rng.standard_normal((n, D), dtype=np.float32)
                  for n in lengths] for D in dims]
        labels = [rng.integers(0, 6, n).astype(np.int32) for n in lengths]

        def numpy_pack():
            umask = np.zeros((TRAIN_B, L), np.float32)
            label = np.zeros((TRAIN_B, L), np.int64)
            for i, lab in enumerate(labels):
                umask[i, :len(lab)] = 1.0
                label[i, :len(lab)] = lab
            return ([batching._pack(f, TRAIN_B, L, D)
                     for f, D in zip(feats, dims)], umask, label)

        def native_pack():
            return ([_native.pack_f32(f, TRAIN_B, L, D)
                     for f, D in zip(feats, dims)],
                    *_native.pack_masks_labels(labels, TRAIN_B, L))

        def median_s(fn):
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()
                times.append(time.perf_counter() - t0)
            return sorted(times)[reps // 2]
        a, b = numpy_pack(), native_pack()
        check(all(x.tobytes() == y.tobytes()
                  for x, y in zip([*a[0], a[1], a[2]], [*b[0], b[1], b[2]])),
              f"the native packer's {name} batch differs from numpy's")
        out[name] = {"bucket": L, "bytes": sum(x.nbytes for x in a[0]),
                     "numpy_s": median_s(numpy_pack),
                     "native_s": median_s(native_pack)}
    return out


def nonvariant_phase(torch, dev) -> dict:
    """The original GCNII update (``variant=False``: each layer's weight
    (H, H), kernels B and D on its fold): the kernels against the unfolded
    plain version (:func:`nonvariant_kernels`); the flagship's training
    step with ``MMGCN(variant=False, reason_flag=True)`` at its widths and
    batch against the plain step at the kernels' ReLU decisions, 3 timed
    steps (B 49, D 116 a step), one served dialogue against the plain
    model; the same step check for DeepGCN's three ``DeepGCNII(variant=
    False)`` stacks (N = 80 each); and the native packer's times."""
    import numpy as np

    from mmdfn_torch.data.datasets import IEMOCAPDataset
    from mmdfn_torch.data.synthetic import make_synthetic_iemocap_pickle

    rng = np.random.default_rng(SEED)
    batches = [train_batch(torch, rng, dev) for _ in range(2)]
    with tempfile.TemporaryDirectory() as tmp:
        make_synthetic_iemocap_pickle(f"{tmp}/iem.pkl", n_train=1, n_test=1,
                                      min_len=30, max_len=40, seed=SEED)
        dialogue = IEMOCAPDataset(f"{tmp}/iem.pkl", train=False).dialogues()
    out = {"kernels": nonvariant_kernels(torch, dev)}
    cfg = family_config(graph_type="GDF", reason_flag=True)
    build = nonvariant_build("MMGCN")
    timed = timed_steps(torch, dev, cfg, batches, reps=3, build=build)
    out["MMGCN"] = {
        "step_check": step_check(torch, dev, cfg, batches[0],
                                 hold_decisions=True, build=build),
        "train": {k: timed[k] for k in TIMED_KEYS if k in timed},
        "serve": serve_check(torch, dev, cfg, build(cfg), dialogue)[2]}
    cfg = family_config(graph_type="DeepGCN")
    out["DeepGCNII"] = {"step_check": step_check(
        torch, dev, cfg, batches[0], hold_decisions=True,
        build=nonvariant_build("DeepGCN"))}
    out["packer"] = packer_times()
    return out


# the single stream and the non-graph baselines: early fusion at full
# width, the three baselines (IEMOCAP text, D_e = D_h = 100, D_g = D_p =
# 150, general context attention), the single-stream heads on the LSTM
# base and DialogRNN as relation's base (DialogueGCN's pairing)
EARLY = dict(graph_type="DeepGCN", mm_fusion_mthd="concat", reason_flag=True)
BASELINES = ("GRU", "LSTM", "DialogRNN")
SINGLE_HEADS = (("relation", dict(graph_type="relation")),
                ("GCN3", dict(graph_type="GCN3")),
                ("None", dict(graph_type="None")),
                ("relation on DialogRNN", dict(graph_type="relation",
                                               base_model="DialogRNN")))
SINGLE_SERVE_LEN = 37


def baseline_config(base: str):
    """A non-graph baseline at the flagship's training settings."""
    return family_config(graph_model=False, base_model=base,
                         attention="general")


def recurrence_times(torch, dev, B=TRAIN_B, L=TRAIN_L) -> dict:
    """The plain recurrences the JAX package runs as scans, at the
    training batch: the 2-layer bi-LSTM (H = 100, beside cuDNN's
    ``nn.LSTM`` on the same weights, all-valid mask) and the bidirectional
    DialogueRNN (D_m = 100, general attention), forward alone and forward
    + backward; stream time over chained calls, and the host's time to
    enqueue one."""
    from mmdfn_torch.config import D_A, D_E, D_G, D_P
    from mmdfn_torch.models.baselines import (DialogueRNN,
                                              bidirectional_dialogue_rnn)
    from mmdfn_torch.nn.rnn import BiRNN

    g = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn(B, L, 100, device=dev, generator=g)
    qmask = torch.nn.functional.one_hot(torch.randint(
        0, 2, (B, L), device=dev, generator=g), 2).float()
    umask = torch.ones(B, L, device=dev)
    lstm = BiRNN(100, D_E, cell="lstm").to(dev)
    cudnn = torch.nn.LSTM(100, D_E, num_layers=2, batch_first=True,
                          bidirectional=True).to(dev)
    cudnn.load_state_dict(lstm.state_dict())
    f, r = (DialogueRNN(100, D_G, D_P, D_E, False, "general", D_A).to(dev)
            for _ in range(2))
    fwds = {"bilstm": lambda: lstm(x, umask),
            "bilstm_cudnn": lambda: cudnn(x)[0],
            "dialogue_rnn": lambda: bidirectional_dialogue_rnn(
                f, r, x, qmask, umask)}
    with torch.no_grad():
        err = float((fwds["bilstm"]() - fwds["bilstm_cudnn"]()).abs().max())
    check(err <= 1e-4, f"the plain bi-LSTM vs cuDNN's: {err}")
    out = {"shape": f"B={B} L={L}", "bilstm_vs_cudnn_max_abs_err": err}
    for name, fwd in fwds.items():
        def step(fwd=fwd):
            fwd().sum().backward()
        with torch.no_grad():
            t0 = time.perf_counter()
            fwd()
            enqueue = (time.perf_counter() - t0) * 1e3
            fwd_ms = time_ms(torch, fwd, 5)
            busy = device_ms(torch, fwd, 3)
        out[name] = {"fwd_ms": fwd_ms, "fwd_host_enqueue_ms": enqueue,
                     "fwd_device_busy_ms": busy,
                     "fwd_idle_share": 1.0 - busy / fwd_ms,
                     "fwd_bwd_ms": time_ms(torch, step, 3)}
    return out


def single_phase(torch, dev) -> dict:
    """The single-stream path and the non-graph baselines at the flagship's
    batch: early-fusion DeepGCN (a,v,l concatenated, 2024 wide, the LSTM
    base with the CRN, 16 layers with the reason-LSTM) against its plain
    step (held at the kernels' ReLU decisions as MELD's), 10 timed steps
    with kernels A, C, B and D launched and profiled; the GRU, LSTM and
    DialogRNN baselines each against its plain step, 5 timed steps and a
    served dialogue of 37 utterances against the plain model; the
    single-stream DeepGCN of the text served (kernel B's serve mode); one
    step check each for the single-stream relation, GCN3 and None heads
    and for relation on the DialogRNN base; and the plain recurrences
    alone."""
    import numpy as np

    from mmdfn_torch.data.datasets import IEMOCAPDataset
    from mmdfn_torch.data.synthetic import make_synthetic_iemocap_pickle
    from mmdfn_torch.weights import build_model

    rng = np.random.default_rng(SEED)
    batches = [train_batch(torch, rng, dev) for _ in range(2)]
    with tempfile.TemporaryDirectory() as tmp:
        make_synthetic_iemocap_pickle(
            f"{tmp}/iem.pkl", n_train=1, n_test=1, min_len=SINGLE_SERVE_LEN,
            max_len=SINGLE_SERVE_LEN, seed=SEED)
        dialogue = IEMOCAPDataset(f"{tmp}/iem.pkl", train=False).dialogues()
    check(len(dialogue[0]) == SINGLE_SERVE_LEN, "the served dialogue")
    out = {"shape": f"IEMOCAP B={TRAIN_B} L<={TRAIN_L} dropout={RATE}; "
                    f"serve one dialogue of {SINGLE_SERVE_LEN} turns"}

    t0 = time.perf_counter()
    cfg = family_config(**EARLY)
    check(cfg.D_m == 2024 and not cfg.multi_modal_path, "early fusion")
    checked = step_check(torch, dev, cfg, batches[0], hold_decisions=True)
    timed = timed_steps(torch, dev, cfg, batches)
    for k in ("bigru_fwd", "bigru_bwd", "gcnii_fwd", "gcnii_bwd"):
        check(timed["launches"][k] > 0, f"early fusion launched no {k}")
    out["early_fusion_DeepGCN"] = {
        "config": "DeepGCN concat a,v,l (D_m 2024 -> linear_ 250), LSTM "
                  f"base + CRN, {NLAYERS} layers, reason-LSTM",
        "step_check": checked,
        "train": {k: timed[k] for k in TIMED_KEYS + ("bigru_kernels",)
                  if k in timed},
        "seconds": time.perf_counter() - t0}
    print(json.dumps({"single": "early fusion", "step_ms_median":
                      timed["step_ms_median"]}), flush=True)

    for base in BASELINES:
        t0 = time.perf_counter()
        cfg = baseline_config(base)
        checked = step_check(torch, dev, cfg, batches[0])
        timed = timed_steps(torch, dev, cfg, batches, reps=5)
        served = serve_check(torch, dev, cfg, build_model(cfg), dialogue)[2]
        out[base] = {"step_check": checked,
                     "train": {k: timed[k] for k in TIMED_KEYS
                               if k in timed},
                     "serve": served, "seconds": time.perf_counter() - t0}
        print(json.dumps({"single": base, "step_ms_median":
                          timed["step_ms_median"],
                          "seconds": out[base]["seconds"]}), flush=True)

    cfg = family_config(graph_type="DeepGCN", multi_modal=False, modals="l",
                        reason_flag=True)
    out["serve_DeepGCN_text"] = serve_check(torch, dev, cfg,
                                            build_model(cfg), dialogue)[2]
    check(out["serve_DeepGCN_text"]["launches"]["gcnii_fwd"]
          >= SINGLE_SERVE_LEN, "kernel B's serve mode")
    out["heads"] = {
        name: step_check(torch, dev, family_config(
            multi_modal=False, modals="l", **kw), batches[0])
        for name, kw in SINGLE_HEADS}
    out["recurrences"] = recurrence_times(torch, dev)
    return out


LEARN = dict(n_train=96, n_test=24, min_len=6, max_len=12, seed=11)
SWEEP_REPS = 4           # timed group batches and solo steps
SWEEP_DATA = dict(n_train=64, n_test=32, min_len=20, max_len=TRAIN_L,
                  seed=SEED)   # 2 train batches of B = 32 an epoch


def learn_phase(torch, dev) -> dict:
    """``tests/test_torch_learning.py``'s whole run on the card, through
    kernels A-D with dropout 0.4 (kernels B's and D's Philox dropout
    live): the flagship must learn the separable task (best test F1 >= 95,
    train F1 at the best epoch >= 95, epoch-0 train F1 < 60); then its
    step alone, timed and profiled on the run's own batches."""
    from collections import Counter

    from mmdfn_torch import ops
    from mmdfn_torch.config import ExperimentConfig
    from mmdfn_torch.data.batching import BucketBatcher
    from mmdfn_torch.data.datasets import IEMOCAPDataset
    from mmdfn_torch.data.synthetic import make_separable_iemocap_pickle
    from mmdfn_torch.train import Trainer
    from mmdfn_torch.train.trainer import prepare_inputs

    with tempfile.TemporaryDirectory() as tmp:
        make_separable_iemocap_pickle(f"{tmp}/sep.pkl", **LEARN)
        train = IEMOCAPDataset(f"{tmp}/sep.pkl", train=True).dialogues()
        test = IEMOCAPDataset(f"{tmp}/sep.pkl", train=False).dialogues()
    cfg = ExperimentConfig(
        dataset="IEMOCAP", graph_type="GDF", reason_flag=True,
        class_weight=True, Deep_GCN_nlayers=NLAYERS, speaker_weights="3-0-1",
        batch_size=8, buckets=(8,), lr=1e-3, epochs=12, patience=12)
    check(cfg.dropout == RATE, f"the run's dropout is {cfg.dropout}")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = Trainer(cfg, device=dev).fit(train, test, verbose=False)
    fit_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    check(all(v > 0 for v in counts.values()),
          f"the run did not launch every kernel: {counts}")
    hist = res.history
    train_f_at_best = hist[res.best_epoch]["train_fscore"]
    check(res.best_test_fscore >= 95.0,
          f"best test F1 {res.best_test_fscore} < 95: {hist}")
    check(train_f_at_best >= 95.0,
          f"train F1 at the best epoch {train_f_at_best} < 95")
    check(hist[0]["train_fscore"] < 60.0,
          f"epoch-0 train F1 {hist[0]['train_fscore']} >= 60")
    # the step alone on the run's batches of their commonest length
    batches = [prepare_inputs(b, dev) for b in BucketBatcher(
        train, cfg.batch_size, 2, cfg.buckets, shuffle=True,
        seed=cfg.seed).epoch(0)]
    L = Counter(b["umask"].shape[1] for b in batches).most_common(1)[0][0]
    timed = timed_steps(torch, dev, cfg,
                        [b for b in batches if b["umask"].shape[1] == L])
    steps = len(hist) * len(batches)
    return {"config": f"IEMOCAP GDF reason {NLAYERS} layers, B=8, "
                      f"dropout {RATE}, lr 1e-3, 12 epochs, separable task "
                      f"{LEARN}",
            "history": [[h["epoch"], h["train_loss"], h["train_fscore"],
                         h["test_loss"], h["test_fscore"]] for h in hist],
            "history_columns": ["epoch", "train_loss", "train_fscore",
                                "test_loss", "test_fscore"],
            "best_epoch": res.best_epoch,
            "best_test_fscore": res.best_test_fscore,
            "train_fscore_at_best": train_f_at_best,
            "fit_s": fit_s, "train_steps": steps,
            "fit_launches": counts,     # training steps and evaluations
            "timed_step_L": L, **timed}


# the config axis's check: K = 4 configurations, one at each of these rates
# (kernel B's and D's keep threshold and scale read per configuration)
CONFIG_RATES = (0.0, 0.2, 0.4, 0.4)


def config_axis_case(torch, dev) -> dict:
    """Kernels A-D with a leading config axis (the grouped sweep's batched
    step) at the training shapes, K = 4: one launch each against 4 solo
    launches, bit for bit, and against the plain versions under vmap (A,
    C, B) or, for D, the plain backward of each configuration at its own
    ReLU decisions; kernel B in training mode (tiled) with the rates
    ``CONFIG_RATES`` in one launch against solo launches at each static
    rate, and in its eval forwards (tiled at B = 32, resident at one
    dialogue); the stream time of the config-axis launch beside the 4 solo
    launches'.  Then the masks: layer 0's keep mask of each configuration
    equals its run alone's bit for bit, and the rate-0 configuration keeps
    every element."""
    from torch.func import vmap

    from mmdfn_torch.nn.drop_override import make_drop_rate
    from mmdfn_torch.ops import (bigru_layer_bwd, bigru_layer_bwd_plain,
                                 bigru_layer_fwd, bigru_layer_plain,
                                 gcnii_stack_bwd, gcnii_stack_bwd_plain,
                                 gcnii_stack_fwd, gcnii_stack_plain, philox)
    from mmdfn_torch.ops.bigru import _forward as bigru_forward
    from mmdfn_torch.ops.bigru import _sm_count
    from mmdfn_torch.ops.gcnii import (DESIGNS, RESIDUALS, _design,
                                       _forward as gcnii_forward,
                                       gcnii_bwd_launches,
                                       gcnii_fwd_launches)

    K, B, L, nl = len(CONFIG_RATES), TRAIN_B, TRAIN_L, NLAYERS
    N = 3 * L
    out = {"K": K, "rates": list(CONFIG_RATES)}

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    def counted(wrapper, fn):
        before = wrapper.launches
        r = fn()
        return r, wrapper.launches - before

    # kernels A and C: K sets of the lstm_l step's operands
    sets = [bigru_inputs(torch, dev, B, L, seed=40 + k) for k in range(K)]
    mask = sets[0][6]
    per = [torch.stack([s[i] for s in sets]) for i in range(6)]
    got, n_a = counted(bigru_layer_fwd,
                       lambda: bigru_forward(*per, mask, with_hg=True))
    solo = [bigru_forward(*s[:6], mask, with_hg=True) for s in sets]
    check(n_a == 1 and all(same([t[k] for t in got], solo[k])
                           for k in range(K)),
          f"kernel A's config-axis launch ({n_a}) != {K} solo launches")
    plain = vmap(lambda *a: bigru_layer_plain(*a, mask, with_hg=True))(*per)
    err_a = max(float((a - b).abs().max()) for a, b in zip(got, plain))
    check(err_a <= KERNEL_A_TOL, f"kernel A config axis vs plain: {err_a}")
    g = torch.Generator().manual_seed(41)
    dy = [torch.randn(K, B, L, H, generator=g).to(dev) for _ in range(2)]
    bwd = lambda: bigru_layer_bwd(*per, mask, got[0], got[1], *dy, *got[2:])
    grads, n_c = counted(bigru_layer_bwd, bwd)
    solo_c = [bigru_layer_bwd(*sets[k][:6], mask, got[0][k], got[1][k],
                              dy[0][k], dy[1][k], got[2][k], got[3][k])
              for k in range(K)]
    check(n_c == 1 and all(same([t[k] for t in grads], solo_c[k])
                           for k in range(K)),
          f"kernel C's config-axis launch ({n_c}) != {K} solo launches")
    plain = vmap(lambda xf, xb, wf, bf, wb, bb, yf, yb, df, db, hf, hb:
                 bigru_layer_bwd_plain(xf, xb, wf, bf, wb, bb, mask, yf, yb,
                                       df, db, hf, hb))(*per, *got[:2], *dy,
                                                         *got[2:])
    err_c = max(float((a - b).abs().max() / b.abs().max().clamp(min=1.0))
                for a, b in zip(grads, plain))
    check(err_c <= KERNEL_C_RTOL, f"kernel C config axis vs plain: {err_c}")
    out["bigru"] = {
        "shape": f"K={K} B={B} L={L} H={H}", "launches": [n_a, n_c],
        "fwd_max_abs_err": err_a, "bwd_max_rel_err": err_c,
        "fwd_ms": time_ms(torch, lambda: bigru_forward(
            *per, mask, with_hg=True), 10),
        "fwd_solo_ms": time_ms(torch, lambda: [bigru_forward(
            *s[:6], mask, with_hg=True) for s in sets], 10),
        "bwd_ms": time_ms(torch, bwd, 10),
        "bwd_solo_ms": time_ms(torch, lambda: [bigru_layer_bwd(
            *sets[k][:6], mask, got[0][k], got[1][k], dy[0][k], dy[1][k],
            got[2][k], got[3][k]) for k in range(K)], 10)}
    del sets, per, got, grads, solo, solo_c, plain

    # kernels B and D at the training stack's shapes, the rates per config
    sets = [gcnii_train_inputs(torch, dev, B, L, seed=50 + k, nl=nl)[0]
            for k in range(K)]
    theta = sets[0][4]
    per = [torch.stack([s[i] for s in sets]) for i in (0, 1, 2, 3, 5, 6, 7)]
    seed = torch.tensor([SEED + 4242], dtype=torch.int64, device=dev)
    rate = make_drop_rate(CONFIG_RATES, device=dev)
    slabs = lambda *k: [torch.zeros(*k, B, nl, N, H, device=dev)
                        for _ in RESIDUALS]
    res = slabs(K)
    fwd = lambda: gcnii_forward(*per[:4], theta, *per[4:], alpha=0.2,
                                reason=True, rate=rate, seed=seed,
                                residuals=res)
    y, n_b = counted(gcnii_stack_fwd, fwd)
    solo_res, solo_out = [], []
    for k, r in enumerate(CONFIG_RATES):
        res_k = slabs()
        solo_out.append(gcnii_forward(*sets[k], alpha=0.2, reason=True,
                                      rate=r, seed=seed if r else None,
                                      residuals=res_k))
        solo_res.append(res_k)
    check(n_b == gcnii_fwd_launches(nl, True) and all(
        torch.equal(y[k], solo_out[k])
        and same([t[k] for t in res], solo_res[k]) for k in range(K)),
        f"kernel B's config-axis launch ({n_b}) != {K} solo launches")
    res_p = slabs(K)
    plain = vmap(lambda adj, h, h0, W, ih, hh, b, res, rate:
                 gcnii_stack_plain(adj, h, h0, W, theta, ih, hh, b,
                                   alpha=0.2, reason=True, rate=rate,
                                   seed=seed, residuals=res))(
        *per, res_p, rate)
    scale = max(1.0, float(plain.abs().max()))
    err_b = max(float((a - b).abs().max())
                for a, b in zip([y, *res], [plain, *res_p]))
    check(err_b <= KERNEL_B_RTOL * scale,
          f"kernel B config axis vs plain: {err_b}")
    del plain, res_p
    # the eval forwards: tiled at the batch, resident at one dialogue
    evals = {}
    for name, b in (("tiled", B), ("resident", 1)):
        design = _design(K * b, N, _sm_count(dev), H)
        check(design == DESIGNS[name] == _design(b, N, _sm_count(dev), H),
              f"kernel B's eval design at K={K} B={b}: {design}")
        args = [t[:, :b] for t in per[:3]] + per[3:]
        e, n_e = counted(gcnii_stack_fwd, lambda: gcnii_forward(
            *args[:4], theta, *args[4:], alpha=0.2, reason=True, rate=0.0,
            seed=None, residuals=None))
        check(n_e == gcnii_fwd_launches(nl, True, design) and all(
            torch.equal(e[k], gcnii_forward(
                *(t[k] for t in args[:4]), theta,
                *(t[k] for t in args[4:]), alpha=0.2, reason=True, rate=0.0,
                seed=None, residuals=None)) for k in range(K)),
            f"kernel B's {name} eval launch ({n_e}) != {K} solo launches")
        evals[name] = {
            "B": b, "launches": n_e,
            "ms": time_ms(torch, lambda: gcnii_forward(
                *args[:4], theta, *args[4:], alpha=0.2, reason=True,
                rate=0.0, seed=None, residuals=None), 10),
            "solo_ms": time_ms(torch, lambda: [gcnii_forward(
                *(t[k] for t in args[:4]), theta, *(t[k] for t in args[4:]),
                alpha=0.2, reason=True, rate=0.0, seed=None, residuals=None)
                for k in range(K)], 10)}

    g = torch.Generator().manual_seed(51)
    dh = torch.randn(K, B, N, H, generator=g).to(dev)
    adj, _, h0, W, ih, hh, lb = per
    bwd = lambda: gcnii_stack_bwd(adj, h0, W, theta, ih, hh, lb, res, dh,
                                  alpha=0.2, reason=True, rate=rate,
                                  seed=seed)
    grads, n_d = counted(gcnii_stack_bwd, bwd)
    err_d = 0.0
    for k, r in enumerate(CONFIG_RATES):
        a_k, s_k = sets[k], (seed if r else None)
        want = gcnii_stack_bwd(a_k[0], a_k[2], a_k[3], theta, *a_k[5:],
                               solo_res[k], dh[k], alpha=0.2, reason=True,
                               rate=r, seed=s_k)
        check(same([t[k] for t in grads], want),
              f"kernel D's config-axis launch != solo launch {k}")
        # the plain backward at kernel D's own ReLU decisions (kernel B's
        # tiled products one layer at a time on the stored h1)
        masks = []
        for l in range(nl):
            masks.append(gcnii_forward(
                a_k[0], solo_res[k][3][:, l].contiguous(), a_k[2],
                a_k[3][l:l + 1], theta[l:l + 1], None, None, None,
                alpha=0.2, reason=False, rate=0.0, seed=None,
                residuals=None, design=DESIGNS["tiled"]) > 0)
        ref = gcnii_stack_bwd_plain(a_k[0], a_k[2], a_k[3], theta, *a_k[5:],
                                    solo_res[k], dh[k], alpha=0.2,
                                    reason=True, rate=r, seed=s_k,
                                    relu_masks=masks)
        for a, b in zip(grads, ref):
            e = float((a[k] - b).abs().max() / b.abs().max().clamp(
                min=1e-6))
            check(e <= KERNEL_D_RTOL, f"kernel D config {k} vs plain: {e}")
            err_d = max(err_d, e)
    check(n_d == gcnii_bwd_launches(nl, True),
          f"kernel D's config-axis call launched {n_d}")
    out["gcnii"] = {
        "shape": f"K={K} B={B} N={N} H={H} layers={nl} reason rates "
                 f"{list(CONFIG_RATES)}",
        "launches": [n_b, n_d], "fwd_max_abs_err": err_b,
        "fwd_tolerance": KERNEL_B_RTOL * scale, "bwd_max_rel_err": err_d,
        "fwd_ms": time_ms(torch, fwd, 5),
        "fwd_solo_ms": time_ms(torch, lambda: [gcnii_forward(
            *sets[k], alpha=0.2, reason=True, rate=r,
            seed=seed if r else None, residuals=solo_res[k])
            for k, r in enumerate(CONFIG_RATES)], 5),
        "bwd_ms": time_ms(torch, bwd, 5),
        "bwd_solo_ms": time_ms(torch, lambda: [gcnii_stack_bwd(
            sets[k][0], sets[k][2], sets[k][3], theta, *sets[k][5:],
            solo_res[k], dh[k], alpha=0.2, reason=True, rate=r,
            seed=seed if r else None)
            for k, r in enumerate(CONFIG_RATES)], 5),
        "eval": evals}
    del sets, per, res, solo_res, grads, y, solo_out

    # the masks (mask_check's wiring: W = 0, alpha = 1, no LSTM, so layer
    # 1's entry h shows layer 0's mask), each configuration against its
    # run alone
    g = torch.Generator().manual_seed(6)
    h0 = (torch.rand(K, B, N, H, generator=g) + 0.5).to(dev)
    adj = (torch.rand(K, B, N, N, generator=g) / N).to(dev)
    Wz = torch.zeros(K, nl, 2 * H, H, device=dev)
    res = slabs(K)
    gcnii_stack_fwd(adj, h0, h0, Wz, theta, alpha=1.0, reason=False,
                    rate=rate, seed=seed, residuals=res)
    kept = []
    for k, r in enumerate(CONFIG_RATES):
        res_k = slabs()
        gcnii_stack_fwd(adj[k], h0[k], h0[k], Wz[k], theta, alpha=1.0,
                        reason=False, rate=r, seed=seed if r else None,
                        residuals=res_k)
        got_mask, want_mask = res[0][k][:, 1] != 0, res_k[0][:, 1] != 0
        check(torch.equal(got_mask, want_mask),
              f"configuration {k}'s layer-0 mask differs from its run alone")
        if r:
            check(torch.equal(got_mask, philox.keep_mask(seed, r, B, 0, N,
                                                         H)),
                  f"configuration {k}'s layer-0 mask is not Philox's")
        else:
            check(bool(got_mask.all()),
                  "the rate-0 configuration dropped an element")
        kept.append(float(got_mask.float().mean()))
    out["masks"] = {"layer0_keep_fraction": kept}
    return out


def sweep_phase(torch, dev) -> dict:
    """The grouped sweep at the flagship's widths: kernels A-D with their
    config axis (:func:`config_axis_case`); the first group of the IEMOCAP
    grid cut to K = 4 (both dropouts at two learning rates), 2 epochs at B
    = 32, one batched step a batch through kernels A-D; two of its configs
    against their solo steps (the first step from the same weights: loss
    within 1e-6 relative, gradients within 1e-5 of scale, stepped weights
    within 1e-6 of scale beyond what Adam makes of that gradient gap; the
    batched products sum in another order, so not bit for bit) and
    ``Trainer.fit`` of the combo alone (equal test F-scores, accuracies
    and best epochs, losses within 1e-5 relative); the group's batch timed
    and profiled beside the solo step, launching what one solo step
    launches; the grid's whole first group (K = 16) timed over 3 batches; and
    ``cli.sweep --vmap`` run twice on one directory (the second skips the
    finished group)."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from mmdfn_torch import ops
    from mmdfn_torch.cli.sweep import combos
    from mmdfn_torch.config import ExperimentConfig
    from mmdfn_torch.data.batching import BucketBatcher
    from mmdfn_torch.data.datasets import IEMOCAPDataset
    from mmdfn_torch.data.synthetic import make_synthetic_iemocap_pickle
    from mmdfn_torch.train import Trainer
    from mmdfn_torch.train.trainer import prepare_inputs
    from mmdfn_torch.train.vmap_sweep import VmapSweep, group_combos
    from mmdfn_torch.weights import build_model

    config_axis = config_axis_case(torch, dev)
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp()
    try:
        pkl = f"{tmp}/iem.pkl"
        make_synthetic_iemocap_pickle(pkl, **SWEEP_DATA)
        train = IEMOCAPDataset(pkl, train=True).dialogues()
        test = IEMOCAPDataset(pkl, train=False).dialogues()
        static, group = group_combos(list(combos("IEMOCAP")))[0]
        picked = [c for c in group if c["l2"] == 1e-4 and c["gamma"] == 0.5]
        K = len(picked)
        check(K == 4 and {c["dropout"] for c in picked} == {0.2, 0.4}
              and len({c["lr"] for c in picked}) == 2, f"combos {picked}")
        base = ExperimentConfig(dataset="IEMOCAP", epochs=2,
                                batch_size=TRAIN_B)
        batches = [prepare_inputs(b, dev) for b in BucketBatcher(
            train, TRAIN_B, 2, base.buckets, shuffle=True,
            seed=base.seed).epoch(0)]
        everyone = [True] * K

        def timed(step, reps=SWEEP_REPS):
            """Median wall, launches and peak memory of ``reps`` calls
            (after one warm-up), then the stream time and device busy of 2
            chained calls."""
            step(0)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            wall = []
            for i in range(reps):
                t1 = time.perf_counter()
                step(i)
                torch.cuda.synchronize()
                wall.append((time.perf_counter() - t1) * 1e3)
            out = {"ms_median": sorted(wall)[len(wall) // 2], "ms_all": wall,
                   "launches": {k: v / reps
                                for k, v in ops.launch_counts().items()},
                   "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(2):
                step(i)
            end.record()
            end.synchronize()
            out["stream_ms"] = start.elapsed_time(end) / 2
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for i in range(2):
                    step(i)
                torch.cuda.synchronize()
            kern, _ = device_events(torch, prof)
            if kern:
                busy = sum(e.self_device_time_total for e in kern) / 1e3 / 2
                out.update(device_busy_ms=busy,
                           idle_share=1.0 - busy / out["stream_ms"])
            else:
                out.update(device_busy_ms="not measured",
                           idle_share="not measured")
            return out

        # the solo step alone on the card, then the group's batch on the
        # same batches: each peak holds its own weights and Adam states
        solo_tr = Trainer(dataclasses.replace(base, **picked[0]),
                          device=dev)
        solo_t = timed(
            lambda i: solo_tr.train_step(batches[i % len(batches)], seed=i))
        del solo_tr
        torch.cuda.empty_cache()
        sweep = VmapSweep(base, picked, device=dev)
        group_t = timed(
            lambda i: sweep.step(batches[i % len(batches)], 0, i, everyone))
        check(group_t["launches"] == solo_t["launches"],
              f"group launches {group_t['launches']} != one solo step's "
              f"{solo_t['launches']}")

        # the grid's real group (K = 16), 3 batches, then freed
        big = VmapSweep(base, group, device=dev)
        check(big.K == 16, f"the first IEMOCAP group has {big.K} configs")
        group16_t = timed(
            lambda i: big.step(batches[i % len(batches)], 0, i,
                               [True] * big.K), reps=3)
        check(group16_t["launches"] == solo_t["launches"],
              f"K = 16 group launches {group16_t['launches']}")
        del big
        torch.cuda.empty_cache()

        # the group's first step against the solo step of each held
        # config, from the same weights on the same batch and seed
        held = [0, next(k for k, c in enumerate(picked)
                        if c["dropout"] != picked[0]["dropout"]
                        and c["lr"] != picked[0]["lr"])]
        fresh = VmapSweep(base, picked, device=dev)
        losses0 = fresh.step(batches[0], 0, 0, everyone)
        first_step = []
        for k in held:
            cfg_k = dataclasses.replace(fresh.cfg, **picked[k])
            tr = Trainer(cfg_k, device=dev,
                         model=build_model(cfg_k, fresh._init))
            loss, _ = tr.train_step(batches[0], tr.step_seed(0, 0))
            gap = {"config": k, "loss_rel_diff": float(
                (losses0[k] - loss).abs() / loss.abs()),
                "max_grad_diff_of_scale": 0.0, "max_weight_diff_of_scale": 0.0}
            for n, p in tr.model.named_parameters():
                if p.grad is None:
                    continue
                d = float((fresh.params[n].grad[k] - p.grad).abs().max())
                gap["max_grad_diff_of_scale"] = max(
                    gap["max_grad_diff_of_scale"],
                    d / float(p.grad.abs().max()))
                # beyond what Adam's first step lr g / (|g| + eps) makes of
                # the gradient gap d, where its sign cannot differ
                g = (p.grad + cfg_k.l2 * fresh._init[n].to(dev)).abs()
                adam = cfg_k.lr * 1e-8 * d / (g - d + 1e-8) ** 2
                w = (fresh.params[n].detach()[k] - p.detach()).abs() - adam
                gap["max_weight_diff_of_scale"] = max(
                    gap["max_weight_diff_of_scale"],
                    float(w.where(g > d, 0.0).max() / p.detach().abs().max()))
            first_step.append(gap)
            check(gap["loss_rel_diff"] <= 1e-6
                  and gap["max_grad_diff_of_scale"] <= 1e-5
                  and gap["max_weight_diff_of_scale"] <= 1e-6,
                  f"the group's first step differs from config {k}'s solo "
                  f"step: {gap}")
            del tr
        del fresh
        torch.cuda.empty_cache()

        # the command line's first run beside the checks below, which
        # time nothing
        out = f"{tmp}/sweep"
        argv = [sys.executable, "-m", "mmdfn_torch.cli.sweep", "--vmap",
                "--dataset", "IEMOCAP", "--data_dir", pkl, "--limit", "4",
                "--epochs", "1", "--out_dir", out]
        t0 = time.perf_counter()
        cli = subprocess.Popen(argv, cwd=ROOT, stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True)
        try:
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            res = sweep.run(train, test, verbose=False)
            group_s = time.perf_counter() - t1
            group_run_peak = torch.cuda.max_memory_allocated() / 1e9
            keys = ("epoch", "train_loss", "test_fscore", "test_acc",
                    "test_loss")

            def solo(combo):
                tr = Trainer(dataclasses.replace(sweep.cfg, **combo),
                             device=dev)
                r = tr.fit(train, test, verbose=False)
                return tr, [{k: h[k] for k in keys} for h in r.history], \
                    r.best_epoch

            def weight_gap(a, b):
                sa, sb = a.state_dict(), b.state_dict()
                return max(float((sa[n] - w).abs().max()
                                 / w.abs().max().clamp(min=1e-30))
                           for n, w in sb.items() if w.is_floating_point())

            # one run alone, twice: does the card repeat it bit for bit?
            tr_a, rows_a, best_a = solo(picked[0])
            tr_b, rows_b, _ = solo(picked[0])
            exact = (rows_a == rows_b
                     and weight_gap(tr_a.model, tr_b.model) == 0.0)
            comparisons = []
            for k in held:
                tr_k, rows_k, best_k = ((tr_a, rows_a, best_a) if k == 0
                                        else solo(picked[k]))
                got = res.history[k]
                best = [res.best_epoch[k], best_k]
                ok = best[0] == best[1] and len(got) == len(rows_k) and all(
                    g["epoch"] == w["epoch"]
                    and g["test_fscore"] == w["test_fscore"]
                    and g["test_acc"] == w["test_acc"] and all(
                        abs(g[x] - w[x]) <= 1e-5 * abs(w[x])
                        for x in ("train_loss", "test_loss"))
                    for g, w in zip(got, rows_k))
                comparisons.append({
                    "combo": picked[k], "group": got, "solo": rows_k,
                    "best_epoch": best, "equal": ok,
                    "max_weight_diff_of_scale": weight_gap(
                        sweep.trainers[k].model, tr_k.model)})
                check(ok, f"config {k} in the group differs from its run "
                          f"alone: {got} vs {rows_k}, best epochs {best}")
            first, err = cli.communicate(timeout=600)
        finally:
            if cli.poll() is None:
                cli.kill()
                cli.wait()
        check(cli.returncode == 0, f"cli.sweep --vmap exited "
                                   f"{cli.returncode}: {err[-2000:]}")
        summary = Path(f"{out}/summary.jsonl").read_text()
        second = run_cli(argv[2:])
        cli_s = time.perf_counter() - t0
        check(summary.count("\n") == 4 and "BEST:" in first,
              f"the --vmap CLI's summary: {summary}")
        check("group already complete" in second
              and Path(f"{out}/summary.jsonl").read_text() == summary,
              "the second --vmap run did not skip the finished group")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"config": f"IEMOCAP GDF reason {NLAYERS} layers, B={TRAIN_B} "
                      f"L<={TRAIN_L}, group {static} cut to K={K}, 2 epochs",
            "combos": picked, "group_run_s": group_s,
            "group_run_peak_mem_gb": group_run_peak,
            "best_test_fscore": res.best_test_fscore,
            "solo_repeats_bit_for_bit": exact,
            "group_first_step_vs_solo": first_step,
            "group_vs_solo": comparisons,
            "group_batch": group_t, "solo_step": solo_t,
            "group16_batch": group16_t,
            "group16_over_solo_wall": group16_t["ms_median"]
            / solo_t["ms_median"],
            "config_axis": config_axis,
            "group_ms_per_config_step": group_t["ms_median"] / K,
            "group_over_solo_wall": group_t["ms_median"]
            / solo_t["ms_median"],
            "group_peak_over_solo_gb": group_t["peak_mem_gb"]
            - solo_t["peak_mem_gb"],
            "cli_two_runs_s": cli_s,
            "cli_summary": [json.loads(l) for l in summary.splitlines()]}


# DailyDialogue: 64 + 16 + 32 dialogues of U[3, 35] turns, 20 words of a
# 5000-word table (the JAX package's defaults): 2 train batches of B = 32
# at bucket 48
DAILY_DATA = dict(n_per_split=(64, 16, 32), min_len=3, max_len=35,
                  max_words=20, vocab_size=5000, seed=SEED)
DAILY_OTHER_BASES = ("LSTM", "None", "DialogRNN")
# the operators of the TextCNN (forward and backward) whose device time the
# profile names
DAILY_OPS = ("aten::embedding", "aten::embedding_dense_backward",
             "aten::cudnn_convolution", "aten::convolution_backward",
             "aten::amax")


def daily_config(base="GRU", **kw):
    """DailyDialogue at the JAX package's defaults, the flagship's
    training settings (B = 32, dropout 0.4)."""
    from mmdfn_torch.config import ExperimentConfig

    return ExperimentConfig(dataset="DailyDialogue", base_model=base,
                            batch_size=TRAIN_B, dropout=RATE, seed=SEED, **kw)


def step_errs(loss_a, grads_a, loss_b, grads_b, what) -> dict:
    """Two steps' loss error relative to b's, and the largest of each
    gradient's error over its max |.| in b."""
    loss_err = abs(loss_a - loss_b) / abs(loss_b)
    errs = {}
    for name, gb in grads_b.items():
        ga = grads_a[name].to(gb.device)
        check(float(gb.abs().max()) > 0, f"{what}: no gradient at {name}")
        errs[name] = float((ga - gb).abs().max()) / float(gb.abs().max())
    worst = max(errs, key=errs.get)
    return {"loss": loss_a, "loss_rel_err": loss_err,
            "grad_max_rel_err": errs[worst], "worst_param": worst}


def steps_agree(errs: dict) -> bool:
    return (errs["loss_rel_err"] <= STEP_LOSS_RTOL
            and errs["grad_max_rel_err"] <= STEP_GRAD_RTOL)


def grads_close(loss_a, grads_a, loss_b, grads_b, what) -> dict:
    """Two steps' losses to ``STEP_LOSS_RTOL`` relative and each
    gradient to ``STEP_GRAD_RTOL`` of its max |.| in b."""
    out = step_errs(loss_a, grads_a, loss_b, grads_b, what)
    check(out["loss_rel_err"] <= STEP_LOSS_RTOL,
          f"{what}: loss {loss_a} vs {loss_b}")
    check(out["grad_max_rel_err"] <= STEP_GRAD_RTOL,
          f"{what}: gradient of {out['worst_param']} "
          f"{out['grad_max_rel_err']} of its scale")
    return out


def daily_card_vs_cpu(torch, dev, cfg, batch) -> dict:
    """One training step on the card against the same step on the CPU from
    the same weights (``cfg.seed``) and batch, every dropout off (the
    TextCNN's fixed 0.5 set to 0 on both models: the two devices'
    generators draw different bits)."""
    import dataclasses

    from mmdfn_torch import ops

    cfg = dataclasses.replace(cfg, dropout=0.0, rec_dropout=0.0)

    def step(where):
        tr = trainer_for(cfg, where)
        tr.model.cnn_feat_extractor.dropout = 0.0
        t0 = time.perf_counter()
        loss, _ = tr.train_step({k: v.to(tr.device) for k, v in batch.items()},
                                seed=1)
        loss = float(loss)
        return (loss, {n: p.grad for n, p in tr.model.named_parameters()},
                time.perf_counter() - t0)

    loss_k, grads_k, card_s = step(dev)
    before = ops.launch_counts()
    loss_c, grads_c, cpu_s = step("cpu")
    check(ops.launch_counts() == before, "the CPU step launched a kernel")
    out = grads_close(loss_k, grads_k, loss_c, grads_c,
                      f"{cfg.base_model} card vs CPU")
    return {**out, "card_step_s": card_s, "cpu_step_s": cpu_s}


def daily_cli(pkl: str, tmp: str, dev) -> dict:
    """The user's commands on the card: one epoch of ``run_train_erc
    --dataset DailyDialogue --base_model GRU``, then ``--test_label`` on its
    directory; the saved predictions must be ``DailyTrainer.evaluate``'s
    of the saved weights."""
    import numpy as np

    from mmdfn_torch.cli import run_train_erc
    from mmdfn_torch.data.datasets import DailyDialogueDataset
    from mmdfn_torch.runtime import checkpoint as ckpt_lib
    from mmdfn_torch.train import DailyTrainer

    ckpt, out = f"{tmp}/ckpt", f"{tmp}/out"
    flags = ["--dataset", "DailyDialogue", "--data_dir", pkl,
             "--base_model", "GRU"]
    t0 = time.perf_counter()
    train_out = run_cli(["mmdfn_torch.cli.run_train_erc", *flags,
                         "--epochs", "1", "--save_model_dir", ckpt])
    train_s = time.perf_counter() - t0
    check("epoch: 0, train_loss: " in train_out, "no DailyDialogue epoch line")
    test_out = run_cli(["mmdfn_torch.cli.run_train_erc", *flags,
                        "--test_label", "--load_model", ckpt,
                        "--save_model_dir", out])
    check("test_fscore:" in test_out, "no DailyDialogue test_fscore line")
    cfg = run_train_erc.config_from_args(
        run_train_erc.build_parser().parse_args(flags))
    tr = DailyTrainer(cfg, device=dev)
    ckpt_lib.restore_checkpoint(ckpt, tr.model)
    m = tr.evaluate(DailyDialogueDataset("test", pkl).dialogues())
    preds = np.load(f"{out}/test_pred.npy")
    check(np.array_equal(preds, m.preds) and np.array_equal(
        np.load(f"{out}/test_label.npy"), m.labels),
        "--test_label's predictions differ from DailyTrainer.evaluate's")
    check(Path(f"{out}/test_activations.npz").exists(),
          "--test_label wrote no activations")
    return {"train_epoch_s": train_s, "cli_s": time.perf_counter() - t0,
            "test_line": [l for l in test_out.splitlines()
                          if l.startswith("test_acc")][0],
            "test_predictions": len(preds)}


def daily_phase(torch, dev) -> dict:
    """DailyDialogue end to end at the JAX package's default widths: the
    GRU base's step against its plain step, 10 timed steps (A 2, C 2, B 0,
    D 0 a step) with the TextCNN's operators named in the profile, kernels
    A and C alone at its shape; the other bases' steps on the card against
    the CPU's and 3 timed LSTM steps; the command lines; the frozen
    pretrained table."""
    import numpy as np

    from mmdfn_torch.data.datasets import DailyDialogueDataset
    from mmdfn_torch.data.synthetic import make_synthetic_daily_pickle
    from mmdfn_torch.train import DailyTrainer

    tmp = tempfile.mkdtemp()
    try:
        pkl = f"{tmp}/daily.pkl"
        make_synthetic_daily_pickle(pkl, **DAILY_DATA)
        cfg = daily_config()
        check((cfg.vocab_size, cfg.max_words, cfg.embedding_dim,
               cfg.cnn_filters, cfg.cnn_output_size) == (5000, 20, 300, 50,
                                                        100),
              "the JAX package's default word-level widths")
        tr = DailyTrainer(cfg, device=dev)
        train = DailyDialogueDataset("train", pkl).dialogues()
        batches = [tr._prepare(b) for b in tr._batcher(train,
                                                       shuffle=True).epoch(0)]
        B, L, W = batches[0]["tokens"].shape
        check(len(batches) == 2 and B == TRAIN_B and W == 20,
              f"DailyDialogue batches {[b['tokens'].shape for b in batches]}")
        out = {"shape": f"B={B} L={L} W={W} (bucket of U[3, 35] turns), "
                        f"dropout {RATE}, TextCNN dropout 0.5"}

        t0 = time.perf_counter()
        checked = step_check(torch, dev, cfg, batches[0])
        timed = timed_steps(torch, dev, cfg, batches, named_ops=DAILY_OPS)
        per = timed["launches_per_step"]
        check(per == {"bigru_fwd": 2, "bigru_bwd": 2, "gcnii_fwd": 0,
                      "gcnii_bwd": 0}, f"launches a DailyDialogue step: {per}")
        a = bigru_case(torch, dev, B, L, train=True)
        c = bigru_bwd_case(torch, dev, B, L, a["train_ms"])
        out["GRU"] = {"step_check": checked,
                      "train": {k: timed[k] for k in TIMED_KEYS + (
                          "bigru_kernels", "named_ops", "step_ms_all")
                                if k in timed},
                      "kernels_at_this_shape": {"bigru_fwd": a,
                                                "bigru_bwd": c},
                      "seconds": time.perf_counter() - t0}
        print(json.dumps({"daily": "GRU", "step_ms_median":
                          timed["step_ms_median"]}), flush=True)

        t0 = time.perf_counter()
        out["card_vs_cpu"] = {base: daily_card_vs_cpu(
            torch, dev, daily_config(base), batches[0])
            for base in DAILY_OTHER_BASES}
        timed = timed_steps(torch, dev, daily_config("LSTM"), batches, reps=3)
        out["LSTM"] = {"train": {k: timed[k] for k in TIMED_KEYS
                                 if k in timed},
                       "seconds": time.perf_counter() - t0}
        print(json.dumps({"daily": "other bases", "seconds":
                          out["LSTM"]["seconds"]}), flush=True)

        out["cli"] = daily_cli(pkl, tmp, dev)

        tr = DailyTrainer(cfg, device=dev)
        vectors = np.random.default_rng(SEED).standard_normal(
            (cfg.vocab_size, cfg.embedding_dim)).astype(np.float32)
        tr.init_pretrained_embeddings(vectors, freeze=True)
        cnn = tr.model.cnn_feat_extractor
        fc = cnn.fc.weight.detach().clone()
        tr.train_step(batches[0], seed=1)
        table = cnn.embedding.weight.detach().cpu().numpy()
        check(np.array_equal(table, vectors),
              "the frozen pretrained table moved")
        check(not torch.equal(cnn.fc.weight, fc), "fc did not move")
        out["frozen_table_bit_equal"] = True
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# the raw-input model's inputs: a 3 s waveform at 16 kHz and a 48 x 48 x 3
# face crop (FER2013's size) per utterance
RAW_SAMPLES, FACE = 48_000, 48
# the operators of the raw step named in its profile: cuDNN's convolutions
# forward and backward, GroupNorm, the DenseNet's concatenations and
# pooling, ReLU's backward, the products
RAW_OPS = ("aten::cudnn_convolution", "aten::convolution_backward",
           "aten::native_group_norm", "aten::native_group_norm_backward",
           "aten::cat", "aten::avg_pool2d", "aten::avg_pool2d_backward",
           "aten::threshold_backward", "aten::mm", "aten::bmm")
HIST_BINS = 64           # the CLI's --tensorboard histograms


def raw_batch(torch, rng, dev, B=TRAIN_B, L=TRAIN_L) -> dict:
    """:func:`train_batch`'s recipe, then from the same generator a
    standard-normal waveform (zero at pad utterances) and face crop per
    utterance: ``audio`` (B, L, 48000) and ``visual`` (B, L, 48, 48, 3) in
    place of the precomputed features; on the card."""
    import numpy as np

    batch = train_batch(torch, rng, dev, B, L)
    umask = batch["umask"].cpu().numpy()
    wav = rng.standard_normal((B, L, RAW_SAMPLES), dtype=np.float32)
    wav *= umask[..., None]
    faces = rng.standard_normal((B, L, FACE, FACE, 3), dtype=np.float32)
    batch.update(audio=torch.from_numpy(wav).to(dev),
                 visual=torch.from_numpy(faces).to(dev))
    return batch


def check_histogram(name, values, row, bins) -> dict:
    """One :func:`grad_histograms_device` row against ``np.histogram`` of
    the same values on the host: the counts sum to ``num``, the edges
    agree within 1e-6 of the range's magnitude, and the counts are equal
    but for values that lie between the two computations of an edge where
    they round apart (the row's f32 ``start (1 - t) + stop t``, numpy's
    ``start + i step``: a few ulps of the range's magnitude), each of
    which moves one count between neighbouring bins."""
    import numpy as np

    counts, edges = np.histogram(values, bins=bins)
    scale = max(float(np.abs(edges).max()), 1e-30)
    edge_err = float(np.abs(row["edges"] - edges).max()) / scale
    check(int(row["counts"].sum()) == row["num"] == values.size,
          f"histogram of {name}: counts do not sum to num")
    check(edge_err <= 1e-6, f"histogram of {name}: edges {edge_err}")
    apart = row["edges"] != edges
    between = sum(int(((values >= min(a, b)) & (values <= max(a, b))).sum())
                  for a, b in zip(row["edges"][apart], edges[apart]))
    moved = int(np.abs(row["counts"] - counts).sum())
    check(moved <= 2 * between, f"histogram of {name}: {moved} counts "
                                f"moved, {between} values between two "
                                "edges that round apart")
    return {"moved": moved, "edge_err": edge_err}


def log_mel_reading(torch, wav, warm=3, reps=20) -> dict:
    """The log-mel spectrogram alone on ``wav`` after ``warm`` calls: the
    stream time of each of ``reps`` calls (CUDA events), and in a profile
    of ``reps`` more the device time a call (the union of its kernels) and
    each kernel's share."""
    from torch.profiler import ProfilerActivity, profile

    from mmdfn_torch.frontends import log_mel_spectrogram

    run = lambda: log_mel_spectrogram(wav)
    for _ in range(warm):
        run()
    torch.cuda.synchronize()
    each = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        each.append(start.elapsed_time(end))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    kern, _ = device_events(torch, prof)
    each.sort()
    return {"stream_ms_min_median_max": [each[0], each[reps // 2],
                                         each[-1]],
            "device_ms": sum(e.self_device_time_total for e in kern)
            / 1e3 / reps,
            "kernels": [[kernel_label(e.key),
                         e.self_device_time_total / 1e3 / reps,
                         e.count / reps]
                        for e in sorted(kern, key=lambda e:
                                        -e.self_device_time_total)[:6]]}


def raw_phase(torch, dev) -> dict:
    """The raw-input model (``RawInputDialogueGNN``: log-mel and DenseNet
    frontends into the flagship, text features as they are) at the
    flagship's widths and training settings on :func:`raw_batch`: the
    log-probs with the kernels against the plain versions, the step
    against the plain step, 10 timed steps (A 4, C 4, B 49, D 116 a step;
    the convolutions, GroupNorm and the products by operator), the busy
    and idle share of 3 steps (``profiling.device_time_ms``), the log-mel
    alone before the model runs and after the steps, one step's gradient
    histograms against numpy's, and 6 Adam steps on one batch whose loss
    must fall (lr 3e-4; lr 3e-3 reported, with the plain versions'
    steps)."""
    import contextlib
    import dataclasses

    import numpy as np

    from mmdfn_torch import ops
    from mmdfn_torch.runtime.profiling import (device_time_ms,
                                               grad_histograms_device,
                                               histograms_to_host)
    from mmdfn_torch.train import Trainer
    from mmdfn_torch.weights import build_raw_model

    cfg = family_config(graph_type="GDF", reason_flag=True)
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    batches = [raw_batch(torch, rng, dev) for _ in range(2)]
    b0 = batches[0]
    B, L = b0["umask"].shape
    out = {"shape": f"B={B} L<={L}: {RAW_SAMPLES} samples (3 s at 16 kHz) "
                    f"and a {FACE}x{FACE}x3 crop an utterance; GDF reason "
                    f"{NLAYERS} layers, dropout {RATE}",
           "batch_s": time.perf_counter() - t0}

    out["log_mel_first"] = log_mel_reading(torch, b0["audio"])
    model = build_raw_model(cfg).to(dev).eval()
    args = [b0[k] for k in ("text", "qmask", "umask", "audio", "visual")]
    with torch.no_grad():
        ops.reset_launch_counts()
        logp = model(*args)
        launches = ops.launch_counts()
        with ops.plain_ops():
            logp_plain = model(*args)
    valid = b0["umask"] > 0
    err = float((logp - logp_plain)[valid].abs().max())
    check(logp.shape == (B, L, 6) and bool(torch.isfinite(logp).all())
          and float((logp.exp().sum(-1) - 1)[valid].abs().max()) < 1e-4,
          "raw log-probs not finite, normalized, (B, L, 6)")
    check(err <= SERVE_TOL, f"raw log-probs, kernels vs plain: {err}")
    check(all(v > 0 for k, v in launches.items() if "fwd" in k),
          f"the raw forward did not launch kernels A and B: {launches}")
    out["log_probs"] = {"max_abs_err_vs_plain": err,
                        "tolerance": SERVE_TOL, "launches": launches}
    del model, logp, logp_plain

    out["step_check"] = step_check(torch, dev, cfg, b0, hold_decisions=True,
                                   build=build_raw_model)
    timed = timed_steps(torch, dev, cfg, batches, named_ops=RAW_OPS,
                        build=build_raw_model)
    per = timed["launches_per_step"]
    check(per == {"bigru_fwd": 4, "bigru_bwd": 4, "gcnii_fwd": 49,
                  "gcnii_bwd": 116}, f"launches a raw step: {per}")
    out["train"] = {k: timed[k] for k in TIMED_KEYS + (
        "bigru_kernels", "named_ops", "step_ms_all", "peak_mem_gb")
        if k in timed}

    tr = Trainer(cfg, device=dev, model=build_raw_model(cfg))
    tr.train_step(b0, seed=1)
    busy, total = device_time_ms(lambda: [
        tr.train_step(batches[i % 2], seed=600 + i) for i in range(3)])
    out["device_time"] = {"busy_ms_per_step": busy / 3,
                          "window_ms_per_step": total / 3,
                          "idle_share": 1.0 - busy / total}
    out["log_mel_after_steps"] = log_mel_reading(torch, b0["audio"])

    grads = {n: p.grad for n, p in tr.model.named_parameters()}
    for front in ("audio_frontend", "visual_frontend"):
        top = max(float(g.abs().max()) for n, g in grads.items()
                  if n.startswith(front))
        check(top > 0, f"no gradient reached the {front}")
        out[f"{front}_grad_max"] = top
    rows = histograms_to_host([grad_histograms_device(grads, HIST_BINS)])[0]
    hist = [check_histogram(n, g.cpu().numpy().ravel(), rows[n], HIST_BINS)
            for n, g in grads.items()]
    out["histograms"] = {"parameters": len(hist),
                         "counts_moved": sum(h["moved"] for h in hist),
                         "max_edge_err": max(h["edge_err"] for h in hist)}
    del tr, grads

    # 6 Adam steps on one batch, dropout 0, the focal loss without class
    # weights (tests/test_raw_input.py's step), held at the flagship's lr.
    # At that test's lr of 3e-3 the 16-layer graph model overshoots, in the
    # JAX package too (tests/test_torch_raw_lr_witness.py): reported, with
    # the plain versions' steps from the same weights beside the kernels'
    for lr, plain in ((3e-4, False), (3e-3, False), (3e-3, True)):
        fit_cfg = dataclasses.replace(cfg, lr=lr, l2=0.0, dropout=0.0,
                                      class_weight=False)
        tr = Trainer(fit_cfg, device=dev, model=build_raw_model(fit_cfg))
        with ops.plain_ops() if plain else contextlib.nullcontext():
            losses = [float(tr.train_step(b0, seed=700 + i)[0])
                      for i in range(6)]
        check(all(map(math.isfinite, losses)), f"losses {losses}")
        out[f"fixed_batch_losses_lr{lr}" + ("_plain" if plain else "")] = \
            losses
        del tr
    losses = out["fixed_batch_losses_lr0.0003"]
    check(losses[-1] < losses[0],
          f"6 Adam steps on one batch did not lower the loss: {losses}")
    return out


# the fast phase: the JAX package's production configuration (--tpu_fast),
# kernels B and D in their bf16 mode

# the bf16 mode against its plain version: both round at the TPU kernel's
# points and differ by f32 summation order; where that moves a value
# across a bf16 rounding boundary, by one bf16 step of it, which moves the
# outputs it reaches (through adj, every node of its dialogue) by up to
# ~2e-4 of their scale.  So at most BF16_SHARE of the elements may lie
# past BF16_RTOL of the scale (past one bf16 step of the element beside
# it, for the outputs rounded to bf16), and none past BF16_CAP of it; the
# f32 mode lies ~1e-3 of the scale from the bf16 function in most elements
BF16_RTOL, BF16_SHARE, BF16_CAP = 1e-4, 1e-3, 1e-3
FAST_GRAD_RTOL = 3e-4   # the fast step's gradients, kernels vs plain, of
                        # each one's max abs (fast_step_check; 1.0e-4 was
                        # measured)


def bf16_agree(torch, got, want, what, rounded=False, scale=None) -> dict:
    """The bf16 mode's output ``got`` against the plain version's ``want``
    (see ``BF16_RTOL``); the max abs error and the share of the elements
    past the bound."""
    s = float(want.abs().max().clamp(min=1e-6)) if scale is None else scale
    d = (got.float() - want.float()).abs()
    step = 2.0 ** -7 * want.float().abs() if rounded else 0.0
    share, err = (float((d > BF16_RTOL * s + step).float().mean()),
                  float(d.max()))
    check(share <= BF16_SHARE and bool((d <= BF16_CAP * s + step).all()),
          f"{what}, bf16 mode vs plain: {share} of the elements past the "
          f"bound, max {err}, scale {s}")
    return {"max_abs_err": err, "share_past_bound": share, "scale": s}


def kernel_d_decisions(torch, tol, call) -> tuple:
    """Kernel D's ReLU decisions in a bf16-mode call (``call``, one entry
    of ``gcnii_stack_bwd.kept``; its tdpre slab is nonzero where the ReLU
    passed) against the plain bf16 recompute of each layer's pre from the same bf16
    slabs, wherever the gradient past the ReLU is not zero: two summation
    orders may decide apart only where |pre| is within ``tol`` of 0.
    Returns (the kernel's masks, the plain backward at them, the flips,
    max |pre| among the flips)."""
    from mmdfn_torch.ops import gcnii_stack_bwd, gcnii_stack_bwd_plain

    args, kw, tdpre = call
    masks = [t != 0 for t in tdpre]
    seen = []
    with torch.no_grad():
        ref = gcnii_stack_bwd_plain(*args, relu_masks=masks,
                                    relu_inputs=seen, **kw)
    flips, flip_pre = 0, 0.0
    for m, (pre, g) in zip(masks, seen):
        differ = (g != 0) & (m != (pre > 0))
        flips += int(differ.sum())
        if bool(differ.any()):
            flip_pre = max(flip_pre, float(pre[differ].abs().max()))
    check(flip_pre <= tol, f"kernel D's bf16 ReLU decisions differ from the "
                           f"plain recompute at |pre| = {flip_pre} > {tol}")
    return masks, ref, flips, flip_pre


def fast_kernels(torch, dev) -> dict:
    """Kernels B and D in their bf16 mode at the flagship's training shapes
    (B = 32 dialogues of U[20, 80] turns, N = 240, 16 layers, the
    reason-LSTM, rate 0.4) against their plain bf16 versions (D at its own
    ReLU decisions, read from its tdpre slab), each timed beside the f32
    mode in the same call (f32, bf16, bf16, f32); D's decisions where they
    differ from the plain recompute, each within the forward's tolerance
    of 0 (:func:`kernel_d_decisions`); the residual bytes of both modes; kernel B serving one dialogue at bucket 64 (N = 192, rate
    0, the tiled design) against plain, beside the f32 mode's design; and
    a config axis of 4 (rates ``CONFIG_RATES``) against 4 solo calls, bit
    for bit."""
    from mmdfn_torch.nn.drop_override import make_drop_rate
    from mmdfn_torch.ops import (gcnii_stack_bwd, gcnii_stack_bwd_plain,
                                 gcnii_stack_fwd, gcnii_stack_plain)
    from mmdfn_torch.ops.bigru import _sm_count
    from mmdfn_torch.ops.gcnii import (DESIGNS, RESIDUALS_BF16, _design,
                                       _forward, gcnii_bwd_launches,
                                       gcnii_fwd_launches, residual_slabs)

    args, g = gcnii_train_inputs(torch, dev, TRAIN_B, TRAIN_L)
    adj, h, h0, W, theta, ih, hh, lb = args
    B, N, _ = h.shape
    nl = W.shape[0]
    seed = torch.tensor([SEED + 12345], dtype=torch.int64, device=dev)
    opts = dict(alpha=0.2, reason=True, rate=RATE, seed=seed)
    slabs = lambda mode: residual_slabs((B, nl, N, H), mode, dev)
    res16, res16_p, res32 = slabs("bf16"), slabs("bf16"), slabs("f32")
    fwd16 = lambda: gcnii_stack_fwd(*args, residuals=res16, mode="bf16",
                                    **opts)
    fwd32 = lambda: gcnii_stack_fwd(*args, residuals=res32, **opts)
    plain16 = lambda: gcnii_stack_plain(*args, residuals=res16_p,
                                        mode="bf16", **opts)
    n0 = gcnii_stack_fwd.launches
    out = fwd16()
    check(gcnii_stack_fwd.launches - n0 == gcnii_fwd_launches(
        nl, True, DESIGNS["tiled"]), "kernel B's bf16 mode: its launches")
    fwd32()
    torch.cuda.synchronize()
    want = plain16()
    scale = max(1.0, float(want.abs().max()))
    fwd = bf16_agree(torch, out, want, "kernel B (training mode)",
                     scale=scale)
    for a, b, name in zip(res16, res16_p, RESIDUALS_BF16):
        bf16_agree(torch, a, b, f"kernel B's residual {name}", rounded=True,
                   scale=scale)

    dh = torch.randn(B, N, H, generator=g).to(dev)
    bwd_args = (adj, h0, W, theta, ih, hh, lb)
    bwd16 = lambda: gcnii_stack_bwd(*bwd_args, res16, dh, mode="bf16",
                                    **opts)
    bwd32 = lambda: gcnii_stack_bwd(*bwd_args, res32, dh, **opts)
    gcnii_stack_bwd.kept = []
    try:
        n0 = gcnii_stack_bwd.launches
        got = bwd16()
        check(gcnii_stack_bwd.launches - n0 == gcnii_bwd_launches(nl, True),
              "kernel D's bf16 mode: its launches")
        torch.cuda.synchronize()
        _, ref, flips, flip_pre = kernel_d_decisions(
            torch, BF16_RTOL * scale, gcnii_stack_bwd.kept[-1])
    finally:
        gcnii_stack_bwd.kept = None
    check(all(torch.equal(t, t.to(torch.bfloat16).float())
              for t in (got[0], got[2], got[3])),
          "kernel D's d_adj, d_h0 and dW are rounded to bf16")
    names = ("d_adj", "d_h", "d_h0", "dW", "dW_ih", "dW_hh", "db")
    bwd = {n: bf16_agree(torch, a, b, f"kernel D's {n}",
                         rounded=n in ("d_adj", "d_h0", "dW"))
           for n, a, b in zip(names, got, ref)}

    ms = {k: [] for k in ("fwd_f32", "fwd_bf16", "bwd_f32", "bwd_bf16")}
    for mode in ("f32", "bf16", "bf16", "f32"):
        ms[f"fwd_{mode}"].append(time_ms(
            torch, fwd16 if mode == "bf16" else fwd32, 10))
        ms[f"bwd_{mode}"].append(time_ms(
            torch, bwd16 if mode == "bf16" else bwd32, 10))
    bwd_plain16 = lambda: gcnii_stack_bwd_plain(*bwd_args, res16, dh,
                                                mode="bf16", **opts)

    R = B * N
    # the f32 mode's operations (gcnii_train_case), of which the products
    # on bf16 operands, adj @ bf16(h1) and [bf16(hi) | h0] @ W (2 B N^2 H
    # + 4 R H^2 a layer, in the forward and in D's recompute), count at the
    # bf16 tensor-core rate and the rest at the f32 rate; bytes: each input
    # read once, each output written once, bf16 where the mode keeps bf16
    bf16_flops = nl * (2 * B * N * N * H + 4 * R * H * H)
    fwd_flops = nl * (16 * R * H * H + 20 * R * H)
    bwd_flops = nl * (4 * B * N * N * H + 56 * R * H * H + 40 * R * H)
    lstm_b = 4 * (8 * H * H + 4 * H)
    fwd_bytes = (2 * B * N * N + 4 * R * H + 2 * R * H + 2 * nl * 2 * H * H
                 + 4 * nl + lstm_b + 4 * R * H + 3 * 2 * nl * R * H)
    bwd_bytes = (2 * B * N * N + 2 * R * H + 2 * nl * 2 * H * H + 4 * nl
                 + lstm_b + 3 * 2 * nl * R * H + 4 * R * H
                 + 4 * B * N * N + 3 * 4 * R * H + 4 * nl * 2 * H * H
                 + lstm_b)
    shape = (f"B={B} N={N} H={H} layers={nl} reason=True rate={RATE} "
             f"bf16 mode")
    result = {
        "fwd": {"shape": f"{shape} residuals", **fwd,
                "tolerance": f"share <= {BF16_SHARE} past {BF16_RTOL} x "
                             f"max|h|, none past {BF16_CAP} x max|h|",
                "ms": min(ms["fwd_bf16"]), "ms_runs": ms["fwd_bf16"],
                "f32_mode_ms_runs": ms["fwd_f32"],
                "plain_ms": time_ms(torch, plain16, 2), "library_ms": None,
                **bound(fwd_bytes, fwd_flops, bf16_flops)},
        "bwd": {"shape": shape, "by_output": bwd,
                "max_abs_err": max(v["max_abs_err"] for v in bwd.values()),
                "relu_decisions_differing_from_plain": flips,
                "max_abs_pre_where_they_differ": flip_pre,
                "decision_tolerance": BF16_RTOL * scale,
                "tolerance": f"share <= {BF16_SHARE} past {BF16_RTOL} x "
                             "max|grad| (+ one bf16 step of the element "
                             f"for d_adj, d_h0, dW), none past {BF16_CAP} "
                             "x max|grad| (+ that step), at kernel D's "
                             "ReLU decisions",
                "ms": min(ms["bwd_bf16"]), "ms_runs": ms["bwd_bf16"],
                "f32_mode_ms_runs": ms["bwd_f32"],
                "plain_ms": time_ms(torch, bwd_plain16, 2),
                "library_ms": None,
                **bound(bwd_bytes, bwd_flops, bf16_flops)},
        "residual_bytes": {"bf16": sum(r.numel() * r.element_size()
                                       for r in res16),
                           "f32": sum(r.numel() * r.element_size()
                                      for r in res32)}}

    # serving one dialogue at bucket 64: the tiled design's bf16 mode
    from mmdfn_torch.graph.adjacency import mm_big_adjacency
    gs = torch.Generator().manual_seed(64)
    L = 64
    adj1 = mm_big_adjacency([torch.randn(1, L, 2 * H, generator=gs)
                             for _ in range(3)], torch.ones(1, L)).to(dev)
    h1 = torch.relu(torch.randn(1, 3 * L, H, generator=gs)).to(dev)
    sargs = (adj1, h1, h1, *args[3:])
    serve16 = lambda: gcnii_stack_fwd(*sargs, alpha=0.2, reason=True,
                                      mode="bf16")
    serve32 = lambda: gcnii_stack_fwd(*sargs, alpha=0.2, reason=True)
    s_want = gcnii_stack_plain(*sargs, alpha=0.2, reason=True, mode="bf16")
    s_agree = bf16_agree(torch, serve16(), s_want, "kernel B serving",
                         scale=max(1.0, float(s_want.abs().max())))
    design32 = next(k for k, v in DESIGNS.items()
                    if v == _design(1, 3 * L, _sm_count(dev)))
    result["serve"] = {
        "shape": f"B=1 N={3 * L} layers={nl} reason=True bf16 mode, tiled",
        **s_agree, "ms": time_ms(torch, serve16, 20),
        "f32_mode_ms": time_ms(torch, serve32, 20),
        "f32_mode_design": design32,
        "f32_tiled_ms": time_ms(torch, lambda: _forward(
            *sargs, alpha=0.2, reason=True, rate=0.0, seed=None,
            residuals=None, design=DESIGNS["tiled"]), 20)}

    # a config axis of 4 against 4 solo calls, bit for bit
    K = len(CONFIG_RATES)
    sets = [gcnii_train_inputs(torch, dev, TRAIN_B, TRAIN_L, seed=60 + k)[0]
            for k in range(K)]
    per = [torch.stack([s[i] for s in sets]) for i in (0, 1, 2, 3, 5, 6, 7)]
    rate = make_drop_rate(CONFIG_RATES, device=dev)
    res_k = residual_slabs((K, B, nl, N, H), "bf16", dev)
    kopts = dict(alpha=0.2, reason=True, mode="bf16")
    n0 = (gcnii_stack_fwd.launches, gcnii_stack_bwd.launches)
    out_k = _forward(*per[:4], theta, *per[4:], rate=rate, seed=seed,
                     residuals=res_k, **kopts)
    dh_k = torch.randn(K, B, N, H, generator=g).to(dev)
    got_k = gcnii_stack_bwd(per[0], per[2], per[3], theta, *per[4:], res_k,
                            dh_k, rate=rate, seed=seed, **kopts)
    check((gcnii_stack_fwd.launches - n0[0], gcnii_stack_bwd.launches
           - n0[1]) == (gcnii_fwd_launches(nl, True, DESIGNS["tiled"]),
                        gcnii_bwd_launches(nl, True)),
          "the config axis: one call of B and of D")
    for k, r in enumerate(CONFIG_RATES):
        a_k, s_k = sets[k], seed if r else None
        res_1 = residual_slabs((B, nl, N, H), "bf16", dev)
        want_k = _forward(*a_k, rate=r, seed=s_k, residuals=res_1, **kopts)
        check(torch.equal(out_k[k], want_k) and all(
            torch.equal(a[k], b) for a, b in zip(res_k, res_1)),
              f"bf16 config axis, kernel B: configuration {k}")
        grads_1 = gcnii_stack_bwd(a_k[0], a_k[2], a_k[3], theta, *a_k[5:],
                                  res_1, dh_k[k], rate=r, seed=s_k, **kopts)
        check(all(torch.equal(a[k], b) for a, b in zip(got_k, grads_1)),
              f"bf16 config axis, kernel D: configuration {k}")
    result["config_axis"] = {"K": K, "rates": list(CONFIG_RATES),
                             "bit_equal_to_solo_calls": True}
    return result


def fast_step_check(torch, dev, cfg, batch, grad_tol=None) -> dict:
    """One ``--tpu_fast`` training step with the kernels and one under
    ``ops.plain_ops()`` (the bf16 mode's plain versions, the plain
    backward from the bf16 carries) from the same weights and seed, the
    plain backward held at kernel D's ReLU decisions (read from its tdpre
    slab: in bf16 a decision moves with a bf16 step of hi, so near 0 the
    two recomputes decide apart more often than in f32), each decision
    that differs from the plain recompute on the step's own slabs within
    the forward's tolerance of 0 (:func:`kernel_d_decisions`, at
    ``BF16_RTOL`` of the stack's max |h|): the launches (A
    4, C 4, B 49, D 116), the loss to ``STEP_LOSS_RTOL`` relative, and
    every gradient within ``FAST_GRAD_RTOL`` of its max abs (the layer
    weights' beside one bf16 step of each element, as they are dW rounded
    to bf16): the stack rounds d_adj, d_h0 and dW to bf16, and where the
    kernel's and the plain version's f32 sums round to adjacent bf16
    numbers, the gradients upstream of them (the encoders', through the
    adjacency and h0) sum those steps into small differences (1.0e-4 of
    the scale at most on the card; the kernels alone are held tighter in
    :func:`fast_kernels`).  ``grad_tol`` replaces ``FAST_GRAD_RTOL`` (the
    rnn_bf16 phase's step, whose encoders run in bf16)."""
    import contextlib

    from mmdfn_torch import ops
    from mmdfn_torch.ops import gcnii as gcnii_ops

    def one(plain, masks=None):
        tr = trainer_for(cfg, dev)
        orig = gcnii_ops.gcnii_stack_bwd_plain
        if masks is not None:
            gcnii_ops.gcnii_stack_bwd_plain = lambda *a, **k: orig(
                *a, relu_masks=masks, **k)
        gcnii_ops.gcnii_stack_bwd.kept = None if plain else []
        try:
            with ops.plain_ops() if plain else contextlib.nullcontext():
                loss, _ = tr.train_step(batch, seed=1)
            torch.cuda.synchronize()
            decisions = None
            if not plain:    # the step's one stack call
                call = gcnii_ops.gcnii_stack_bwd.kept[-1]
                h_slab = call[0][7][0]
                tol = BF16_RTOL * max(1.0, float(h_slab.float().abs().max()))
                kmasks, _, flips, flip_pre = kernel_d_decisions(torch, tol,
                                                                call)
                decisions = (kmasks, flips, flip_pre, tol)
        finally:
            gcnii_ops.gcnii_stack_bwd_plain = orig
            gcnii_ops.gcnii_stack_bwd.kept = None
        grads = {n: p.grad for n, p in tr.model.named_parameters()}
        return float(loss), grads, decisions

    ops.reset_launch_counts()
    loss_k, grads_k, (masks, flips, flip_pre, tol) = one(False)
    counts = ops.launch_counts()
    check(counts == {"bigru_fwd": 4, "bigru_bwd": 4, "gcnii_fwd": 49,
                     "gcnii_bwd": 116}, f"the fast step's launches {counts}")
    loss_p, grads_p, _ = one(True, masks)
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    check(loss_err <= STEP_LOSS_RTOL,
          f"the fast step's loss {loss_k} vs plain {loss_p}")
    errs = {}
    for name, gp in grads_p.items():
        gk = grads_k[name]
        check(gk is not None and float(gk.abs().max()) > 0,
              f"no gradient reached {name}")
        s = float(gp.abs().max())
        d = (gk - gp).abs()
        # the layer weights' gradients are dW, rounded to bf16: one bf16
        # step of the element beside the bound
        step = 2.0 ** -7 * gp.abs() if ".convs." in name else 0.0
        errs[name] = [float((d - step).max()) / s,
                      float((d > BF16_RTOL * s + step).float().mean())]
    worst = sorted(errs.items(), key=lambda kv: -kv[1][0])
    tol_g = FAST_GRAD_RTOL if grad_tol is None else grad_tol
    check(worst[0][1][0] <= tol_g,
          f"the fast step's gradients vs plain: {worst[:5]}")
    return {"launches": counts, "loss_kernels": loss_k, "loss_plain": loss_p,
            "loss_rel_err": loss_err, "grad_max_rel_err": worst[0][1][0],
            "tolerance": tol_g,
            "held_at_kernel_d_decisions": True,
            "relu_decisions_differing_from_plain": flips,
            "max_abs_pre_where_they_differ": flip_pre,
            "decision_tolerance": tol,
            "grads_top_rel_err_and_share_past_1e-4": [
                [n, *e] for n, e in worst[:6]]}


CORE_DIGESTS = ROOT / "mmdfn_torch" / "tools" / "cuda_core_digests.json"


def cores_phase(torch, dev) -> dict:
    """Which core runs kernels B's and D's tiled products.  At the
    flagship's shapes in each mode and GF2's in the modes its stacks run
    (``tools/time_stack.py``'s operands), one forward and one backward
    under torch.profiler: the
    program's counter ``ops.gcnii_tc_products`` must equal the products of
    the two calls in the f32 mode (their launches but B's first and D's
    sums) and be 0 in the bf16 modes, and the profile must show the
    tensor-core kernel (``gemm_tc_kernel``) in the f32 mode only and the
    CUDA-core one (``gemm_kernel``) in the bf16 modes only.  Then the bf16
    modes' outputs at the flagship's shapes must carry the bits that the
    CUDA-core core gave before the tensor-core core was added
    (``CORE_DIGESTS``, recorded on the card from the commit before it),
    where this toolchain and card are the file's; elsewhere the digests
    are reported, not compared."""
    import inspect

    from torch.profiler import ProfilerActivity, profile

    from mmdfn_torch import ops
    from mmdfn_torch.ops import _build
    from mmdfn_torch.ops.gcnii import (TC_PRODUCTS, gcnii_bwd_launches,
                                       gcnii_fwd_launches)
    from mmdfn_torch.runtime import profiling
    from mmdfn_torch.tools import time_stack

    takes = inspect.signature(ops.gcnii_stack_fwd).parameters
    counts = {}
    # each mode at the flagship's shapes; GF2's (no LSTM) in the modes its
    # stacks run (f32, and the bf16 scan mode under --tpu_fast)
    for shape, modes in (("flagship", time_stack.MODES),
                         ("gf2", ("f32", "bf16_scan"))):
        _, _, nl, reason, _, _ = time_stack.SHAPES[shape]
        for mode in modes:
            fwd, bwd, _ = time_stack.calls(torch, dev, shape, mode, ops,
                                           takes)
            fwd()
            torch.cuda.synchronize()
            # the profile names the core; it may miss a short window's
            # first kernels (or all: then it is opened again), so it is not
            # held to every launch
            for _ in range(PROFILE_TRIES):
                profiling.reset()
                n0 = (ops.gcnii_stack_fwd.launches,
                      ops.gcnii_stack_bwd.launches)
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    fwd()
                    bwd()
                    torch.cuda.synchronize()
                kernels = [e.name for e in prof.events() if e.device_type
                           == torch.autograd.DeviceType.CUDA]
                if kernels:
                    break
            nf = ops.gcnii_stack_fwd.launches - n0[0]
            nb = ops.gcnii_stack_bwd.launches - n0[1]
            check(nf == gcnii_fwd_launches(nl, reason, mode=mode)
                  and nb == gcnii_bwd_launches(nl, reason, mode=mode),
                  f"{shape} {mode}: launches {nf}, {nb}")
            products = nf - 1 + nb - 1 - int(reason)
            counted = profiling.counters().get(TC_PRODUCTS, 0)
            tc = sum("gemm::gemm_tc_kernel" in k for k in kernels)
            cuda_core = sum("gemm::gemm_kernel" in k for k in kernels)
            f32 = mode == "f32"
            check(counted == (products if f32 else 0)
                  and (tc > 0) == f32 and (cuda_core > 0) != f32,
                  f"{shape} {mode}: {counted} counted of {products} "
                  f"products; the profile shows {tc} tensor-core and "
                  f"{cuda_core} CUDA-core products")
            counts[f"{shape} {mode}"] = {TC_PRODUCTS: counted,
                                         "products": products,
                                         "gemm_tc_kernel": tc,
                                         "gemm_kernel": cuda_core}
    got = time_stack.digests(torch, dev, "flagship", ("bf16", "bf16_scan"))
    chain = toolchain(torch, _build)
    here = {"torch": chain["torch"], "cuda": chain["cuda"],
            "nvcc": chain["nvcc"], "card": torch.cuda.get_device_name(0)}
    rec = json.loads(CORE_DIGESTS.read_text())
    compared = rec["toolchain"] == here
    if compared:
        check(got == rec["digests"], f"the bf16 modes' bits differ from the "
              f"CUDA-core core's ({rec['commit']}): {got}")
    return {"counts": counts, "bf16_digests": got,
            "bf16_digests_compared": compared, "toolchain": here}


def fast_phase(torch, dev) -> dict:
    """The JAX package's production configuration: the kernels in their
    bf16 mode (:func:`fast_kernels`); the flagship's training step built
    by ``run_train_erc``'s ``--tpu_fast`` on the train phase's batch
    recipe, against its plain step (:func:`fast_step_check`), timed beside
    the parity step in the same call (10 steps each: launches, wall, host
    enqueue, device busy, idle share, peak); and one served 37-utterance
    dialogue against the plain model.  The same step with
    ``variant=False`` stacks, which JAX runs as its bf16 layer scan, runs
    in the scan phase."""
    import dataclasses

    import numpy as np

    from mmdfn_torch.cli import run_train_erc
    from mmdfn_torch.data.datasets import IEMOCAPDataset
    from mmdfn_torch.data.synthetic import make_synthetic_iemocap_pickle
    from mmdfn_torch.weights import build_model

    kernels = fast_kernels(torch, dev)
    argv = ["--dataset", "IEMOCAP", "--graph_type", "GDF", "--reason_flag",
            "--class_weight", "--Deep_GCN_nlayers", str(NLAYERS),
            "--batch-size", str(TRAIN_B), "--speaker_weights", "3-0-1",
            "--dropout", str(RATE), "--seed", str(SEED)]
    parse = lambda a: run_train_erc.config_from_args(
        run_train_erc.build_parser().parse_args(a))
    parity, cfg = parse(argv), parse(argv + ["--tpu_fast"])
    check(cfg.gcn_backend == "pallas" and dataclasses.replace(
        cfg, **{k: getattr(parity, k) for k in cfg.TPU_FAST_KNOBS})
          == parity, "--tpu_fast sets the preset's knobs and no other")
    rng = np.random.default_rng(SEED)
    batches = [train_batch(torch, rng, dev) for _ in range(4)]
    checked = fast_step_check(torch, dev, cfg, batches[0])
    timed_parity = timed_steps(torch, dev, parity, batches)
    timed_fast = timed_steps(torch, dev, cfg, batches)
    with tempfile.TemporaryDirectory() as tmp:
        make_synthetic_iemocap_pickle(f"{tmp}/iem.pkl", n_train=1, n_test=1,
                                      min_len=30, max_len=40, seed=SEED)
        dialogue = IEMOCAPDataset(f"{tmp}/iem.pkl", train=False).dialogues()
    served = serve_check(torch, dev, cfg, build_model(cfg), dialogue)[2]
    keys = ("launches", "launches_per_step", "step_ms_median",
            "dialogues_per_sec", "host_enqueue_ms_per_step",
            "stream_ms_per_step", "device_busy_ms_per_step", "idle_share",
            "gcnii_fwd_kernels", "gcnii_bwd_kernels", "step_peak_mem_gb")
    return {"card": SMI, "kernels": kernels, "step_check": checked,
            "train_fast": {k: timed_fast.get(k) for k in keys},
            "train_parity_same_call": {k: timed_parity.get(k) for k in keys},
            "serve": served}


# the bf16 scan mode (JAX's bf16 layer scan) against its plain version
# (ops/gcnii.py: _scan_plain, and kernel D's walk in plain ops,
# _scan_bwd_plain): both round every op to bf16 at the same points and
# sum each product in f32, in another order; where that rounds a value to
# the neighbouring bf16 number, the two differ by one bf16 step of it (and
# a difference would travel on through adj and the layers).  Measured on
# an H100 (PERF.md §6): the forward, its slabs, d_adj, d_h and d_h0 equal
# bit for bit; dW and the LSTM weights' gradients (sums over every row, in
# another order) one step apart in at most 2.2e-4 of their elements, at
# most 0.42 steps of the scale (a step: 2^-8 of the output's max |.|).  So at most
# SCAN_SHARE of the elements may differ, none by more than SCAN_CAP_STEPS
# steps of the scale (one bf16 step of the largest element is two).
# Kernel D's ReLU decisions that differ from the plain recompute on the
# kernel's own slabs must lie within SCAN_DECISION_STEPS steps of max |h|
# of 0 (none differed).  The training step against its plain step (the
# plain backward held at kernel D's decisions): the loss to
# STEP_LOSS_RTOL relative (measured 2.9e-6 at most), every gradient within
# SCAN_GRAD_STEPS steps of its max |.| (measured 2.0: one bf16 step of an
# element near the max); the served log-probs within SERVE_TOL (4.4e-5).
SCAN_STEP = 2.0 ** -8
SCAN_SHARE, SCAN_CAP_STEPS, SCAN_DECISION_STEPS = 1e-3, 2.0, 1.0
SCAN_GRAD_STEPS = 6.0
# the kernel cases: (name, gcnii_train_inputs' wiring, layers, alpha,
# reason, variant, the last dropout in f32, rate)
SCAN_CASES = (
    ("GF2", "GF2", 64, 0.1, False, True, True, RATE),
    ("flagship", "GDF", NLAYERS, 0.2, True, True, False, RATE),
    ("DeepGCN", "DeepGCN", NLAYERS, 0.1, False, True, False, 0.0),
    ("MMGCN variant=False", "GDF", NLAYERS, 0.2, True, False, False, RATE),
)


def scan_agree(torch, got, want, what, scale=None) -> dict:
    """The bf16 scan mode's ``got`` against the plain version's ``want``
    (see ``SCAN_SHARE``): the share of the elements that differ, the max
    difference in bf16 steps of the scale, and every element of ``got``
    a bf16 value."""
    s = float(want.abs().max().clamp(min=1e-6)) if scale is None else scale
    got, want = got.float(), want.float()
    d = (got - want).abs()
    share = float((d > 0).float().mean())
    steps = float(d.max()) / (SCAN_STEP * s)
    check(share <= SCAN_SHARE and steps <= SCAN_CAP_STEPS,
          f"{what}, bf16 scan mode vs plain: {share} of the elements "
          f"differ, the most by {steps} bf16 steps of the scale {s}")
    return {"max_abs_err": float(d.max()), "max_err_bf16_steps": steps,
            "share_differing": share, "scale": s}


def on_bf16_grid(torch, *ts) -> bool:
    return all(torch.equal(t, t.to(torch.bfloat16).float()) for t in ts)


def scan_bounds(B, N, nl, reason, WI, slabs=True) -> tuple:
    """The bf16 scan mode's bounds, forward and backward, for B dialogues
    of N nodes, nl layers and layer weights of WI rows: every product on
    bf16 operands at the bf16 tensor-core rate (the gates' two, adj @ h1,
    the support product; D's recompute, its input-gradient, d_adj and
    weight-gradient products), the elementwise work at the f32 rate; each
    input read once, each output written once (the slabs in bf16, where
    ``slabs``: h, and with reason the LSTM's h and c; without it kernel B
    writes the h slab alone and kernel D reads it alone)."""
    R = B * N
    prod = nl * (16 * R * H * H * reason + 2 * B * N * N * H
                 + 2 * R * WI * H)
    bwd_prod = prod + nl * (4 * R * WI * H + 4 * B * N * N * H
                            + 32 * R * H * H * reason)
    ew, bwd_ew = nl * R * H * (42 if reason else 9), nl * R * H * (
        102 if reason else 24)
    lstm = 4 * (8 * H * H + 8 * H) * reason
    slab = (3 if reason else 1) * 2 * nl * R * H * slabs
    ins = 4 * B * N * N + 4 * nl * WI * H + 4 * nl + lstm
    fwd_bytes = ins + 2 * 4 * R * H + 4 * R * H + slab
    bwd_bytes = (ins + 4 * R * H + slab + 4 * R * H + 4 * B * N * N
                 + 2 * 4 * R * H + 4 * nl * WI * H + lstm)
    return (bound(fwd_bytes, ew, prod), bound(bwd_bytes, bwd_ew, bwd_prod))


def scan_kernel_case(torch, dev, name, wiring, nl, alpha, reason, variant,
                     last_f32, rate) -> dict:
    """Kernels B (training mode, the bf16 residual slabs) and D (on them)
    in the bf16 scan mode at the training batch (B = 32 dialogues of
    U[20, 80] turns) in a wiring, against the plain scan (D at its own
    ReLU decisions, each that differs from the plain recompute within
    ``SCAN_DECISION_STEPS`` of 0); every output a bf16 value (but GF2's
    f32 last dropout); the launches; the scan mode timed beside the f32
    mode and the bf16 mode (on the fold without the variant) in the same
    call (f32, bf16, scan, scan, bf16, f32); the plain versions' times;
    the bounds."""
    from mmdfn_torch.ops import (fold_weights, gcnii_stack_bwd,
                                 gcnii_stack_bwd_plain, gcnii_stack_fwd,
                                 gcnii_stack_plain)
    from mmdfn_torch.ops.gcnii import (SCAN, TILED, gcnii_bwd_launches,
                                       gcnii_fwd_launches, residual_slabs)

    args, g = gcnii_train_inputs(torch, dev, TRAIN_B, TRAIN_L, seed=70,
                                 nl=nl, wiring=wiring)
    adj, h, h0, W, theta, ih, hh, lb = args
    lb2 = (torch.stack([lb, (torch.rand(4 * H, generator=g) * 0.2
                             - 0.1).to(dev)]) if reason else None)
    if not variant:
        W = W[:, :H].contiguous()
    B, N, _ = h.shape
    WI = W.shape[1]
    seed = torch.tensor([SEED + 777], dtype=torch.int64, device=dev)
    opts = dict(alpha=alpha, reason=reason, rate=rate,
                seed=seed if rate else None)
    kw = dict(opts, mode=SCAN, variant=variant, last_drop_f32=last_f32)
    sargs = (adj, h, h0, W, theta, ih, hh, lb2)
    res, res_p = (residual_slabs((B, nl, N, H), SCAN, dev) for _ in "ab")
    fwd = lambda: gcnii_stack_fwd(*sargs, residuals=res, **kw)
    n0 = gcnii_stack_fwd.launches
    out = fwd()
    check(gcnii_stack_fwd.launches - n0 == gcnii_fwd_launches(
        nl, reason, TILED, SCAN), f"{name}: kernel B's scan-mode launches")
    torch.cuda.synchronize()
    with torch.no_grad():
        want = gcnii_stack_plain(*sargs, residuals=res_p, **kw)
    scale = max(1.0, float(want.abs().max()))
    check(last_f32 or on_bf16_grid(torch, out),
          f"{name}: kernel B's output is not on the bf16 grid")
    fwd_agree = scan_agree(torch, out, want, f"{name}: kernel B", scale)
    # (without reason the kernel writes no LSTM state)
    slab_agree = {n: scan_agree(torch, a, b, f"{name}: kernel B's slab {n}",
                                scale)
                  for n, a, b in zip(("h", "lh", "lc")[:3 if reason else 1],
                                     res, res_p)}

    dh = torch.randn(B, N, H, generator=g).to(dev)
    bargs = (adj, h0, W, theta, ih, hh, lb2)
    bwd = lambda: gcnii_stack_bwd(*bargs, res, dh, **kw)
    gcnii_stack_bwd.kept = []
    try:
        n0 = gcnii_stack_bwd.launches
        got = bwd()
        check(gcnii_stack_bwd.launches - n0 == gcnii_bwd_launches(
            nl, reason, SCAN), f"{name}: kernel D's scan-mode launches")
        torch.cuda.synchronize()
        _, ref, flips, flip_pre = kernel_d_decisions(
            torch, SCAN_DECISION_STEPS * SCAN_STEP * scale,
            gcnii_stack_bwd.kept[-1])
    finally:
        gcnii_stack_bwd.kept = None
    names = ("d_adj", "d_h", "d_h0", "dW", "dW_ih", "dW_hh", "db")[
        :7 if reason else 4]
    check(on_bf16_grid(torch, *got[:len(names)]),
          f"{name}: kernel D's outputs are not on the bf16 grid")
    bwd_agree = {n: scan_agree(torch, a, b, f"{name}: kernel D's {n}")
                 for n, a, b in zip(names, got, ref)}

    # the f32 and bf16 modes on the same operands (the fold without the
    # variant; one bias, b_ih + b_hh)
    Wv = W if variant else fold_weights(W, alpha)
    lbc = lb2[0] + lb2[1] if reason else None
    fargs = (adj, h, h0, Wv, theta, ih, hh, lbc)
    r32 = residual_slabs((B, nl, N, H), "f32", dev)
    r16 = residual_slabs((B, nl, N, H), "bf16", dev)
    runs = {"f32": (lambda: gcnii_stack_fwd(*fargs, residuals=r32, **opts),
                    lambda: gcnii_stack_bwd(adj, h0, Wv, theta, ih, hh, lbc,
                                            r32, dh, **opts)),
            "bf16": (lambda: gcnii_stack_fwd(*fargs, residuals=r16,
                                             mode="bf16", **opts),
                     lambda: gcnii_stack_bwd(adj, h0, Wv, theta, ih, hh, lbc,
                                             r16, dh, mode="bf16", **opts)),
            "scan": (fwd, bwd)}
    for f, _ in runs.values():
        f()
    ms = {f"{d}_{m}": [] for m in runs for d in ("fwd", "bwd")}
    for m in ("f32", "bf16", "scan", "scan", "bf16", "f32"):
        f, b = runs[m]
        ms[f"fwd_{m}"].append(time_ms(torch, f, 10))
        ms[f"bwd_{m}"].append(time_ms(torch, b, 10))
    with torch.no_grad():
        plain_fwd_ms = time_ms(torch, lambda: gcnii_stack_plain(*sargs, **kw),
                               2)
        plain_bwd_ms = time_ms(torch, lambda: gcnii_stack_bwd_plain(
            *bargs, res, dh, **kw), 2)

    fwd_bound, bwd_bound = scan_bounds(B, N, nl, reason, WI)
    shape = (f"{name}: B={B} N={N} H={H} layers={nl} reason={reason} "
             f"variant={variant} rate={rate} last dropout "
             f"{'f32' if last_f32 else 'bf16'}, bf16 scan mode")
    tol = (f"at most {SCAN_SHARE} of the elements differ, none by more "
           f"than {SCAN_CAP_STEPS} bf16 steps of the scale")
    return {
        "fwd": {"shape": shape, **fwd_agree, "slabs": slab_agree,
                "tolerance": tol, "ms": min(ms["fwd_scan"]),
                "ms_runs": ms["fwd_scan"], "f32_mode_ms_runs": ms["fwd_f32"],
                "bf16_mode_ms_runs": ms["fwd_bf16"], "plain_ms": plain_fwd_ms,
                "library_ms": None, **fwd_bound},
        "bwd": {"shape": shape, "by_output": bwd_agree,
                "max_abs_err": max(v["max_abs_err"]
                                   for v in bwd_agree.values()),
                "relu_decisions_differing_from_plain": flips,
                "max_abs_pre_where_they_differ": flip_pre,
                "decision_tolerance": SCAN_DECISION_STEPS * SCAN_STEP * scale,
                "tolerance": f"{tol}, at kernel D's ReLU decisions",
                "ms": min(ms["bwd_scan"]), "ms_runs": ms["bwd_scan"],
                "f32_mode_ms_runs": ms["bwd_f32"],
                "bf16_mode_ms_runs": ms["bwd_bf16"], "plain_ms": plain_bwd_ms,
                "library_ms": None, **bwd_bound}}


def scan_serve_case(torch, dev) -> dict:
    """Kernel B serving one dialogue at bucket 64 (N = 192, the
    flagship's 16 layers and reason-LSTM, rate 0) in the bf16 scan mode
    (the tiled design, 1 + 4 x 16 launches) against the plain scan, timed
    beside its plain version, the f32 mode (its own design) and the bf16
    mode (tiled); its bound (:func:`scan_bounds`, no slabs)."""
    from mmdfn_torch.graph.adjacency import mm_big_adjacency
    from mmdfn_torch.ops import gcnii_stack_fwd, gcnii_stack_plain
    from mmdfn_torch.ops.bigru import _sm_count
    from mmdfn_torch.ops.gcnii import (DESIGNS, SCAN, TILED, _design,
                                       gcnii_fwd_launches)

    args, g = gcnii_train_inputs(torch, dev, 1, 64, seed=64, lo=64)
    adj, h, h0, W, theta, ih, hh, lb = args
    lb2 = torch.stack([lb, lb.flip(0)])
    kw = dict(alpha=0.2, reason=True)
    scan = lambda: gcnii_stack_fwd(adj, h, h0, W, theta, ih, hh, lb2,
                                   mode=SCAN, **kw)
    n0 = gcnii_stack_fwd.launches
    out = scan()
    check(gcnii_stack_fwd.launches - n0 == gcnii_fwd_launches(
        NLAYERS, True, TILED, SCAN), "kernel B serving: its launches")
    want = gcnii_stack_plain(adj, h, h0, W, theta, ih, hh, lb2, mode=SCAN,
                             **kw)
    check(on_bf16_grid(torch, out), "kernel B serving: not on the bf16 grid")
    N = h.shape[1]
    design32 = next(k for k, v in DESIGNS.items()
                    if v == _design(1, N, _sm_count(dev)))
    return {"shape": f"B=1 N={N} layers={NLAYERS} reason=True "
                     "bf16 scan mode, tiled",
            **scan_agree(torch, out, want, "kernel B serving"),
            "launches": gcnii_fwd_launches(NLAYERS, True, TILED, SCAN),
            "ms": time_ms(torch, scan, 20),
            "plain_ms": time_ms(torch, lambda: gcnii_stack_plain(
                adj, h, h0, W, theta, ih, hh, lb2, mode=SCAN, **kw), 2),
            **scan_bounds(1, N, NLAYERS, True, 2 * H, slabs=False)[0],
            "f32_mode_ms": time_ms(torch, lambda: gcnii_stack_fwd(
                *args, **kw), 20),
            "f32_mode_design": design32,
            "bf16_mode_ms": time_ms(torch, lambda: gcnii_stack_fwd(
                *args, mode="bf16", **kw), 20)}


def scan_step_check(torch, dev, cfg, batch, build=None) -> dict:
    """One training step of a model whose stacks run the bf16 scan mode,
    with the kernels and under ``ops.plain_ops()`` from the same weights
    and seed, the plain step's backward held at kernel D's ReLU decisions
    of each stack call (read from its tdpre slabs; the plain forward keeps
    its own ReLU), each decision that differs from the plain recompute on
    the kernel's slabs within ``SCAN_DECISION_STEPS`` bf16 steps of max
    |h| of 0: the launches (kernels A and C per bi-GRU, B and D per stack
    call in the scan mode), the loss to ``STEP_LOSS_RTOL`` relative and
    every gradient within ``SCAN_GRAD_STEPS`` bf16 steps of its max
    |.|."""
    import contextlib

    from mmdfn_torch import ops
    from mmdfn_torch.ops import gcnii as gcnii_ops
    from mmdfn_torch.ops.gcnii import (SCAN, TILED, gcnii_bwd_launches,
                                       gcnii_fwd_launches)

    def one(plain, masks=None):
        tr = trainer_for(cfg, dev, build)
        check(stack_mode(tr.model) == SCAN, "the stacks run the scan mode")
        orig = gcnii_ops.gcnii_stack_plain
        if masks is not None:     # one list of layer masks a stack call
            held = iter(masks)
            gcnii_ops.gcnii_stack_plain = lambda *a, **k: orig(
                *a, relu_masks=next(held), **k)
        gcnii_ops.gcnii_stack_bwd.kept = []
        try:
            with ops.plain_ops() if plain else contextlib.nullcontext():
                loss, _ = tr.train_step(batch, seed=1)
            torch.cuda.synchronize()
            # the stack calls in forward order
            kept = gcnii_ops.gcnii_stack_bwd.kept[::-1]
        finally:
            gcnii_ops.gcnii_stack_plain = orig
            gcnii_ops.gcnii_stack_bwd.kept = None
        grads = {n: p.grad for n, p in tr.model.named_parameters()}
        return float(loss), grads, kept, tr.model

    ops.reset_launch_counts()
    loss_k, grads_k, kept, model = one(False)
    counts = ops.launch_counts()
    calls = stack_calls(cfg, batch["umask"].shape[1])
    grus = gru_encoders(model)
    want = {"bigru_fwd": 2 * grus, "bigru_bwd": 2 * grus,
            "gcnii_fwd": sum(gcnii_fwd_launches(nl, r, TILED, SCAN)
                             for nl, r, _ in calls),
            "gcnii_bwd": sum(gcnii_bwd_launches(nl, r, SCAN)
                             for nl, r, _ in calls)}
    check(counts == want and len(kept) == len(calls),
          f"the scan step's launches {counts} != {want}")
    masks, flips, flip_pre, tols = [], 0, 0.0, []
    for call in kept:
        h_slab = call[0][7][0]
        tol = SCAN_DECISION_STEPS * SCAN_STEP * max(
            1.0, float(h_slab.float().abs().max()))
        m, _, f, fp = kernel_d_decisions(torch, tol, call)
        masks.append(m)
        flips, flip_pre = flips + f, max(flip_pre, fp)
        tols.append(tol)
    del kept
    loss_p, grads_p, _, _ = one(True, masks)
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    check(loss_err <= STEP_LOSS_RTOL,
          f"the scan step's loss {loss_k} vs plain {loss_p}")
    errs = {}
    for n, gp in grads_p.items():
        gk = grads_k[n]
        check(gk is not None and float(gk.abs().max()) > 0,
              f"no gradient reached {n}")
        s = float(gp.abs().max())
        d = (gk - gp).abs()
        errs[n] = [float(d.max()) / (SCAN_STEP * s),
                   float((d > 0).float().mean())]
    worst = sorted(errs.items(), key=lambda kv: -kv[1][0])
    check(worst[0][1][0] <= SCAN_GRAD_STEPS,
          f"the scan step's gradients vs plain: {worst[:5]}")
    return {"launches": counts, "loss_kernels": loss_k, "loss_plain": loss_p,
            "loss_rel_err": loss_err,
            "grad_max_err_bf16_steps": worst[0][1][0],
            "tolerance": f"loss {STEP_LOSS_RTOL} relative, gradients "
                         f"{SCAN_GRAD_STEPS} bf16 steps of their max |.|",
            "held_at_kernel_d_decisions": True,
            "relu_decisions_differing_from_plain": flips,
            "max_abs_pre_where_they_differ": flip_pre,
            "decision_tolerance": min(tols),
            "grads_top_err_bf16_steps_and_share_differing": [
                [n, *e] for n, e in worst[:6]]}


def scan_phase(torch, dev) -> dict:
    """JAX's bf16 layer scan (``gcn_compute_dtype='bfloat16'`` where no
    fused kernel runs): kernels B and D in their bf16 scan mode at GF2's,
    the flagship's, DeepGCN's and the non-variant MMGCN's shapes
    (:func:`scan_kernel_case`); the GF2 and DeepGCN training steps built
    by ``run_train_erc``'s ``--tpu_fast`` and the flagship's with
    ``variant=False`` stacks on the train phase's batch recipe, each
    against its plain step (:func:`scan_step_check`) and timed (10 steps:
    launches, wall, host enqueue, device busy, idle share, peak); one
    served 37-utterance dialogue of GF2 and of DeepGCN against the plain
    model."""
    import numpy as np

    from mmdfn_torch.cli import run_train_erc
    from mmdfn_torch.data.datasets import IEMOCAPDataset
    from mmdfn_torch.data.synthetic import make_synthetic_iemocap_pickle
    from mmdfn_torch.weights import build_model

    kernels = {c[0]: scan_kernel_case(torch, dev, *c) for c in SCAN_CASES}
    kernels["serve"] = scan_serve_case(torch, dev)
    print(json.dumps({"scan_kernels": kernels}), flush=True)
    base = ["--dataset", "IEMOCAP", "--class_weight", "--batch-size",
            str(TRAIN_B), "--speaker_weights", "3-0-1", "--dropout",
            str(RATE), "--seed", str(SEED), "--tpu_fast"]
    parse = lambda a: run_train_erc.config_from_args(
        run_train_erc.build_parser().parse_args(base + a))
    models = {
        "GF2": (parse(["--graph_type", "GF2"]), None),
        "DeepGCN": (parse(["--graph_type", "DeepGCN", "--Deep_GCN_nlayers",
                           str(NLAYERS)]), None),
        "MMGCN variant=False": (parse(
            ["--graph_type", "GDF", "--reason_flag", "--Deep_GCN_nlayers",
             str(NLAYERS)]), nonvariant_build("MMGCN"))}
    rng = np.random.default_rng(SEED)
    batches = [train_batch(torch, rng, dev) for _ in range(4)]
    with tempfile.TemporaryDirectory() as tmp:
        make_synthetic_iemocap_pickle(f"{tmp}/iem.pkl", n_train=1, n_test=1,
                                      min_len=SINGLE_SERVE_LEN,
                                      max_len=SINGLE_SERVE_LEN, seed=SEED)
        dialogue = IEMOCAPDataset(f"{tmp}/iem.pkl", train=False).dialogues()
    keys = ("launches", "launches_per_step", "step_ms_median",
            "dialogues_per_sec", "host_enqueue_ms_per_step",
            "stream_ms_per_step", "device_busy_ms_per_step", "idle_share",
            "gcnii_fwd_kernels", "gcnii_bwd_kernels", "step_peak_mem_gb")
    steps = {}
    for name, (cfg, build) in models.items():
        checked = scan_step_check(torch, dev, cfg, batches[0], build)
        timed = timed_steps(torch, dev, cfg, batches, build=build)
        steps[name] = {"step_check": checked,
                       "train": {k: timed.get(k) for k in keys}}
        if build is None:
            steps[name]["serve"] = serve_check(
                torch, dev, cfg, build_model(cfg), dialogue)[2]
        print(json.dumps({"scan_model": {name: steps[name]}}), flush=True)
    return {"card": SMI, "kernels": kernels, "models": steps}


# the encoders' bf16 recurrence (rnn_compute_dtype='bfloat16'): kernels A
# and C's bf16 scan mode (JAX's bf16 _gru_scan) against their plain
# versions (ops/bigru.py: _scan_plain, and kernel C's walk in plain ops,
# _scan_bwd_plain): both round every op to bf16 at the same points and sum
# each product in f32, in another order; where that rounds a value to the
# neighbouring bf16 number, the two differ by one bf16 step of it, and the
# recurrence carries the difference on to later steps.  ys, hg and dxg are
# held by scan_agree (at most SCAN_SHARE of the elements differ, none by
# more than SCAN_CAP_STEPS bf16 steps of the scale); dW_hh and db_hh
# (per-step sums over the rows, then a bf16 sum over the steps) within
# RNN_W_STEPS bf16 steps of their max |.|.  The two flagship steps against
# their plain steps: the loss to STEP_LOSS_RTOL relative, every gradient
# within SCAN_GRAD_STEPS bf16 steps of its max |.|.
RNN_W_STEPS = 2.0
# The served log-probs with bf16 encoders against the plain model: where
# the kernel's and the plain version's f32 sums round an encoder output to
# neighbouring bf16 values (2^-8 of it apart), the log-probs downstream
# move with it, past SERVE_TOL: measured 1.9e-4 under --tpu_fast (the f32
# kernels' outputs rounded) and 4.8e-7 with the scan mode, on an H100
RNN_SERVE_TOL = 1e-3


def bf16_gru_inputs(torch, dev, B, L, seed=1, K=None):
    """:func:`bigru_inputs` rounded to bf16 (the bf16 scan mode's
    operands); with K, K configurations stacked on a leading axis (the
    mask shared)."""
    if K is None:
        return tuple(t.to(torch.bfloat16) if i < 6 else t for i, t in
                     enumerate(bigru_inputs(torch, dev, B, L, seed=seed)))
    solo = [bigru_inputs(torch, dev, B, L, seed=seed + k) for k in range(K)]
    return tuple(torch.stack([s[i] for s in solo]).to(torch.bfloat16)
                 for i in range(6)) + (solo[0][6],)


def rnn_bounds(B, L):
    """The bf16 scan mode's bounds, forward and backward, for B rows of L
    steps and both directions: each input read once and each output
    written once in bf16 (the mask in f32; the saved hg is an input of the
    backward, as its residual), the products on bf16 operands at the bf16
    tensor-core rate (h @ W_hh a step; the backward's dhg @ W_hh^T and its
    weight-gradient product), the gate math and its roundings at the f32
    rate (~30 H operations a row and step forward, ~60 backward)."""
    G = 3 * H
    rows = 2 * B * L
    fwd_bytes = 2 * (rows * G + 2 * (H * G + G) + rows * H) + 4 * B * L
    bwd_bytes = (2 * (2 * rows * G + 2 * rows * H + 2 * (H * G + G))
                 + 4 * B * L + 2 * (rows * G + 2 * (H * G + G)))
    return (bound(fwd_bytes, rows * 30 * H, rows * 2 * H * G),
            bound(bwd_bytes, rows * 60 * H, rows * 2 * (2 * H + 1) * G))


def rnn_kernel_case(torch, dev, B, L, train=False) -> dict:
    """Kernel A's bf16 scan mode at (B, L) (holed masks where B > 1)
    against the plain scan, timed beside the f32 mode on the same values,
    the plain scan and cuDNN's GRU on bf16 tensors (a speed yardstick
    only: its rounding points differ); with ``train`` also A's training
    mode (its hg) and kernel C's scan mode on what it wrote, against the
    plain walk on the same ys and hg, twice (the same bits), timed beside
    the f32 mode's C, the plain walk and cuDNN's backward alone."""
    from mmdfn_torch.ops import bigru_layer_bwd, bigru_layer_fwd
    from mmdfn_torch.ops.bigru import _forward, _scan_bwd_plain, _scan_plain

    scan = "bf16_scan"
    t_case = time.perf_counter()
    args = bf16_gru_inputs(torch, dev, B, L)
    f32 = tuple(t.float() for t in args)
    got = bigru_layer_fwd(*args, mode=scan)
    torch.cuda.synchronize()
    want = _scan_plain(*args, with_hg=True)
    out = {"shape": f"B={B} L={L} H={H}",
           "ys": [scan_agree(torch, a, b, f"kernel A ys at B={B} L={L}")
                  for a, b in zip(got, want)]}
    ms = time_ms(torch, lambda: bigru_layer_fwd(*args, mode=scan), 50)
    f32_ms = time_ms(torch, lambda: bigru_layer_fwd(*f32), 50)
    plain_ms = wall_ms(torch, lambda: _scan_plain(*args))
    gru = cudnn_gru(torch, dev, f32).to(torch.bfloat16)
    gru.flatten_parameters()
    with torch.no_grad():
        library_ms = device_ms(torch, lambda: gru(args[0]), 20)
    fb, bb = rnn_bounds(B, L)
    out["fwd"] = {"ms": ms, "f32_ms_same_call": f32_ms, "plain_ms": plain_ms,
                  "library_ms": library_ms, **fb,
                  "max_abs_err": max(c["max_abs_err"] for c in out["ys"])}
    out["case_s"] = time.perf_counter() - t_case
    if not train:
        return out
    ys_f, ys_b, hg_f, hg_b = _forward(*args, with_hg=True, mode=scan)
    torch.cuda.synchronize()
    check(torch.equal(ys_f, got[0]) and torch.equal(ys_b, got[1]),
          f"kernel A's training mode changed ys at B={B}")
    out["hg"] = [scan_agree(torch, a, b, f"kernel A hg at B={B}")
                 for a, b in zip((hg_f, hg_b), want[2:])]
    g = torch.Generator().manual_seed(3)
    dy = [torch.randn(B, L, H, generator=g).to(dev).to(torch.bfloat16)
          for _ in range(2)]
    run = lambda: bigru_layer_bwd(*args, ys_f, ys_b, *dy, hg_f, hg_b,
                                  mode=scan)
    kg = [t.clone() for t in run()]
    again = run()
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(kg, again)),
          f"kernel C's scan mode differs between launches at B={B}")
    t0 = time.perf_counter()
    pg = _scan_bwd_plain(*args, ys_f, ys_b, *dy, hg_f, hg_b)
    torch.cuda.synchronize()
    c_plain_ms = (time.perf_counter() - t0) * 1e3
    names = ("dxg_f", "dxg_b", "dW_hh_f", "db_hh_f", "dW_hh_b", "db_hh_b")
    bwd = {}
    for name, a, b in zip(names, kg, pg):
        if name.startswith("dxg"):
            bwd[name] = scan_agree(torch, a, b, f"kernel C {name} at B={B}")
            continue
        d = (a.float() - b.float()).abs()
        steps = float(d.max()) / (SCAN_STEP * float(b.float().abs().max()))
        check(steps <= RNN_W_STEPS, f"kernel C {name} at B={B}: {steps} "
                                    "bf16 steps of its max")
        bwd[name] = {"max_abs_err": float(d.max()),
                     "max_err_bf16_steps": steps,
                     "share_differing": float((d > 0).float().mean())}
    c_ms = time_ms(torch, run, 20)
    f = _forward(*f32, with_hg=True)
    dyf = [t.float() for t in dy]
    c_f32_ms = time_ms(torch, lambda: bigru_layer_bwd(
        *f32, f[0], f[1], *dyf, f[2], f[3]), 20)
    x = args[0].clone().requires_grad_()
    o, _ = gru(x)
    wrt = [x, gru.weight_hh_l0, gru.bias_hh_l0, gru.weight_hh_l0_reverse,
           gru.bias_hh_l0_reverse]
    dout = torch.cat(dy, dim=-1)
    c_library_ms = device_ms(torch, lambda: torch.autograd.grad(
        o, wrt, dout, retain_graph=True), 20)
    out["train_ms"] = time_ms(
        torch, lambda: _forward(*args, with_hg=True, mode=scan), 50)
    out["bwd"] = {"ms": c_ms, "f32_ms_same_call": c_f32_ms,
                  "plain_ms": c_plain_ms, "library_ms": c_library_ms, **bb,
                  "max_abs_err": max(v["max_abs_err"] for v in bwd.values()),
                  "checks": bwd}
    out["case_s"] = time.perf_counter() - t_case
    return out


def rnn_config_axis(torch, dev, K=4, B=TRAIN_B, L=TRAIN_L) -> dict:
    """Kernels A (training mode) and C in the bf16 scan mode with a config
    axis of K: one launch each against K solo launches, bit for bit."""
    from mmdfn_torch.ops import bigru_layer_bwd
    from mmdfn_torch.ops.bigru import _forward

    scan = "bf16_scan"
    args = bf16_gru_inputs(torch, dev, B, L, seed=7, K=K)
    g = torch.Generator().manual_seed(5)
    dy = [torch.randn(K, B, L, H, generator=g).to(dev).to(torch.bfloat16)
          for _ in range(2)]
    ys = _forward(*args, with_hg=True, mode=scan)
    grads = bigru_layer_bwd(*args, ys[0], ys[1], *dy, ys[2], ys[3],
                            mode=scan)
    for k in range(K):
        solo_args = tuple(t[k] for t in args[:6]) + (args[6],)
        solo = _forward(*solo_args, with_hg=True, mode=scan)
        check(all(torch.equal(a[k], b) for a, b in zip(ys, solo)),
              f"kernel A's scan mode, configuration {k} of {K}")
        solo_g = bigru_layer_bwd(*solo_args, solo[0], solo[1], dy[0][k],
                                 dy[1][k], solo[2], solo[3], mode=scan)
        check(all(torch.equal(a[k], b) for a, b in zip(grads, solo_g)),
              f"kernel C's scan mode, configuration {k} of {K}")
    return {"K": K, "shape": f"B={B} L={L}", "bit_equal_to_solo_calls": True}


def rnn_bf16_phase(torch, dev) -> dict:
    """The encoders' bf16 recurrence (``rnn_compute_dtype='bfloat16'``):
    kernels A and C in their bf16 scan mode at the serve shapes (A, B = 6,
    L = 64 and 200) and the training step's (``lstm_l``'s B = 32 and
    ``rnn_parties``' B = 192, L = 80) against their plain versions
    (:func:`rnn_kernel_case`), a config axis of 4 (:func:`rnn_config_axis`);
    then the flagship step built by ``run_train_erc`` with
    ``--rnn_compute_dtype bfloat16`` (a: the encoders in the scan mode, the
    stack in f32) and with ``--tpu_fast`` too (b: the encoders in the bf16
    mode, the f32 kernels on bf16 operands; the stack in B and D's bf16
    mode), each against its plain step (a: held at kernel D's ReLU
    decisions where the gradients disagree; b: as the fast phase's), both
    launching exactly A 4, C 4, B 49, D 116, 10 timed steps each (the
    train phase's are the parity step's, in the same call), and one served
    37-utterance dialogue each against the plain model."""
    import numpy as np

    from mmdfn_torch.cli import run_train_erc
    from mmdfn_torch.data.datasets import IEMOCAPDataset
    from mmdfn_torch.data.synthetic import make_synthetic_iemocap_pickle
    from mmdfn_torch.nn.rnn import BiRNN
    from mmdfn_torch.weights import build_model

    seconds = {}
    t0 = time.perf_counter()
    kernels = {f"B={B} L={L}": rnn_kernel_case(torch, dev, B, L)
               for B, L in ((6, 64), (6, 200))}
    for B in (TRAIN_B, 6 * TRAIN_B):
        kernels[f"B={B} L={TRAIN_L}"] = rnn_kernel_case(torch, dev, B,
                                                        TRAIN_L, train=True)
    kernels["config_axis"] = rnn_config_axis(torch, dev)
    print(json.dumps({"rnn_bf16_kernels": kernels}), flush=True)
    seconds["kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    argv = ["--dataset", "IEMOCAP", "--graph_type", "GDF", "--reason_flag",
            "--class_weight", "--Deep_GCN_nlayers", str(NLAYERS),
            "--batch-size", str(TRAIN_B), "--speaker_weights", "3-0-1",
            "--dropout", str(RATE), "--seed", str(SEED)]
    parse = lambda a: run_train_erc.config_from_args(
        run_train_erc.build_parser().parse_args(argv + a))
    knob = ["--rnn_compute_dtype", "bfloat16"]
    cfgs = {"a_knob_alone": parse(knob),
            "b_knob_tpu_fast": parse(knob + ["--tpu_fast"])}
    for name, mode in (("a_knob_alone", "bf16_scan"),
                       ("b_knob_tpu_fast", "bf16")):
        modes = {m.mode for m in build_model(cfgs[name]).modules()
                 if isinstance(m, BiRNN)}
        check(modes == {mode}, f"{name}: the encoders run {modes}")
    rng = np.random.default_rng(SEED)
    batches = [train_batch(torch, rng, dev) for _ in range(4)]
    grad_tol = SCAN_GRAD_STEPS * SCAN_STEP
    want = {"bigru_fwd": 4, "bigru_bwd": 4, "gcnii_fwd": 49,
            "gcnii_bwd": 116}
    checked = {"a_knob_alone": step_check(
        torch, dev, cfgs["a_knob_alone"], batches[0], hold_decisions=True,
        grad_rtol=grad_tol)}
    check(checked["a_knob_alone"]["launches"] == want,
          f"step a's launches {checked['a_knob_alone']['launches']}")
    checked["b_knob_tpu_fast"] = fast_step_check(
        torch, dev, cfgs["b_knob_tpu_fast"], batches[0], grad_tol=grad_tol)
    print(json.dumps({"rnn_bf16_step_check": checked}), flush=True)
    seconds["step_checks"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    keys = ("launches", "launches_per_step", "step_ms_median",
            "dialogues_per_sec", "host_enqueue_ms_per_step",
            "stream_ms_per_step", "device_busy_ms_per_step", "idle_share",
            "bigru_kernels", "step_peak_mem_gb")
    timed = {}
    for name, cfg in cfgs.items():
        t = timed_steps(torch, dev, cfg, batches)
        check(t["launches_per_step"] == want, f"{name}: launches a step "
                                              f"{t['launches_per_step']}")
        timed[name] = {k: t.get(k) for k in keys}
    print(json.dumps({"rnn_bf16_train": timed}), flush=True)
    seconds["timed_steps"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        make_synthetic_iemocap_pickle(f"{tmp}/iem.pkl", n_train=1, n_test=1,
                                      min_len=SINGLE_SERVE_LEN,
                                      max_len=SINGLE_SERVE_LEN, seed=SEED)
        dialogue = IEMOCAPDataset(f"{tmp}/iem.pkl", train=False).dialogues()
    served = {name: serve_check(torch, dev, cfgs[name],
                                build_model(cfgs[name]), dialogue,
                                tol=RNN_SERVE_TOL)[2]
              for name in ("a_knob_alone", "b_knob_tpu_fast")}
    seconds["serve"] = time.perf_counter() - t0
    return {"card": SMI, "kernels": kernels, "step_check": checked,
            "train": timed, "serve": served, "seconds": seconds}


# the parallel phase: 2 ranks share the card over gloo; a small pickle for
# the command lines (one epoch of 2 training batches of B = 32)
PARALLEL_RANKS = 2
PARALLEL_DATA = dict(n_train=64, n_test=32, min_len=20, max_len=TRAIN_L,
                     seed=SEED + 1)
PARALLEL_STEP = {"bigru_fwd": 4, "bigru_bwd": 4, "gcnii_fwd": 49,
                 "gcnii_bwd": 116}


def host_batch(batch: dict):
    """A batch on the card as the host ``Batch`` a rank shards."""
    from mmdfn_torch.data.batching import Batch

    return Batch(**{k: v.cpu().numpy() for k, v in batch.items()})


def rank_grads(torch, dev, r: dict) -> dict:
    return {n: torch.from_numpy(g).to(dev) for n, g in r["grads"].items()}


def epoch_lines(out: str) -> list:
    """The CLI's per-epoch and final lines, the epoch's seconds cut off."""
    return [line.split(", time:")[0] for line in out.splitlines()
            if line.startswith(("epoch:", "Eval-metric"))]


def parallel_phase(torch, dev) -> dict:
    """The multi-device layer on the one card (``runtime/mesh.py``,
    ``runtime/launch.py``, ``parallel/graph_parallel.py``): 2 ranks share
    it over gloo, so their walls measure sharing, not scaling.  (a) the
    flagship at the train phase's settings and widths, dropout 0, on 2 data
    ranks of B = 16 (the global B = 32): 2 steps each through kernels A-D
    (exactly A 4, C 4, B 49, D 116 a step), held against the one-process
    step on the same global batches; (b) the same at dropout 0.4: finite
    losses, and on the same dialogues (a batch whose halves are equal) the
    data ranks' training forwards differ, each through its own dropout
    masks, kernel B's among them; (c) 2 model ranks, the GCNII stack
    node-sharded (its plain version with the sharded product, kernels A and
    C alone), one step at dropout 0 against the one-process plain step; (d)
    one epoch of the training CLI with ``--n_data_devices 1`` (NCCL, one
    rank) against the same command without it, line for line; (e) the
    first IEMOCAP group cut to K = 4, one epoch of ``cli.sweep --vmap`` on
    2 ranks of the card (``--device cuda:0 --n_data_devices 2``) against
    the one-process group, config by config, bit for bit."""
    import contextlib
    import dataclasses
    import io

    import numpy as np

    from mmdfn_torch import ops
    from mmdfn_torch.cli import run_train_erc, sweep
    from mmdfn_torch.config import ExperimentConfig
    from mmdfn_torch.data.synthetic import make_synthetic_iemocap_pickle
    from mmdfn_torch.ops import gcnii as gcnii_ops
    from mmdfn_torch.parallel import workers
    from mmdfn_torch.runtime import checkpoint as ckpt_lib
    from mmdfn_torch.runtime import launch
    from mmdfn_torch.train import Trainer

    kw = dict(dataset="IEMOCAP", graph_type="GDF", reason_flag=True,
              class_weight=True, Deep_GCN_nlayers=NLAYERS,
              batch_size=TRAIN_B, speaker_weights="3-0-1", seed=SEED)
    cfg0 = ExperimentConfig(**kw, dropout=0.0)
    cfg4 = ExperimentConfig(**kw, dropout=RATE)
    rng = np.random.default_rng(SEED + 7)
    batches = [train_batch(torch, rng, dev) for _ in range(2)]
    hosts = [host_batch(b) for b in batches]
    seeds = [1, 2]
    # both data ranks' blocks hold the first half of the first batch
    half = TRAIN_B // 2
    same = dataclasses.replace(hosts[0], **{
        k: np.concatenate([getattr(hosts[0], k)[:half]] * 2)
        for k in ("text", "audio", "visual", "qmask", "umask", "label")})

    # the one-process steps: kernels (a), plain (c)
    tr = Trainer(cfg0, device=dev)
    one = []
    for b, s in zip(batches, seeds):
        loss, _ = tr.train_step(b, seed=s)
        one.append((float(loss), {n: p.grad.clone() for n, p
                                  in tr.model.named_parameters()}))

    def plain_step(masks=None):
        """The one-process plain step on the first batch, its stack's ReLU
        inputs recorded (and with ``masks``, one list of layer masks a
        stack call, held at those decisions), as ``step_check`` holds its
        plain step."""
        tr_p, pres = Trainer(cfg0, device=dev), []
        orig, held = gcnii_ops.gcnii_stack_plain, iter(masks or ())

        def record(*a, **k):
            pres.append([])
            if masks is not None:
                k["relu_masks"] = next(held)
            return orig(*a, relu_inputs=pres[-1], **k)
        gcnii_ops.gcnii_stack_plain = record
        try:
            with ops.plain_ops():
                loss_p, _ = tr_p.train_step(batches[0], seed=seeds[0])
            torch.cuda.synchronize()
        finally:
            gcnii_ops.gcnii_stack_plain = orig
        return float(loss_p), {n: p.grad.clone() for n, p
                               in tr_p.model.named_parameters()}, pres
    *plain, plain_pres = plain_step()

    t0 = time.perf_counter()
    jobs = [(workers.trainer_steps, dict(
                cfg=cfg0, n_data=2, n_model=1, batches=hosts, seeds=seeds,
                device="cuda", profile=True)),
            (workers.trainer_steps, dict(
                cfg=cfg4, n_data=2, n_model=1, batches=[same, hosts[1]],
                seeds=[3, 4], device="cuda", logits_seed=5)),
            (workers.trainer_steps, dict(
                cfg=cfg0, n_data=1, n_model=2, batches=hosts[:1],
                seeds=seeds[:1], device="cuda", profile=True,
                record_relu=True))]
    ranks = launch.run(workers.run_jobs, PARALLEL_RANKS, jobs, device="cuda",
                       share_device=True)
    ranks_s = time.perf_counter() - t0

    def summary(r):
        return {k: r.get(k) for k in (
            "data_rank", "model_rank", "losses", "step_ms", "busy_ms",
            "window_ms", "collective_host_ms", "launches")}

    # (a) data parallelism through the kernels
    dp = []
    for r in (rk[0] for rk in ranks):
        want = {k: 2 * v for k, v in PARALLEL_STEP.items()}
        check(r["launches"] == want, f"DP rank launches {r['launches']} != "
                                     f"{want} (2 steps)")
        errs = [grads_close(r["losses"][0], rank_grads(torch, dev, r),
                            *one[0], "DP step 1 vs one process")]
        step2 = abs(r["losses"][1] - one[1][0]) / abs(one[1][0])
        check(step2 <= STEP_LOSS_RTOL, f"DP step 2 loss {r['losses'][1]} "
                                       f"vs {one[1][0]}")
        dp.append({**summary(r), "step1": errs[0], "step2_loss_rel_err":
                   step2})
    for n, g in ranks[0][0]["grads"].items():
        check(np.array_equal(g, ranks[1][0]["grads"][n]),
              f"DP ranks' gradients of {n} differ")

    # (b) live dropout: each data rank its own masks
    drop = [rk[1] for rk in ranks]
    check(all(math.isfinite(v) for r in drop for v in r["losses"]),
          f"DP dropout losses {[r['losses'] for r in drop]}")
    # the valid utterances' log-probs of the two ranks' equal blocks
    valid = same.umask[:half] > 0
    lp0, lp1 = (r["logits"][valid] for r in drop)
    check(np.isfinite(lp0).all() and np.isfinite(lp1).all(),
          "DP dropout forwards not finite")
    differ = float(np.mean(np.abs(lp0 - lp1).max(-1) > 1e-3))
    check(differ > 0.5, f"the data ranks' training forwards on the same "
                        f"dialogues: {differ} of the utterances differ")

    # (c) the node-sharded stack, against the plain step at its own ReLU
    # decisions, or, where the gradients disagree, at the TP step's: the
    # sharded product sums adj @ h in another order, and a decision whose
    # input lies within rounding of 0 may flip (see step_check)
    tp = []
    for r in (rk[2] for rk in ranks):
        check(r["launches"]["gcnii_fwd"] == r["launches"]["gcnii_bwd"] == 0
              and r["launches"]["bigru_fwd"] == PARALLEL_STEP["bigru_fwd"]
              and r["launches"]["bigru_bwd"] == PARALLEL_STEP["bigru_bwd"],
              f"TP rank launches {r['launches']}")
        masks = [[torch.from_numpy(m).to(dev) for m in call]
                 for call in r["relu_decisions"]]
        check(len(masks) == len(plain_pres) == 1
              and len(masks[0]) == NLAYERS, "one stack call of 16 layers")
        flips, flip_pre = 0, 0.0
        for m, pre in zip(masks[0], plain_pres[0]):
            flipped = m != (pre > 0.0)
            flips += int(flipped.sum())
            if bool(flipped.any()):
                flip_pre = max(flip_pre, float(pre[flipped].abs().max()))
        tol = KERNEL_B_RTOL * max(1.0, max(float(p.abs().max())
                                           for p in plain_pres[0]))
        grads = rank_grads(torch, dev, r)
        errs = step_errs(r["losses"][0], grads, *plain, "TP step")
        held = not steps_agree(errs)
        if held:
            check(flip_pre <= tol, f"TP ReLU decisions differ at |pre| = "
                                   f"{flip_pre} > {tol}")
            loss_h, grads_h, _ = plain_step(masks)
            errs = grads_close(r["losses"][0], grads, loss_h, grads_h,
                               "TP step vs the plain step at its decisions")
        tp.append({**summary(r), "step1": errs,
                   "relu_decisions_differing": flips,
                   "max_abs_pre_where_they_differ": flip_pre,
                   "forward_tolerance": tol,
                   "held_at_tp_decisions": held})
    for n, g in ranks[0][2]["grads"].items():
        check(np.array_equal(g, ranks[1][2]["grads"][n]),
              f"TP ranks' gradients of {n} differ")

    tmp = tempfile.mkdtemp()
    try:
        pkl = f"{tmp}/iem.pkl"
        make_synthetic_iemocap_pickle(pkl, **PARALLEL_DATA)

        def cli(mod, argv):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                check(mod.main(argv) == 0, f"{mod.__name__} {argv}")
            return buf.getvalue()

        # (d) NCCL, one rank
        t0 = time.perf_counter()
        train_argv = ["--data_dir", pkl, "--epochs", "1", "--reason_flag",
                      "--class_weight", "--Deep_GCN_nlayers", str(NLAYERS)]
        lines = [epoch_lines(cli(run_train_erc, [
            *train_argv, "--save_model_dir", f"{tmp}/{name}", *extra]))
            for name, extra in (("solo", []),
                                ("nccl", ["--n_data_devices", "1"]))]
        cli_s = time.perf_counter() - t0
        check(len(lines[0]) == 2 and lines[0] == lines[1],
              f"the CLI on one NCCL rank: {lines[1]} vs {lines[0]}")

        # (e) the sharded sweep
        t0 = time.perf_counter()
        sweep_argv = ["--vmap", "--dataset", "IEMOCAP", "--data_dir", pkl,
                      "--limit", "4", "--epochs", "1", "--batch-size",
                      str(TRAIN_B)]
        layers = next(sweep.combos("IEMOCAP"))["Deep_GCN_nlayers"]
        metas = []
        for name, extra in (("solo", ["--device", "cuda"]),
                            ("sharded", ["--device", "cuda:0",
                                         "--n_data_devices", "2"])):
            cli(sweep, [*sweep_argv, "--out_dir", f"{tmp}/sw_{name}",
                        *extra])
            metas.append(ckpt_lib.read_meta(
                f"{tmp}/sw_{name}/group_Deep_GCN_nlayers{layers}", "final"))
        sweep_s = time.perf_counter() - t0
        check(len(metas[0]["history"]) == 4
              and metas[0]["history"] == metas[1]["history"]
              and metas[0]["best_epoch"] == metas[1]["best_epoch"],
              f"the sharded group's histories {metas[1]['history']} vs "
              f"{metas[0]['history']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    bars = {"loss_rel": STEP_LOSS_RTOL, "grad_of_its_max_abs": STEP_GRAD_RTOL}
    checks = {
        "a_data_parallel": {"ranks": dp, "bars": bars},
        "b_dropout": {"losses": [r["losses"] for r in drop],
                      "same_dialogues_share_differing": differ,
                      "max_abs_log_prob_diff": float(
                          np.abs(lp0 - lp1).max())},
        "c_node_sharded": {"ranks": tp, "bars": bars},
        "d_nccl_one_rank": {"lines_equal": True, "lines": lines[1],
                            "two_runs_s": cli_s},
        "e_sharded_sweep": {"histories_equal": True,
                            "best_test_fscore": metas[1]["best_test_fscore"],
                            "two_runs_s": sweep_s}}
    for key, value in checks.items():
        print(json.dumps({"parallel": {key: value}}), flush=True)
    return {"shape": f"IEMOCAP GDF reason {NLAYERS} layers, B={TRAIN_B} "
                     f"global, L<={TRAIN_L}; {PARALLEL_RANKS} ranks on one "
                     "card over gloo (walls measure sharing, not scaling)",
            "ranks_s": ranks_s, "passed": sorted(checks),
            "step_ms_by_rank": {"a": [r["step_ms"] for r in dp],
                                "c": [r["step_ms"] for r in tp]}}


def main() -> int:
    # keep CUPTI attached between torch.profiler windows: re-attached after
    # each window's teardown, it has missed every kernel of a short window
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
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
    from mmdfn_torch.data.batching import SERVE_BUCKETS
    from mmdfn_torch.device import resolve_device
    from mmdfn_torch.ops import _build

    global SMI
    dev = resolve_device("cuda")        # also sets the f32 (no TF32) policy
    smi = SMI = subprocess.run(
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
    # (A: 3 row tilings x serve / training x f32 / bf16 scan; C: 3 x 2)
    loops = [r for r in ptxas if r["lib"] in ("bigru_fwd", "bigru_bwd")
             and ("bigru_fwd_kernel" in r["kernel"]
                 or "bigru_bwd_kernel" in r["kernel"])]
    check(len(loops) == 18 and all(
        r.get("spill_stores", 1) == 0 and r.get("spill_loads", 1) == 0
        for r in loops), f"bi-GRU time-loop kernels spill: {loops}")
    # kernels B's and D's tiled products keep their register tiles: no
    # spills either
    for lib, parts in (("gcnii_fwd", KERNEL_B_PARTS),
                       ("gcnii_bwd", KERNEL_D_PARTS)):
        prods = [r for r in ptxas if r["lib"] == lib]
        check(len(prods) >= len(parts) and all(
            r.get("spill_stores", 1) == 0 and r.get("spill_loads", 1) == 0
            for r in prods), f"the kernels of {lib} spill: {prods}")

    # the kernel checks first, so that the serve and train lines stand near
    # the end of the output; their launches are zeroed before those runs
    seconds = {"build": time.perf_counter() - t0}
    t0 = time.perf_counter()
    cases_a = {(B, L): bigru_case(torch, dev, B, L)
               for L in (32, 64, 200) for B in (1, 6)}
    for B in (TRAIN_B, 6 * TRAIN_B):     # lstm_l, and rnn_parties' streams
        cases_a[(B, TRAIN_L)] = bigru_case(torch, dev, B, TRAIN_L, train=True)
    cases_b = {L: gcnii_case(torch, dev, L) for L in SERVE_BUCKETS}
    cases_b["200_no_reason"] = gcnii_case(torch, dev, 200, reason=False)
    crossover = gcnii_crossover(torch, dev)
    cases_c = {B: bigru_bwd_case(torch, dev, B, TRAIN_L,
                                 cases_a[(B, TRAIN_L)]["train_ms"])
               for B in (TRAIN_B, 6 * TRAIN_B)}
    case_bd = gcnii_train_case(torch, dev, TRAIN_B, TRAIN_L)
    mask = mask_check(torch, dev)
    print(json.dumps({"kernel_cases": {
        "bigru_fwd (library: torch.nn.GRU, cuDNN, all-valid mask, device "
        "time)": list(cases_a.values()),
        "gcnii_fwd": list(cases_b.values()),
        "gcnii_fwd designs at N = 240 by batch (inference; training "
        "mode: rate 0.4, residuals)": crossover,
        "bigru_bwd (library: torch.nn.GRU backward alone, cuDNN; "
        "library_fwd_bwd: its forward + backward, beside kernel A's "
        "training mode + kernel C; both device time)": list(cases_c.values()),
        "gcnii_fwd training mode": case_bd["fwd"],
        "gcnii_bwd": case_bd["bwd"],
        "dropout mask vs plain Philox": mask}}), flush=True)

    seconds["kernels"] = time.perf_counter() - t0
    results = {}
    for name, phase in (("serve", serve_phase), ("train", train_phase),
                        ("meld", meld_phase), ("families", families_phase),
                        ("nonvariant", nonvariant_phase),
                        ("single", single_phase), ("learn", learn_phase),
                        ("sweep", sweep_phase), ("daily", daily_phase),
                        ("raw", raw_phase), ("cores", cores_phase),
                        ("fast", fast_phase),
                        ("scan", scan_phase), ("rnn_bf16", rnn_bf16_phase),
                        ("parallel", parallel_phase)):
        t0 = time.perf_counter()
        results[name] = phase(torch, dev)
        seconds[name] = time.perf_counter() - t0
        print(json.dumps({name: results[name]}), flush=True)
    print(json.dumps({"phase_s": seconds,
                      "profile_windows_without_kernels": PROFILE_MISSES}),
          flush=True)
    train, fast, scan = results["train"], results["fast"], results["scan"]
    rnn = results["rnn_bf16"]

    # the line's numbers: the training step's shapes (the party streams'
    # B = 192 for the bi-GRU kernels; B = 32, N = 240 for the GCNII stack);
    # launches from the training step's main-path run
    big = (6 * TRAIN_B, TRAIN_L)
    fast_launches = fast["train_fast"]["launches"]
    scan_launches = scan["models"]["GF2"]["train"]["launches"]
    scan_cases = [scan["kernels"][c[0]] for c in SCAN_CASES]
    # the encoders' bf16 scan mode: rnn_parties' shape, launches from step
    # a's main-path run (the encoders alone in that mode)
    rnn_launches = rnn["train"]["a_knob_alone"]["launches"]
    rnn_cases = [c for k, c in rnn["kernels"].items() if k != "config_axis"]
    rnn_big = rnn["kernels"][f"B={6 * TRAIN_B} L={TRAIN_L}"]
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
         f"{KERNEL_D_RTOL} x max|grad| of each gradient, at kernel D's ReLU "
         "decisions"),
        # the bf16 modes (--tpu_fast): launches from the fast phase's step
        ("gcnii_fwd_bf16", "cuda", "mmdfn_torch/csrc/gcnii_fwd.cu",
         "mmdfn_tpu/ops/pallas_gcnii_train.py:472", fast["kernels"]["fwd"],
         max(fast["kernels"]["fwd"]["max_abs_err"],
             fast["kernels"]["serve"]["max_abs_err"]),
         fast["kernels"]["fwd"]["tolerance"]),
        ("gcnii_bwd_bf16", "cuda", "mmdfn_torch/csrc/gcnii_bwd.cu",
         "mmdfn_tpu/ops/pallas_gcnii_train.py:526", fast["kernels"]["bwd"],
         fast["kernels"]["bwd"]["max_abs_err"],
         fast["kernels"]["bwd"]["tolerance"]),
        # the bf16 scan mode: GF2's shape, and launches from the GF2 step's
        # main-path run (one stack call a step at that shape); the errors
        # the largest of the scan cases
        ("gcnii_fwd_bf16_scan", "cuda", "mmdfn_torch/csrc/gcnii_fwd.cu",
         "mmdfn_tpu/ops/pallas_gcnii_train.py:472",
         scan["kernels"]["GF2"]["fwd"],
         max([c["fwd"]["max_abs_err"] for c in scan_cases]
             + [scan["kernels"]["serve"]["max_abs_err"]]),
         scan["kernels"]["GF2"]["fwd"]["tolerance"]),
        ("gcnii_bwd_bf16_scan", "cuda", "mmdfn_torch/csrc/gcnii_bwd.cu",
         "mmdfn_tpu/ops/pallas_gcnii_train.py:526",
         scan["kernels"]["GF2"]["bwd"],
         max(c["bwd"]["max_abs_err"] for c in scan_cases),
         scan["kernels"]["GF2"]["bwd"]["tolerance"]),
        # the encoders' bf16 scan mode (rnn_compute_dtype='bfloat16'): the
        # errors the largest of the cases
        ("bigru_fwd_bf16_scan", "cuda", "mmdfn_torch/csrc/bigru_fwd.cu",
         "mmdfn_tpu/ops/pallas_rnn.py:266",
         {"shape": rnn_big["shape"], **rnn_big["fwd"]},
         max(c["fwd"]["max_abs_err"] for c in rnn_cases),
         f"at most {SCAN_SHARE} of the elements differ, none by more than "
         f"{SCAN_CAP_STEPS} bf16 steps of the scale"),
        ("bigru_bwd_bf16_scan", "cuda", "mmdfn_torch/csrc/bigru_bwd.cu",
         "mmdfn_tpu/ops/pallas_rnn.py:298",
         {"shape": rnn_big["shape"], **rnn_big["bwd"]},
         max(c["bwd"]["max_abs_err"] for c in rnn_cases if "bwd" in c),
         f"dxg as the forward's; dW_hh, db_hh within {RNN_W_STEPS} bf16 "
         "steps of their max"),
    ]
    kernels = []
    for name, route, source, replaces, case, err, tol in report:
        base = name.split("_bf16")[0]
        launches = (rnn_launches[base] if name.startswith("bigru")
                    and name.endswith("_scan")
                    else scan_launches[base] if name.endswith("_scan")
                    else fast_launches[base] if name.endswith("_bf16")
                    else train["launches"][name])
        kernels.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": err, "tolerance": tol, "shape": case["shape"],
            "ms": case["ms"], "plain_ms": case["plain_ms"],
            "bound_ms": case["bound_ms"], "bound_by": case["bound_by"],
            "library_ms": case["library_ms"]})
    check(set(ops.WRAPPERS) == {k["name"].split("_bf16")[0]
                                for k in kernels},
          "every kernel of the path is in the report")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
