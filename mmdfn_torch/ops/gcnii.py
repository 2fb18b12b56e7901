"""Kernels B and D: the GCNII stack (GCNII_lyc) forward, with a training
mode, and backward.

Kernel B replaces ``mmdfn_tpu/ops/pallas_gcnii.py:gcnii_stack_fused`` and
``mmdfn_tpu/ops/pallas_gcnii_train.py:_stack_fwd`` (``csrc/gcnii_fwd.cu``):
one C call, ``gcnii_fwd``, runs the whole stack in one of three designs,
picked by shape (:func:`_design`).  At the training batch it runs three
tiled f32 products a layer (``csrc/gemm_f32.cuh``): the
reason-LSTM's gates with the cell in the epilogue, ``adj @ h1``, and
``[hi | h0] @ W[l]`` with the update, the dropout and the skip in the
epilogue.  A serve forward (one dialogue) fills too few blocks for them:
up to N = 384 nodes it runs the resident design, the whole stack in one
launch on a cluster of 16 CTAs that split the channels and exchange rows
through distributed shared memory; at N = 600 the row-wise kernel, one
launch a layer, each block owning 8 rows.  No cuBLAS call stands in for
any of it.  In training mode it draws the dropout after each layer's ReLU
from Philox (``csrc/philox.cuh``, key the step seed, counter (b, layer,
node, channel)) and writes the residuals the backward reads.

Kernel D replaces ``mmdfn_tpu/ops/pallas_gcnii_train.py:_stack_bwd``
(``csrc/gcnii_bwd.cu``): the reverse layer walk as tiled f32
products (``csrc/gemm_f32.cuh``) with the elementwise work in their
epilogues, the dropout bits drawn again, and every gradient (adjacency,
entry h, h0, the per-layer weights, the reason-LSTM's weights); the weight
gradients are summed once after the walk.

In the f32 mode both kernels run their tiled products on the tensor cores
as 3xTF32 (each operand split into two TF32 values, three TF32 products
into f32 accumulators: f32's accuracy, ``gemm_f32.cuh``'s note); in the
bf16 modes, and kernel B's resident and row-wise designs, on the CUDA
cores.  The mode alone decides; there is no other switch.

``gcnii_stack_fwd`` with autograd on goes through :class:`GCNIIStackTrain`
(kernel B in training mode, keeping the residuals; kernel D backward); with
autograd off it runs kernel B alone.  Each wrapper launches its kernels for
CUDA tensors and runs its plain version for CPU tensors; anything else
raises.  Each counts the CUDA kernels its C call launched.  Inside
``ops.plain_ops()`` ``gcnii_stack_fwd`` runs the plain forward and autograd
differentiates it.

Config axis (the grouped sweep's K stacked configurations,
``train/vmap_sweep.py``): adj, h, h0, W (K, nl, 2H, H) and the
reason-LSTM's weights carry a leading K, theta and the step seed are
shared.  Both C calls then run the K B dialogues as one batch, each
product reading its dialogue's configuration's weights, and kernel D sums
each configuration's weight gradients over its own rows.  The dropout
rate is a Python float, or per configuration a ``DropRate``
(``nn/drop_override.py``): the kernels always read the keep threshold and
keep scale from device memory, one per configuration (JAX's ``dyn``
branch, ``pallas_gcnii_train.py:143-147,230-234``), a rate-0
configuration keeping every element without a draw (its keep scale is
exactly 1, ``:160``), and Philox's counter takes the dialogue's index in
its configuration, so configuration k draws the bits its run alone
draws.  Under ``torch.func.vmap`` the Functions' ``vmap`` rules move the
config axis to the front and make that one launch, which autograd
records: the backward is one config-axis launch of kernel D.

The numerics are one of three modes (``mode``).  ``'f32'`` is the JAX
package's parity default.  The bf16 mode (``'bf16'``; the JAX package's
production configuration, ``gcn_backend='pallas'``) computes what the
TPU training kernel computes
(``mmdfn_tpu/ops/pallas_gcnii_train.py``, bf16 by construction): adj, h0
and W rounded to bf16 (``:691-697``); each layer's products on bf16
operands with f32 sums, ``adj @ bf16(h1)`` and ``bf16(hi) @ W1 + h0 @ W2``
(``:104-109,141-142``); the carries, the LSTM step and the elementwise
work in f32; the residuals three bf16 slabs, the pre-layer h, lh and lc
(``:150-153``, ``RESIDUALS_BF16``); the backward recomputes each layer,
the LSTM step included, from those bf16 carries (``:245-271``) with its
gradient products in f32, and rounds d_adj, d_h0 and dW to bf16
(``:637-638``).  Kernel B runs it in its tiled design only.  With autograd
on it always goes through :class:`GCNIIStackTrain` (inside
``ops.plain_ops()`` too, on the plain versions), since autograd through
the rounded forward is not the backward that recomputes from bf16 carries.

The bf16 scan mode (``'bf16_scan'``; ``gcn_compute_dtype='bfloat16'``
wherever JAX's ``GCNIIStack`` runs its ``lax.scan``,
``mmdfn_tpu/nn/gcn.py:229-287``) is XLA's bf16 arithmetic: the carries h,
lh and lc, h0, adj, W, theta and the reason-LSTM's weights in bf16, every
elementwise op rounded to bf16 (its constants too: 1-α, α, 1-θ_l and the
dropout's keep scale), every product on bf16 operands with f32 sums and
its output rounded once, and the LSTM's gates as JAX adds them,
``((h W_ih + b_ih) + lh W_hh) + b_hh``, so that the two products stay
apart (``lstm_b`` is then (2, 4H), ``[b_ih; b_hh]``).  Its backward is the
transposed scan's: each op's gradient rounded to bf16, and the gradients
that the scan carries or sums across layers (d_h, d_lh, d_lc, d_adj, d_h0,
the LSTM weights' and each layer's dW) held in bf16.  The plain version
(:func:`_scan_plain`) is torch ops on bf16 tensors, differentiated by
autograd; :func:`_scan_bwd_plain` is kernel D's reverse walk in plain ops,
rounding where autograd does, which the tests hold to autograd.  Kernels B
and D run it in the tiled design; ``variant=False`` runs unfolded (the
products take ``r``, K = H), and ``last_drop_f32`` takes the last layer's
dropout in f32 on the widened output, as JAX's post-loop dropout after
the scan (GF2's wiring, ``nn/gcn.py``).

The original GCNII update (``variant=False``: W (nl, H, H), support = r =
(1-α) hi + α h0) runs the same kernels on the fold of W,
``[(1-α) W; α W]`` (:func:`fold_weights`, as
``mmdfn_tpu/ops/pallas_gcnii.py:121-125`` folds it): ``r @ W`` equals
``[hi | h0] @ W_cat``, and autograd carries kernel D's ``dW_cat`` back
through the fold.  Its plain version computes ``r @ W`` unfolded.

Under a ``torch.profiler`` each kernel call is a span of the program's log
(``runtime/profiling.py``), ``ops.gcnii_fwd`` (K, B, N, layers, design,
mode) or ``ops.gcnii_bwd`` (K, B, N, layers, mode), and adds the products
it ran on the tensor cores to the counter ``ops.gcnii_tc_products``.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from mmdfn_torch.ops import _build, _mode, philox
from mmdfn_torch.ops.bf16 import (BF16, F32, MODES, SCAN, Sigmoid, Tanh,
                                  check_mode, mm, to_bf16)
from mmdfn_torch.ops.bigru import _sm_count
from mmdfn_torch.runtime.profiling import annotate, count

Tensor = torch.Tensor

_p, _i, _f, _u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
# adj, h, h0, W, theta, alpha, wl, ih, hh, lb, out, scratch, res_h, res_lh,
# res_lc, res_h1, drop, thresh_k, inv_keep_k, thresh, inv_keep, seed,
# reason, design, nl, K, B, N, H, mode (see _mode_bits), stream
_ARGTYPES = ([_p] * 5 + [_f] + [_p] * 10 + [_i, _p, _p, _u, _f, _p]
             + [_i] * 8 + [_p])
# kernel B's designs (gcnii_fwd.cu): three tiled products a layer, one
# row-wise launch a layer, or the whole stack in one launch, a cluster of
# CTAs a dialogue
TILED, ROWWISE, RESIDENT = 0, 1, 2
DESIGNS = {"tiled": TILED, "rowwise": ROWWISE, "resident": RESIDENT}
# the resident design's plan, as gcnii_fwd.cu fixes it: CTAs a dialogue,
# channels a CTA at most, the buffers whose channels its table locates,
# F1's staging (two 16 x 32 buffers for each of 8 warps), and the shared
# memory a block may have on an H100
RESIDENT_CLUSTER, _SLICE_PAD, _BUFS, _OWNERS = 16, 8, 5, 128
_STAGE = 8 * 2 * 16 * 32
SMEM_MAX = 232448
# the most nodes for which the resident design measured faster than the
# row-wise kernel (one dialogue, 16 layers; PERF.md §6)
RESIDENT_MAX_N = 384
# adj, h0, W, theta, alpha, res_h, res_lh, res_lc, res_h1, ih, hh, lb,
# dh_out, dh, dlh, dlc, d_hi, dh0, dadj, hi, tdpre, gates, dgates, part_w,
# part_l, dW, dl, drop, thresh_k, inv_keep_k, thresh, inv_keep, seed,
# reason, nl, K, B, N, H, splits_w, splits_l, mode, wl, stream
_BWD_ARGTYPES = ([_p] * 4 + [_f] + [_p] * 22 + [_i, _p, _p, _u, _f, _p]
                 + [_i] * 9 + [_p, _p])
# row splits of the weight-gradient sums after the walk: dW (K = B N rows,
# nl layers, 2 x 1 tiles each) and the LSTM's (K = B nl N, 2 x 4 tiles);
# 8 x 32 and 32 x 8 blocks fill the card's 132 SMs about twice
_SPLITS_W, _SPLITS_L = 8, 32
_SPLIT_ROWS_MIN = 16   # one 16-deep slice of the product


def gcnii_bwd_splits(R: int, nl: int) -> Tuple[int, int]:
    """Kernel D's row splits of the dW and the LSTM weight-gradient sums,
    for R = B N rows (of one configuration) and nl layers."""
    return (max(1, min(_SPLITS_W, R // _SPLIT_ROWS_MIN)),
            max(1, min(_SPLITS_L, nl * R // _SPLIT_ROWS_MIN)))

# the residual slabs, each (B, nlayers, N, H): the pre-layer h, lh, lc of
# every layer and the layer's LSTM output h1; in the bf16 modes the first
# three, in bf16
RESIDUALS = ("h", "lh", "lc", "h1")
# the program's counter of the products run on the tensor cores (3xTF32)
TC_PRODUCTS = "ops.gcnii_tc_products"
RESIDUALS_BF16 = RESIDUALS[:3]


def _mode_bits(mode: str, variant: bool = True,
               last_drop_f32: bool = False) -> int:
    """The C entries' ``mode``: 0 f32, 1 bf16, 2 the bf16 scan, plus 4
    for the scan's last dropout in f32 and 8 for its unfolded
    ``variant=False``."""
    return (MODES.index(mode) + 4 * int(mode == SCAN and last_drop_f32)
            + 8 * int(mode == SCAN and not variant))


def tc_products(launches: int, mode: str, tiled: bool,
                others: int = 1) -> int:
    """The products of a C call that ran on the tensor cores: in the f32
    mode every tiled product (all its launches but ``others``: kernel B's
    first launch, kernel D's sums after the walk); none in the bf16 modes
    or kernel B's resident and row-wise designs."""
    return launches - others if mode == F32 and tiled else 0


def residual_names(mode: str) -> tuple:
    return RESIDUALS if mode == F32 else RESIDUALS_BF16


def residual_slabs(shape, mode: str, dev) -> list:
    """Empty residual slabs of ``shape`` (B, nlayers, N, H) for a mode:
    four f32 ones, or in the bf16 modes three bf16 ones."""
    check_mode(mode)
    if mode != F32:
        return [torch.empty(shape, device=dev, dtype=torch.bfloat16)
                for _ in RESIDUALS_BF16]
    return [torch.empty(shape, device=dev) for _ in RESIDUALS]


def gcnii_fwd_launches(nl: int, reason: bool, design: int = TILED,
                       mode: str = F32) -> int:
    """The CUDA kernels one ``gcnii_fwd`` call launches: a first one that
    sets up the layer-0 state, then per layer the gates, ``adj @ h1`` and
    the update (the row-wise design: one a layer, and with reason one for
    layer 0's LSTM step; the resident design: one in all).  The bf16 scan
    mode runs the gates as two products (``h W_ih`` and ``lh W_hh``)."""
    if design == RESIDENT:
        return 1
    if design == ROWWISE:
        return 1 + nl + int(reason)
    return 1 + (2 + (2 if mode == SCAN else 1) * int(reason)) * nl


def gcnii_bwd_launches(nl: int, reason: bool, mode: str = F32) -> int:
    """The CUDA kernels one ``gcnii_bwd`` call launches: per layer the
    products P2-P6, with reason also P1 (in the bf16 scan mode two
    products) and P7; after the walk dW's sum and its reduce, with reason
    also the LSTM's."""
    p1 = 2 if mode == SCAN else 1
    return nl * ((6 + p1) if reason else 5) + (4 if reason else 2)


def resident_slices(H: int) -> list:
    """The resident design's channel slices ``(c0, S)``, one per CTA of a
    dialogue's cluster: H split as evenly as the cluster allows."""
    base, extra = divmod(H, RESIDENT_CLUSTER)
    return [(q * base + min(q, extra), base + int(q < extra))
            for q in range(RESIDENT_CLUSTER)]


def resident_smem_bytes(N: int, H: int) -> int:
    """Shared memory of one CTA of the resident design (gcnii_fwd.cu:
    ``resident_smem_bytes``): 7 state buffers of 8 channels x N rounded up
    to 4 rows, the gate weights' slice with its bias row, W[l]'s slice
    twice (the next layer's fetched during this one), F1's staging, and
    the table of where each channel of the gathered buffers lives (32-bit
    cluster addresses)."""
    NP = -(-N // 4) * 4
    return (4 * (7 * _SLICE_PAD * NP + (2 * H + 1) * 4 * _SLICE_PAD
                 + 2 * 2 * H * _SLICE_PAD + _STAGE + _BUFS * _OWNERS))


def _design(B: int, N: int, sms: int, H: int = 100) -> int:
    """Kernel B's design for B dialogues of N nodes on a card of ``sms``
    multiprocessors: the tiled products where their 64-row tiles (B x
    ceil(N / 64) blocks a product) number at least a quarter of the SMs;
    else the resident design up to ``RESIDENT_MAX_N`` nodes, where its
    shared memory fits; else the row-wise kernel.  On an H100 (PERF.md §6)
    at N = 240 the resident design is the fastest up to B = 8 (32 tiles)
    and the tiled products from B = 16 (64 tiles); for one dialogue the
    resident design is the fastest at the serve buckets up to N = 384 and
    the row-wise kernel at N = 600."""
    if B * -(-N // 64) >= sms // 4:
        return TILED
    if N <= RESIDENT_MAX_N and resident_smem_bytes(N, H) <= SMEM_MAX:
        return RESIDENT
    return ROWWISE


def interleave_gates(ih: Tensor, hh: Tensor, *biases: Tensor) -> Tensor:
    """``[W_ih; W_hh; b...]`` ((H, 4H), (H, 4H), each bias (4H,); gate
    columns u H + c for gate u = i, f, g, o of channel c) with the gate
    columns interleaved, as kernel B's LSTM product reads it: (2H + nb,
    4H), column 4c + u is gate u of channel c, so that the four gates of a
    channel are four neighbouring columns of the product.  One bias is
    ``b_ih + b_hh``; the bf16 scan mode gives ``b_ih`` and ``b_hh`` apart.
    A leading config axis is kept."""
    *lead, H, G = ih.shape
    rows = 2 * H + len(biases)
    return torch.cat([ih, hh, *(b[..., None, :] for b in biases)], dim=-2) \
        .view(*lead, rows, 4, H).transpose(-1, -2).reshape(*lead, rows, G)


class _Rate(NamedTuple):
    """A rate per configuration as the kernels read it: the fields of
    ``nn/drop_override.py``'s ``DropRate`` that they take."""

    thresh: Tensor      # int32, the uint32 keep threshold's bit pattern
    inv_keep: Tensor    # f32, exactly 1.0 at rate 0


def _dropout_args(rate, seed: Optional[Tensor]):
    """(drop, thresh, inv_keep): for a Python rate, whether it drops, the
    rate (``philox.keep_mask`` takes it) and 1 / (1 - rate); for a rate
    per configuration (anything with ``thresh`` and ``inv_keep``), True and
    its two tensors."""
    if hasattr(rate, "thresh"):
        if seed is None:
            raise ValueError("dropout needs a seed tensor")
        return True, rate.thresh, rate.inv_keep
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} outside [0, 1)")
    if rate > 0.0 and seed is None:
        raise ValueError("dropout needs a seed tensor")
    return rate > 0.0, rate, 1.0 / (1.0 - rate)


def _keep(seed: Tensor, thresh, inv_keep, B: int, l: int, N: int,
          H: int) -> Tensor:
    """Layer l's keep mask; for a rate per configuration with JAX's
    keep-all guard: a keep scale of exactly 1 (rate 0) keeps every
    element, as ``pallas_gcnii_train.py:160`` does, where the threshold
    2^32 - 1 alone would drop the draws equal to it."""
    keep = philox.keep_mask(seed, thresh, B, l, N, H)
    if isinstance(inv_keep, Tensor):
        keep = keep | (inv_keep == 1.0)
    return keep


def _lstm_step(h: Tensor, lh: Tensor, lc: Tensor, ih: Tensor, hh: Tensor,
               b: Tensor):
    g = h @ ih + lh @ hh + b
    i, f, gg, o = g.chunk(4, dim=-1)
    i, f, gg, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(gg), \
        torch.sigmoid(o)
    lc1 = f * lc + i * gg
    return o * torch.tanh(lc1), lc1, (i, f, gg, o)


def gcnii_stack_plain(adj: Tensor, h: Tensor, h0: Tensor, W: Tensor,
                      theta: Tensor, lstm_ih: Optional[Tensor] = None,
                      lstm_hh: Optional[Tensor] = None,
                      lstm_b: Optional[Tensor] = None, *, alpha: float,
                      reason: bool, rate: float = 0.0,
                      seed: Optional[Tensor] = None,
                      residuals: Optional[Sequence[Tensor]] = None,
                      relu_masks: Optional[Sequence[Tensor]] = None,
                      relu_inputs: Optional[list] = None,
                      spmm: Optional[Callable[[Tensor, Tensor],
                                              Tensor]] = None,
                      variant: bool = True, mode: str = F32,
                      last_drop_f32: bool = False) -> Tensor:
    """Plain PyTorch version of :func:`gcnii_stack_fwd` (same contract);
    differentiable by autograd (in the f32 and bf16 scan modes: in the bf16
    mode the backward is :func:`gcnii_stack_bwd_plain`'s, from the bf16
    carries).  The dropout mask comes from :mod:`mmdfn_torch.ops.philox`,
    bit-equal to the kernel's.  ``variant=False`` computes ``r @ W[l]``
    itself, not through the fold.  The bf16 scan mode is
    :func:`_scan_plain`.

    ``spmm``, when given, computes each layer's ``adj @ h`` in place of the
    batched product (the node-sharded product,
    ``parallel.graph_parallel.sharded_spmm_batched``).

    ``rate`` is a Python rate, or a rate per configuration
    (``nn/drop_override.py``'s ``DropRate``, 0-d under ``vmap``).

    ``relu_masks``, when given, are each layer's ReLU decisions (as in
    :func:`gcnii_stack_bwd_plain`) in place of ``pre > 0`` (in the bf16
    scan mode in the backward alone): a check holds a training step at
    the kernels' decisions with them; ``relu_inputs``,
    when given, receives each layer's ReLU input ``pre``, detached, so
    that a check can compare two steps' decisions."""
    check_mode(mode)
    if mode == SCAN:
        return _scan_plain(adj, h, h0, W, theta, lstm_ih, lstm_hh, lstm_b,
                           alpha=alpha, reason=reason, rate=rate, seed=seed,
                           residuals=residuals, relu_masks=relu_masks,
                           relu_inputs=relu_inputs, spmm=spmm,
                           variant=variant, last_drop_f32=last_drop_f32)
    bf16 = mode == BF16
    drop, thresh, inv_keep = _dropout_args(rate, seed)
    B, N, H = h.shape
    rd = to_bf16 if bf16 else (lambda x: x)
    if bf16:
        if not variant or spmm is not None:
            raise ValueError("the bf16 mode runs the variant's update on "
                             "the batched product only")
        adj, h0, W = rd(adj), rd(h0), rd(W)
    lh = torch.zeros_like(h)
    lc = torch.zeros_like(h)
    for l in range(W.shape[0]):
        q = h
        if residuals is not None:   # a bf16 slab rounds as it stores
            residuals[0][:, l] = h.detach()
            residuals[1][:, l] = lh.detach()
            residuals[2][:, l] = lc.detach()
        if reason:
            lh, lc, _ = _lstm_step(h, lh, lc, lstm_ih, lstm_hh, lstm_b)
            h = lh
        if residuals is not None and not bf16:
            residuals[3][:, l] = h.detach()
        hi = adj @ rd(h) if spmm is None else spmm(adj, h)
        r = (1.0 - alpha) * hi + alpha * h0
        support = (rd(hi) @ W[l, :H] + h0 @ W[l, H:]) if variant \
            else r @ W[l]
        pre = theta[l] * support + (1.0 - theta[l]) * r
        if relu_inputs is not None:
            relu_inputs.append(pre.detach())
        h = (torch.relu(pre) if relu_masks is None
             else torch.where(relu_masks[l], pre, 0.0))
        if drop:
            keep = _keep(seed, thresh, inv_keep, B, l, N, H)
            h = torch.where(keep, h * inv_keep, 0.0)
        if reason:
            h = h + q
    return h


def _scan_consts(alpha: float) -> Tuple[float, float]:
    """1-α and α rounded to bf16, as JAX rounds a Python float that a bf16
    tensor multiplies (weak typing)."""
    return tuple(float(torch.tensor(v, dtype=torch.bfloat16))
                 for v in (1.0 - alpha, alpha))


class _ReluHeld(torch.autograd.Function):
    """``relu(x)`` whose backward passes the gradient where ``mask`` is
    True, in place of ``x > 0``: the bf16 scan mode's plain step held at
    kernel D's ReLU decisions (its tdpre slab's nonzeros) in the backward
    alone."""

    @staticmethod
    def forward(x, mask):
        return torch.relu(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[1])

    @staticmethod
    def backward(ctx, d):
        mask, = ctx.saved_tensors
        return torch.where(mask, d, 0.0), None


def _scan_plain(adj, h, h0, W, theta, lstm_ih, lstm_hh, lstm_b, *, alpha,
                reason, rate, seed, residuals, relu_masks, relu_inputs,
                spmm, variant, last_drop_f32) -> Tensor:
    """The bf16 scan mode's plain version: ``mmdfn_tpu/nn/gcn.py:229-287``
    as torch ops on bf16 tensors, in JAX's order, each op rounding to
    bf16; differentiable by autograd, whose backward rounds and carries
    where the transposed scan does.  ``lstm_b`` is ``[b_ih; b_hh]`` (2,
    4H).  The in-loop dropout scales by the keep scale rounded to bf16;
    with ``last_drop_f32`` the last layer's scales the output widened to
    f32 by the f32 keep scale.  ``spmm`` takes and returns bf16
    tensors.  ``relu_masks`` hold the ReLU's backward alone (its forward
    stays ``relu``): the gradient passes where a mask is True, as kernel
    D's tdpre slab records its decisions (nonzero where the ReLU passed a
    nonzero gradient)."""
    drop, thresh, inv_keep = _dropout_args(rate, seed)
    bf = lambda t: t.to(torch.bfloat16)
    dev = h.device
    a1, a2 = (torch.tensor(v, dtype=torch.bfloat16, device=dev)
              for v in _scan_consts(alpha))
    B, N, H = h.shape
    adj, h, h0, W, th = bf(adj), bf(h), bf(h0), bf(W), bf(theta)
    if reason:
        ih, hh, bih, bhh = bf(lstm_ih), bf(lstm_hh), bf(lstm_b[0]), bf(
            lstm_b[1])
    ik = torch.as_tensor(inv_keep, dtype=torch.float32, device=dev)
    lh = lc = torch.zeros_like(h)
    nl = W.shape[0]
    for l in range(nl):
        if residuals is not None:
            residuals[0][:, l] = h.detach()
            residuals[1][:, l] = lh.detach()
            residuals[2][:, l] = lc.detach()
        q = h
        if reason:   # ((h W_ih + b_ih) + lh W_hh) + b_hh, as JAX adds it
            g = mm(h, ih) + bih
            g = g + mm(lh, hh)
            g = g + bhh
            i, f, gg, o = g.chunk(4, dim=-1)
            i, f, gg, o = Sigmoid.apply(i), Sigmoid.apply(f), \
                Tanh.apply(gg, gg), Sigmoid.apply(o)
            lc = f * lc + i * gg
            lh = o * Tanh.apply(lc, lc)
            h = lh
        hi = mm(adj, h) if spmm is None else spmm(adj, h)
        if variant:
            support = torch.cat([hi, h0], dim=-1)
        r = a1 * hi + a2 * h0
        s = mm(support if variant else r, W[l])
        pre = th[l] * s + (1 - th[l]) * r
        if relu_inputs is not None:
            relu_inputs.append(pre.detach().float())
        h = (torch.relu(pre) if relu_masks is None
             else _ReluHeld.apply(pre, relu_masks[l]))
        if drop:
            keep = _keep(seed, thresh, inv_keep, B, l, N, H)
            if last_drop_f32 and l == nl - 1:
                h = torch.where(keep, h.float() * ik, 0.0)
            else:
                h = torch.where(keep, h * bf(ik), 0.0)
        if reason:
            h = h + q
    return h.float()


def _scan_bwd_plain(adj, h0, W, theta, lstm_ih, lstm_hh, lstm_b, residuals,
                    dh_out, *, alpha, reason, rate, seed, relu_masks,
                    relu_inputs, variant, last_drop_f32):
    """Kernel D's reverse walk in the bf16 scan mode, in plain ops on f32
    tensors that hold bf16 values (``to_bf16`` after each op): each layer
    recomputed from the bf16 slabs h, lh, lc as :func:`_scan_plain`
    computes it, then each op's gradient rounded where autograd's
    backward of :func:`_scan_plain` rounds it, and summed in its order:
    d_h0 takes the r path's term, then the support product's; d_adj,
    d_h0 and the LSTM's weights sum their layers' rounded terms from the
    last layer down, rounding each sum.  Same contract as
    :func:`gcnii_stack_bwd_plain`; the LSTM bias gradient is (2, 4H), the
    same row for b_ih and b_hh."""
    drop, thresh, inv_keep = _dropout_args(rate, seed)
    rd = to_bf16
    a1, a2 = _scan_consts(alpha)
    h_res, lh_res, lc_res = residuals[:3]
    adj, h0, W, ths = rd(adj), rd(h0), rd(W), rd(theta)
    B, N, H = h0.shape
    nl = W.shape[0]
    if reason:
        ih, hh, bih, bhh = rd(lstm_ih), rd(lstm_hh), rd(lstm_b[0]), rd(
            lstm_b[1])
    ik = torch.as_tensor(inv_keep, dtype=torch.float32, device=h0.device)
    rows = lambda x: x.reshape(-1, x.shape[-1])
    acc = lambda old, new: new if old is None else rd(old + new)
    sig = lambda x: rd(1.0 / rd(1.0 + rd(torch.exp(-x))))
    # the transposes of JAX's logistic and tanh JVPs at the output y
    dsig = lambda d, y: rd(d * rd(y * rd(1.0 - y)))

    def dtanh(d, y, carry=None):   # (carry + a) + a y
        a = rd(d * rd(1.0 - y))
        return rd(acc(carry, a) + rd(a * y))
    dadj = dh0 = dih = dhh = db = dlh = dlc = None
    dW = torch.zeros_like(W)
    dh = dh_out
    for l in range(nl - 1, -1, -1):
        first = l == nl - 1
        h, lh, lc = (r[:, l].float() for r in (h_res, lh_res, lc_res))
        th = ths[l]
        omt = rd(1.0 - th)
        if reason:
            g = rd(rd(rd(rd(h @ ih) + bih) + rd(lh @ hh)) + bhh)
            gi, gf, gg, go = g.chunk(4, dim=-1)
            i, f, gt, o = sig(gi), sig(gf), rd(torch.tanh(gg)), sig(go)
            lc1 = rd(rd(f * lc) + rd(i * gt))
            t = rd(torch.tanh(lc1))
            h1 = rd(o * t)
        else:
            h1 = h
        hi = rd(adj @ h1)
        r = rd(rd(a1 * hi) + rd(a2 * h0))
        sup = torch.cat([hi, h0], dim=-1) if variant else r
        pre = rd(rd(th * rd(sup @ W[l])) + rd(omt * r))
        # the gradient of the layer's output past its dropout
        if drop:
            keep = _keep(seed, thresh, inv_keep, B, l, N, H)
            g = (rd(dh * ik) if first and last_drop_f32
                 else rd(rd(dh) * rd(ik)))
            g = torch.where(keep, g, 0.0)
        else:
            g = rd(dh)
        if relu_inputs is not None:
            relu_inputs.insert(0, (pre, g))
        passes = pre > 0.0 if relu_masks is None else relu_masks[l]
        dpre = torch.where(passes, g, 0.0)
        ds = rd(th * dpre)
        dr = rd(omt * dpre)
        if variant:
            dh0 = acc(dh0, rd(a2 * dr))
            dcat = rd(ds @ W[l].t())
            d_hi = rd(rd(a1 * dr) + dcat[..., :H])
            dh0 = rd(dh0 + dcat[..., H:])
        else:
            dr = rd(dr + rd(ds @ W[l].t()))
            d_hi = rd(a1 * dr)
            dh0 = acc(dh0, rd(a2 * dr))
        dW[l] = rd(rows(sup).t() @ rows(ds))
        dadj = acc(dadj, rd(d_hi @ h1.transpose(-1, -2)))
        d_h1 = rd(adj.transpose(-1, -2) @ d_hi)
        if not reason:
            dh = d_h1
            continue
        dlh1 = acc(dlh, d_h1)
        d_o, d_t = rd(dlh1 * t), rd(dlh1 * o)
        dlc1 = dtanh(d_t, t, dlc)
        d_i, d_gt, d_f = rd(dlc1 * gt), rd(dlc1 * i), rd(dlc1 * lc)
        dlc = rd(dlc1 * f)
        dg = torch.cat([dsig(d_i, i), dsig(d_f, f), dtanh(d_gt, gt),
                        dsig(d_o, o)], dim=-1)
        dih = acc(dih, rd(rows(h).t() @ rows(dg)))
        dhh = acc(dhh, rd(rows(lh).t() @ rows(dg)))
        db = acc(db, rd(rows(dg).sum(dim=0)))
        dh = rd(rd(dh) + rd(dg @ ih.t()))     # the skip plus the LSTM input
        dlh = rd(dg @ hh.t())
    if not reason:
        dih = dhh = h0.new_zeros(H, 4 * H)
        db = h0.new_zeros(4 * H)
    return dadj, dh, dh0, dW, dih, dhh, torch.stack([db, db])


def _check_all(expect, dev, dtype=torch.float32) -> None:
    for name, t, shape in expect:
        if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
                or t.device != dev:
            raise ValueError(f"{name}: expected {dtype} {tuple(shape)} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")


def _seed_ptr(seed: Optional[Tensor], drop: bool, dev) -> Optional[int]:
    """The address of the step seed, one int64 on the device, as the kernels
    read it; null without dropout, where they never read it."""
    if not drop:
        return None
    if seed.numel() != 1 or seed.dtype != torch.int64 or seed.device != dev:
        raise ValueError(f"seed: expected one int64 on {dev}, got "
                         f"{seed.dtype} {tuple(seed.shape)} on {seed.device}")
    return seed.data_ptr()


def gcnii_stack_fwd(adj: Tensor, h: Tensor, h0: Tensor, W: Tensor,
                    theta: Tensor, lstm_ih: Optional[Tensor] = None,
                    lstm_hh: Optional[Tensor] = None,
                    lstm_b: Optional[Tensor] = None, *, alpha: float,
                    reason: bool, rate=0.0,
                    seed: Optional[Tensor] = None,
                    residuals: Optional[Sequence[Tensor]] = None,
                    variant: bool = True,
                    folded: Optional[Tensor] = None,
                    mode: str = F32, last_drop_f32: bool = False) -> Tensor:
    """GCNII stack forward (deterministic at ``rate = 0``).

    Args:
      adj: (B, N, N) normalized adjacency; h: (B, N, H) loop-entry hidden;
      h0: (B, N, H) residual anchor; W: (nlayers, 2H, H), or (nlayers, H,
      H) with ``variant=False`` (the kernels then run on its fold, or on
      ``folded`` where the caller keeps ``fold_weights(W, alpha)``; the
      bf16 scan mode runs unfolded);
      theta: (nlayers,);
      lstm_ih / lstm_hh: (H, 4H) reason-LSTM weights in the JAX orientation
      (a transposed view of torch's (4H, H) weights is copied contiguous,
      so that the kernel's weight reads coalesce);
      lstm_b: (4H,) = b_ih + b_hh; in the bf16 scan mode (2, 4H), b_ih and
      b_hh.  The LSTM arguments are used iff reason.
      rate: dropout after each layer's ReLU, a Python rate or a rate per
        configuration (``nn/drop_override.py``'s ``DropRate``); seed: the
        step's 64-bit seed, one int64 on the device (read by the kernel,
        never by the host).
      residuals: when given, the four (B, nlayers, N, H) slabs named by
        ``RESIDUALS`` (the bf16 modes: the three bf16 ones of
        ``RESIDUALS_BF16``), filled in place for the backward.
      mode: ``'f32'``, ``'bf16'`` (the TPU training kernel's numerics; the
        variant's update only) or ``'bf16_scan'`` (JAX's bf16 layer scan);
        see the module's note.
      last_drop_f32: the bf16 scan mode's last dropout in f32 (JAX's
        post-loop dropout; see the module's note).
    Returns:
      (B, N, H) final hidden state (rows of masked nodes are garbage).
      With autograd on (and no ``residuals`` asked for) it goes through
      :class:`GCNIIStackTrain`, so its gradients come from kernel D; inside
      ``ops.plain_ops()``, and on CPU tensors in the bf16 scan mode,
      autograd differentiates the plain version.
      Under ``torch.func.vmap`` (the operands but theta and the seed may
      carry the config axis) the kernels take the whole group in one
      launch.
    """
    check_mode(mode)
    opts = dict(alpha=alpha, reason=reason, rate=rate, seed=seed)
    if mode == BF16 and not variant:
        raise ValueError("gcnii_stack_fwd: the bf16 mode runs the variant's "
                         "update only")
    scan = mode == SCAN
    if scan and (_mode.plain or h.device.type == "cpu"):
        return gcnii_stack_plain(adj, h, h0, W, theta, lstm_ih, lstm_hh,
                                 lstm_b, residuals=residuals, variant=variant,
                                 mode=mode, last_drop_f32=last_drop_f32,
                                 **opts)
    args = (adj, h, h0, W, theta, lstm_ih, lstm_hh, lstm_b)
    dyn = hasattr(rate, "thresh")
    # the kernels' variant: outside the bf16 scan mode they take the fold
    kvariant = variant or not scan
    fn_args = (*args, *_rate_ops(rate), seed, alpha, reason,
               None if dyn else rate, mode, kvariant, last_drop_f32)
    batched = any(_mode.is_batched(t) for t in fn_args)
    train = residuals is None and torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in args)
    if _mode.plain and not (mode == BF16 and (batched or train)):
        return gcnii_stack_plain(adj, h, h0, W, theta, lstm_ih, lstm_hh,
                                 lstm_b, residuals=residuals, variant=variant,
                                 mode=mode, **opts)
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gcnii_stack_fwd: no kernel for {h.device}")
    if not variant and not scan:
        W = fold_weights(W, alpha) if folded is None else folded
        fn_args = (adj, h, h0, W, *fn_args[4:])
    if batched and residuals is not None:
        raise ValueError("gcnii_stack_fwd: residual slabs are not taken "
                         "under vmap")
    if batched or train:
        return GCNIIStackTrain.apply(*fn_args)[0]
    return _forward(adj, h, h0, W, *args[4:], residuals=residuals, mode=mode,
                    variant=kvariant, last_drop_f32=last_drop_f32, **opts)


def fold_weights(W: Tensor, alpha: float) -> Tensor:
    """The non-variant layer weights W (..., nl, H, H) as the kernels take
    the variant's: ``[(1-α) W; α W]`` (..., nl, 2H, H), so that
    ``[hi | h0] @ W_cat = ((1-α) hi + α h0) @ W``.  Differentiable: the
    gradient of W is ``(1-α) dW_cat[:H] + α dW_cat[H:]``."""
    return torch.cat([(1.0 - alpha) * W, alpha * W], dim=-2)


def _rate_args(drop: bool, thresh, inv_keep, K: int, dev) -> tuple:
    """Kernels B's and D's rate arguments (thresh_k, inv_keep_k, thresh,
    inv_keep): a rate per configuration as (K,) device tensors, the keep
    thresholds (int32 holding the uint32 bits) and keep scales that the
    kernels read; a Python rate (one for all) by value."""
    if drop and isinstance(inv_keep, Tensor):
        return (thresh.to(dev, torch.int32).expand(K).contiguous(),
                inv_keep.to(dev, torch.float32).expand(K).contiguous(), 0,
                1.0)
    return (None, None, philox.threshold(thresh) if drop else 0,
            float(inv_keep))


def _forward(adj, h, h0, W, theta, lstm_ih, lstm_hh, lstm_b, *, alpha,
             reason, rate, seed, residuals, design=None, mode=F32,
             variant=True, last_drop_f32=False):
    """Kernel B on CUDA tensors (``design``: one of ``DESIGNS``' values;
    None: chosen by shape; the bf16 modes run the tiled design), the plain
    version on CPU tensors and inside ``ops.plain_ops()``.  A 4-d ``W``
    marks a config axis: one call for all K configurations.  ``variant``
    False (the bf16 scan mode only; the other modes take the fold): W is
    (nl, H, H)."""
    cfg_axis = W.dim() == 4
    scan = mode == SCAN
    popts = dict(alpha=alpha, reason=reason, seed=seed, mode=mode,
                 variant=variant, last_drop_f32=last_drop_f32)
    if h.device.type == "cpu" or _mode.plain:
        if not cfg_axis:
            return gcnii_stack_plain(adj, h, h0, W, theta, lstm_ih, lstm_hh,
                                     lstm_b, rate=rate, residuals=residuals,
                                     **popts)
        plain = lambda adj, h, h0, W, ih, hh, b, res, th, ik: \
            gcnii_stack_plain(adj, h, h0, W, theta, ih, hh, b,
                              rate=_rate_of(th, ik, rate), residuals=res,
                              **popts)
        return _mode.vmap_plain(plain, (adj, h, h0, W, lstm_ih, lstm_hh,
                                        lstm_b, residuals, *_rate_ops(rate)))
    *lead, B, N, H = h.shape
    K = lead[0] if cfg_axis else 1
    k = tuple(lead)
    nl = W.shape[-3]
    dev = h.device
    if H > 128:
        raise ValueError(f"gcnii_stack_fwd: hidden size {H} > 128")
    drop, thresh, inv_keep = _dropout_args(rate, seed)
    seed_ptr = _seed_ptr(seed, drop, dev)
    adj, h, h0, W = (t.contiguous() for t in (adj, h, h0, W))
    theta = theta.to(torch.float32).contiguous()
    expect = (("adj", adj, k + (B, N, N)), ("h", h, k + (B, N, H)),
              ("h0", h0, k + (B, N, H)),
              ("W", W, k + (nl, (2 if variant else 1) * H, H)),
              ("theta", theta, (nl,)))
    if reason:
        lstm_ih, lstm_hh, lstm_b = (
            t.contiguous() for t in (lstm_ih, lstm_hh, lstm_b))
        expect += (("lstm_ih", lstm_ih, k + (H, 4 * H)),
                   ("lstm_hh", lstm_hh, k + (H, 4 * H)),
                   ("lstm_b", lstm_b, k + (2,) * scan + (4 * H,)))
    if residuals is not None:
        names = residual_names(mode)
        if len(residuals) != len(names):
            raise ValueError(f"expected {len(names)} residual slabs, got "
                             f"{len(residuals)}")
        _check_all(tuple((f"residual {n}", r, k + (B, nl, N, H))
                         for n, r in zip(names, residuals)), dev,
                   torch.float32 if mode == F32 else torch.bfloat16)
        if not all(r.is_contiguous() for r in residuals):
            raise ValueError("residual slabs must be contiguous")
        res_ptrs = [r.data_ptr() for r in residuals] + [None] * (4 - len(
            residuals))
    else:
        res_ptrs = [None] * 4
    _check_all(expect, dev)
    if K * B == 0 or N == 0 or nl == 0:
        return to_bf16(h) if scan else h.clone()
    if mode != F32:
        if design not in (None, TILED):
            raise ValueError("gcnii_stack_fwd: the bf16 modes run the tiled "
                             "design only")
        design = TILED
        adj, h0, W = (to_bf16(t) for t in (adj, h0, W))
    if design is None:
        design = _design(K * B, N, _sm_count(dev), H)
    if scan:   # the carry, and the LSTM's weights and biases, in bf16
        h = to_bf16(h)
        if reason:
            lstm_ih, lstm_hh, lstm_b = (to_bf16(t) for t in (
                lstm_ih, lstm_hh, lstm_b))
    if not reason:      # never read by the kernels; any valid pointer will do
        lstm_ih = lstm_hh = lstm_b = wl = h
    elif design == ROWWISE:
        wl = h
    elif scan:
        wl = interleave_gates(lstm_ih, lstm_hh, lstm_b[..., 0, :],
                              lstm_b[..., 1, :]).contiguous()
    else:
        wl = interleave_gates(lstm_ih, lstm_hh, lstm_b).contiguous()
    out = torch.empty_like(h)
    # the tiled design's training mode keeps its state in the residual
    # slabs and needs hi only, the resident design none; the bf16 modes
    # their f32 carries as serving does, and beside them bf16(hi) and
    # bf16(h1) (the bf16 mode) or the gates' first product (4H wide, the
    # bf16 scan mode; see the C entry's note)
    if design == RESIDENT:
        n_scratch = 0
    elif mode != F32:
        n_scratch = 8 if scan else 6
    elif residuals is not None and design == TILED:
        n_scratch = 1
    else:
        n_scratch = 4
    scratch = torch.empty((n_scratch, K * B, N, H), device=dev)
    fn = _build.load("gcnii_fwd", "gcnii_fwd", _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    th_k, ik_k, th, ik = _rate_args(drop, thresh, inv_keep, K, dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    with annotate("ops.gcnii_fwd", K=K, B=B, N=N, layers=nl, design=design,
                  mode=mode):
        n = fn(ptr(adj), ptr(h), ptr(h0), ptr(W), ptr(theta), float(alpha),
               ptr(wl), ptr(lstm_ih), ptr(lstm_hh), ptr(lstm_b), ptr(out),
               ptr(scratch), *res_ptrs, int(drop), ptr(th_k), ptr(ik_k), th,
               ik, seed_ptr, int(reason), design, nl, K, B, N, H,
               _mode_bits(mode, variant, last_drop_f32), stream)
        _build.check(-n if n < 0 else 0, "gcnii_fwd launch")
    count(TC_PRODUCTS, tc_products(n, mode, design == TILED))
    gcnii_stack_fwd.launches += n
    return out


def gcnii_stack_bwd_plain(adj: Tensor, h0: Tensor, W: Tensor, theta: Tensor,
                          lstm_ih: Optional[Tensor], lstm_hh: Optional[Tensor],
                          lstm_b: Optional[Tensor],
                          residuals: Sequence[Tensor], dh_out: Tensor, *,
                          alpha: float, reason: bool, rate: float = 0.0,
                          seed: Optional[Tensor] = None,
                          relu_masks: Optional[Sequence[Tensor]] = None,
                          mode: str = F32,
                          relu_inputs: Optional[list] = None,
                          variant: bool = True,
                          last_drop_f32: bool = False):
    """Plain PyTorch version of :func:`gcnii_stack_bwd`: the reverse layer
    walk of ``_bwd_kernel`` (``mmdfn_tpu/ops/pallas_gcnii_train.py:183-394``,
    without the ``ablate`` paths), recomputing each layer from its pre-layer
    residuals h, lh, lc and redrawing its dropout bits.  In the bf16 mode
    the residuals are the bf16 slabs, adj, h0 and W are taken rounded to
    bf16, the recompute rounds where the forward does (``:236-271``), the
    gradient products stay f32 with hi and h1 unrounded (``:283-321``), and
    d_adj, d_h0 and dW come back rounded to bf16 (``:637-638``).

    ``relu_masks``, when given, are each layer's ReLU decisions (nlayers
    bool (B, N, H) tensors, True where the ReLU passes) in place of the
    recompute's ``pre > 0``: where ``pre`` lies within rounding of 0, two
    f32 recomputes in another summation order may decide either way, and a
    check holds a kernel against this version at the kernel's decisions.
    ``relu_inputs``, when given, gets each layer's (pre, gradient past the
    ReLU) in layer order, so that a check can tell where a kernel's
    decisions differ from ``pre > 0`` and matter.

    The bf16 scan mode is :func:`_scan_bwd_plain` (``variant`` and
    ``last_drop_f32`` are its own).

    Returns:
      (d_adj, d_h_entry, d_h0, dW, dW_ih, dW_hh, db): (B, N, N),
      (B, N, H) twice, (nlayers, 2H, H), (H, 4H) twice and (4H,) (the bf16
      scan mode: (2, 4H)); the LSTM gradients are zeros without
      ``reason``.
    """
    check_mode(mode)
    if mode == SCAN:
        return _scan_bwd_plain(adj, h0, W, theta, lstm_ih, lstm_hh, lstm_b,
                               residuals, dh_out, alpha=alpha, reason=reason,
                               rate=rate, seed=seed, relu_masks=relu_masks,
                               relu_inputs=relu_inputs, variant=variant,
                               last_drop_f32=last_drop_f32)
    bf16 = mode == BF16
    drop, thresh, inv_keep = _dropout_args(rate, seed)
    h_res, lh_res, lc_res = residuals[:3]
    rd = to_bf16 if bf16 else (lambda x: x)
    adj, h0, W = rd(adj), rd(h0), rd(W)
    B, N, H = h0.shape
    nl = W.shape[0]
    dh = dh_out
    dlh = torch.zeros_like(h0)
    dlc = torch.zeros_like(h0)
    dh0 = torch.zeros_like(h0)
    dadj = torch.zeros_like(adj)
    dW = torch.zeros_like(W)
    dih = h0.new_zeros(H, 4 * H)
    dhh = h0.new_zeros(H, 4 * H)
    dlb = h0.new_zeros(4 * H)
    rows = lambda x: x.reshape(-1, x.shape[-1])
    for l in range(nl - 1, -1, -1):
        h, lh, lc = (r[:, l].float() for r in (h_res, lh_res, lc_res))
        th = theta[l]
        if reason:
            h1, lc1, (i, f, gg, o) = _lstm_step(h, lh, lc, lstm_ih, lstm_hh,
                                                lstm_b)
        else:
            h1 = h
        hi = adj @ rd(h1)
        pre = th * (rd(hi) @ W[l, :H] + h0 @ W[l, H:]) \
            + (1.0 - th) * ((1.0 - alpha) * hi + alpha * h0)
        if drop:
            keep = _keep(seed, thresh, inv_keep, B, l, N, H)
            dh2 = torch.where(keep, dh * inv_keep, 0.0)
        else:
            dh2 = dh
        if relu_inputs is not None:
            relu_inputs.insert(0, (pre, dh2))
        passes = pre > 0.0 if relu_masks is None else relu_masks[l]
        dpre = torch.where(passes, dh2, 0.0)
        tdpre = th * dpre
        dW[l, :H] = rows(hi).t() @ rows(tdpre)
        dW[l, H:] = rows(h0).t() @ rows(tdpre)
        d_hi = tdpre @ W[l, :H].t() + (1.0 - th) * (1.0 - alpha) * dpre
        dh0 = dh0 + tdpre @ W[l, H:].t() + (1.0 - th) * alpha * dpre
        # hi = adj @ h1: the transposed contraction, not assumed symmetry
        d_h1 = adj.transpose(1, 2) @ d_hi
        dadj = dadj + d_hi @ h1.transpose(1, 2)
        if reason:
            tl = torch.tanh(lc1)
            dlh1 = d_h1 + dlh
            dlc1 = dlc + dlh1 * o * (1.0 - tl * tl)
            dgates = torch.cat([dlc1 * gg * i * (1.0 - i),
                                dlc1 * lc * f * (1.0 - f),
                                dlc1 * i * (1.0 - gg * gg),
                                dlh1 * tl * o * (1.0 - o)], dim=-1)
            dih = dih + rows(h).t() @ rows(dgates)
            dhh = dhh + rows(lh).t() @ rows(dgates)
            dlb = dlb + rows(dgates).sum(dim=0)
            dh = dh + dgates @ lstm_ih.t()     # the skip plus the LSTM input
            dlh = dgates @ lstm_hh.t()
            dlc = dlc1 * f
        else:
            dh = d_h1
    return rd(dadj), dh, rd(dh0), rd(dW), dih, dhh, dlb


def gcnii_stack_bwd(adj: Tensor, h0: Tensor, W: Tensor, theta: Tensor,
                    lstm_ih: Optional[Tensor], lstm_hh: Optional[Tensor],
                    lstm_b: Optional[Tensor], residuals: Sequence[Tensor],
                    dh_out: Tensor, *, alpha: float, reason: bool,
                    rate=0.0, seed: Optional[Tensor] = None,
                    mode: str = F32, variant: bool = True,
                    last_drop_f32: bool = False):
    """Kernel D: the gradients of the GCNII stack from the forward's
    residuals (``gcnii_stack_fwd(..., residuals=...)``) and the cotangent
    ``dh_out`` of its output; same contract as
    :func:`gcnii_stack_bwd_plain`, which CPU tensors and ``ops.plain_ops()``
    run instead.  One call into ``csrc/gcnii_bwd.cu`` runs the whole walk
    (7 tiled products a layer with reason, 5 without) and the
    weight-gradient sums (4 kernels, 2 without reason); ``launches`` counts
    those CUDA kernel launches.  With a config axis (every operand but
    theta and the seed led by K) it is one call, and each configuration's
    dW and LSTM gradients sum its own rows.  The bf16 mode reads the three
    bf16 residual slabs, recomputes each layer's LSTM step from them, and
    returns d_adj, d_h0 and dW rounded to bf16 (as f32 tensors).  The bf16
    scan mode reads the same slabs and computes :func:`_scan_bwd_plain`
    (8 products a layer with reason: the gates' two); ``variant`` False
    takes W (nl, H, H) unfolded.
    Where a caller has set ``kept`` on this function to a list, a kernel
    call appends to it its arguments as given (a tuple and a dict of the
    keyword arguments) and its (nlayers, K B, N, H) tdpre slab, theta
    times the gradient past the ReLU, zero where the ReLU was off (a check
    reads the kernel's ReLU decisions from it)."""
    check_mode(mode)
    cfg_axis = W.dim() == 4
    scan = mode == SCAN
    popts = dict(alpha=alpha, reason=reason, seed=seed, mode=mode,
                 variant=variant, last_drop_f32=last_drop_f32)
    if _mode.plain or h0.device.type == "cpu":
        if not cfg_axis:
            return gcnii_stack_bwd_plain(adj, h0, W, theta, lstm_ih,
                                         lstm_hh, lstm_b, residuals, dh_out,
                                         rate=rate, **popts)
        plain = lambda adj, h0, W, ih, hh, b, res, dh, th, ik: \
            gcnii_stack_bwd_plain(adj, h0, W, theta, ih, hh, b, res, dh,
                                  rate=_rate_of(th, ik, rate), **popts)
        return _mode.vmap_plain(plain, (adj, h0, W, lstm_ih, lstm_hh, lstm_b,
                                        list(residuals), dh_out,
                                        *_rate_ops(rate)))
    if h0.device.type != "cuda":
        raise ValueError(f"gcnii_stack_bwd: no kernel for {h0.device}")
    given = ((adj, h0, W, theta, lstm_ih, lstm_hh, lstm_b, list(residuals),
              dh_out), dict(rate=rate, **popts))
    *lead, B, N, H = h0.shape
    K = lead[0] if cfg_axis else 1
    k = tuple(lead)
    nl = W.shape[-3]
    dev = h0.device
    if H > 128:
        raise ValueError(f"gcnii_stack_bwd: hidden size {H} > 128")
    if not (variant or scan):
        raise ValueError("gcnii_stack_bwd: variant=False takes the fold "
                         "outside the bf16 scan mode")
    drop, thresh, inv_keep = _dropout_args(rate, seed)
    seed_ptr = _seed_ptr(seed, drop, dev)
    adj, h0, W, dh_out = (t.contiguous() for t in (adj, h0, W, dh_out))
    theta = theta.to(torch.float32).contiguous()
    WI = (2 if variant else 1) * H
    expect = [("adj", adj, k + (B, N, N)), ("h0", h0, k + (B, N, H)),
              ("W", W, k + (nl, WI, H)), ("theta", theta, (nl,)),
              ("dh_out", dh_out, k + (B, N, H))]
    names = residual_names(mode)
    if len(residuals) != len(names):
        raise ValueError(f"expected {len(names)} residual slabs, got "
                         f"{len(residuals)}")
    _check_all([(f"residual {n}", r, k + (B, nl, N, H))
                for n, r in zip(names, residuals)], dev,
               torch.float32 if mode == F32 else torch.bfloat16)
    if reason:
        lstm_ih, lstm_hh, lstm_b = (
            t.contiguous() for t in (lstm_ih, lstm_hh, lstm_b))
        expect += [("lstm_ih", lstm_ih, k + (H, 4 * H)),
                   ("lstm_hh", lstm_hh, k + (H, 4 * H)),
                   ("lstm_b", lstm_b, k + (2,) * scan + (4 * H,))]
    _check_all(expect, dev)
    residuals = [r.contiguous() for r in residuals]

    # [dW_ih; dW_hh; db] of each configuration
    dl = torch.zeros(*k, 2 * H + 1, 4 * H, device=dev)

    def lstm_grads():
        db = dl[..., 2 * H, :]
        return (dl[..., :H, :], dl[..., H:2 * H, :],
                torch.stack([db, db], dim=-2) if scan else db)
    if K * B == 0 or N == 0 or nl == 0:
        return (torch.zeros_like(adj), dh_out.clone(), torch.zeros_like(h0),
                torch.zeros_like(W), *lstm_grads())
    wl = h0          # never read outside the bf16 modes with reason
    if mode != F32:
        if scan and reason:
            lstm_ih, lstm_hh, lstm_b = (to_bf16(t) for t in (
                lstm_ih, lstm_hh, lstm_b))
            wl = interleave_gates(lstm_ih, lstm_hh, lstm_b[..., 0, :],
                                  lstm_b[..., 1, :]).contiguous()
        elif reason:   # P1's gate columns interleaved, as kernel B's F1
            wl = interleave_gates(lstm_ih, lstm_hh, lstm_b).contiguous()
        adj, h0, W = (to_bf16(t) for t in (adj, h0, W))
        # in res_h1's place: the layer's recomputed h1, then bf16(h1) and
        # bf16(hi) (the bf16 mode), or the gates' first product, 4H wide
        # (the bf16 scan mode)
        residuals = residuals + [torch.empty(5 if scan else 3, K * B, N, H,
                                             device=dev)]
    if not reason:   # never read by the kernels; any valid pointer will do
        lstm_ih = lstm_hh = lstm_b = h0
    R = B * N
    new = lambda *shape: torch.empty(shape, device=dev)
    # outputs and carries: every element is written before it is read
    dadj, dh, dlh, dlc, dh0 = (torch.empty_like(adj), *(
        torch.empty_like(h0) for _ in range(4)))
    dW = torch.empty_like(W)
    d_hi = torch.empty_like(h0)
    hi, tdpre = new(nl, K * B, N, H), new(nl, K * B, N, H)  # the walk's slabs
    gates = new(K * B, N, 4 * H) if reason else d_hi
    dgates = new(K * B, nl, N, 4 * H) if reason else d_hi
    splits_w, splits_l = gcnii_bwd_splits(R, nl)
    part_w = new(K, nl, splits_w, WI, H)
    if not reason:
        part_l = part_w
    elif scan:   # one partial sum a dialogue and layer, summed in order
        part_l = new(K * B * nl, 2 * H + 1, 4 * H)
    else:
        part_l = new(K, splits_l, 2 * H + 1, 4 * H)
    fn = _build.load("gcnii_bwd", "gcnii_bwd", _BWD_ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    th_k, ik_k, th, ik = _rate_args(drop, thresh, inv_keep, K, dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    with annotate("ops.gcnii_bwd", K=K, B=B, N=N, layers=nl, mode=mode):
        n = fn(ptr(adj), ptr(h0), ptr(W), ptr(theta), float(alpha),
               *map(ptr, residuals), ptr(lstm_ih), ptr(lstm_hh), ptr(lstm_b),
               ptr(dh_out), ptr(dh), ptr(dlh), ptr(dlc), ptr(d_hi), ptr(dh0),
               ptr(dadj), ptr(hi), ptr(tdpre), ptr(gates), ptr(dgates),
               ptr(part_w), ptr(part_l), ptr(dW), ptr(dl), int(drop),
               ptr(th_k), ptr(ik_k), th, ik, seed_ptr, int(reason), nl, K, B,
               N, H, splits_w, splits_l,
               _mode_bits(mode, variant, last_drop_f32), ptr(wl), stream)
        _build.check(-n if n < 0 else 0, "gcnii_bwd launch")
    count(TC_PRODUCTS, tc_products(n, mode, True, 1 + int(reason)))
    gcnii_stack_bwd.launches += n
    if gcnii_stack_bwd.kept is not None:
        gcnii_stack_bwd.kept.append((*given, tdpre))
    return (dadj, dh, dh0, dW, *lstm_grads())


def _rate_ops(rate):
    """A rate's (thresh, inv_keep) tensors as operands: a rate per
    configuration's own, (None, None) for a Python rate."""
    return (rate.thresh, rate.inv_keep) if hasattr(rate, "thresh") \
        else (None, None)


def _rate_of(thresh, inv_keep, rate):
    """The rate operands as the wrappers take the rate."""
    return rate if thresh is None else _Rate(thresh, inv_keep)


class GCNIIStackTrain(torch.autograd.Function):
    """The training stack: kernel B in training mode forward (residuals
    kept), kernel D backward; their plain versions on CPU tensors.  Its
    outputs are the stack's output and the four residual slabs (not
    differentiable); a rate per configuration comes as its ``thresh`` and
    ``inv_keep`` tensors (else None, and ``rate`` the Python rate).
    Under ``torch.func.vmap`` its rule makes one config-axis launch (with
    autograd off, of kernel B alone, and the slabs are None).  ``mode``
    selects the numerics; the bf16 modes' slabs are the three bf16 ones
    (the fourth output is then None); ``variant`` and ``last_drop_f32``
    are the bf16 scan mode's (the other modes take the fold)."""

    @staticmethod
    def forward(adj, h, h0, W, theta, lstm_ih, lstm_hh, lstm_b, thresh,
                inv_keep, seed, alpha, reason, rate, mode, variant,
                last_drop_f32):
        slab = (*h.shape[:-2], W.shape[-3], *h.shape[-2:])
        residuals = residual_slabs(slab, mode, h.device)
        if not reason:        # the kernel writes no LSTM state without it
            residuals[1].zero_()
            residuals[2].zero_()
        out = _forward(adj, h, h0, W, theta, lstm_ih, lstm_hh, lstm_b,
                       alpha=alpha, reason=reason,
                       rate=_rate_of(thresh, inv_keep, rate), seed=seed,
                       residuals=residuals, mode=mode, variant=variant,
                       last_drop_f32=last_drop_f32)
        return (out, *residuals, *(None,) * (len(RESIDUALS) - len(
            residuals)))

    @staticmethod
    def setup_context(ctx, inputs, output):
        (adj, h, h0, W, theta, lstm_ih, lstm_hh, lstm_b, thresh, inv_keep,
         seed, alpha, reason, rate, mode, variant, last_drop_f32) = inputs
        residuals = [r for r in output[1:] if r is not None]
        ctx.mark_non_differentiable(*residuals)
        ctx.save_for_backward(adj, h0, W, theta, lstm_ih, lstm_hh, lstm_b,
                              thresh, inv_keep, seed, *residuals)
        ctx.opts = dict(alpha=alpha, reason=reason, mode=mode,
                        variant=variant, last_drop_f32=last_drop_f32)
        ctx.rate = rate

    @staticmethod
    def backward(ctx, dh_out, *_):
        (adj, h0, W, theta, lstm_ih, lstm_hh, lstm_b, thresh, inv_keep, seed,
         *residuals) = ctx.saved_tensors
        dadj, dh, dh0, dW, dih, dhh, db = gcnii_stack_bwd(
            adj, h0, W, theta, lstm_ih, lstm_hh, lstm_b, residuals, dh_out,
            rate=_rate_of(thresh, inv_keep, ctx.rate), seed=seed, **ctx.opts)
        lstm = (dih, dhh, db) if ctx.opts["reason"] else (None,) * 3
        return (dadj, dh, dh0, dW, None, *lstm) + (None,) * 9

    @staticmethod
    def vmap(info, in_dims, *args):
        args = _mode.config_axis(info, in_dims, args, shared=(4, 10))
        if torch.is_grad_enabled():
            out = GCNIIStackTrain.apply(*args)
            return out, tuple(None if t is None else 0 for t in out)
        # serving: kernel B alone, which keeps no residuals
        (adj, h, h0, W, theta, lstm_ih, lstm_hh, lstm_b, thresh, inv_keep,
         seed, alpha, reason, rate, mode, variant, last_drop_f32) = args
        out = _forward(adj, h, h0, W, theta, lstm_ih, lstm_hh, lstm_b,
                       alpha=alpha, reason=reason,
                       rate=_rate_of(thresh, inv_keep, rate), seed=seed,
                       residuals=None, mode=mode, variant=variant,
                       last_drop_f32=last_drop_f32)
        return (out,) + (None,) * len(RESIDUALS), (0,) + (None,) * len(
            RESIDUALS)


gcnii_stack_fwd.launches = 0
gcnii_stack_bwd.launches = 0
gcnii_stack_bwd.kept = None
