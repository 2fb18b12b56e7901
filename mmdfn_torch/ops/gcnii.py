"""Kernels B and D: the GCNII stack (GCNII_lyc, variant=True) forward, with
a training mode, and backward.

Kernel B replaces ``mmdfn_tpu/ops/pallas_gcnii.py:gcnii_stack_fused`` and
``mmdfn_tpu/ops/pallas_gcnii_train.py:_stack_fwd``.  The CUDA kernel is
``csrc/gcnii_fwd.cu``, launched once per layer (plus one launch for layer
0's reason-LSTM step): each block owns 8 rows of one dialogue and computes
``adj[rows] @ h1``, both support products, the update, the skip and the
next layer's LSTM step itself; no cuBLAS call stands in for any of them.
In training mode it also draws the dropout after each layer's ReLU from
Philox (``csrc/philox.cuh``, key the step seed, counter (b, layer, node,
channel)) and writes the residuals the backward reads.  At serve shapes it
is bound by f32 operations (about 3.1 GFLOP at N = 600, 16 layers; see the
source note).

Kernel D replaces ``mmdfn_tpu/ops/pallas_gcnii_train.py:_stack_bwd``
(``csrc/gcnii_bwd.cu``): the reverse layer walk, the dropout bits drawn
again, and every gradient (adjacency, entry h, h0, the per-layer weights,
the reason-LSTM's weights) summed inside its kernels.

``gcnii_stack_fwd`` with autograd on goes through :class:`GCNIIStackTrain`
(kernel B in training mode, keeping the residuals; kernel D backward); with
autograd off it runs kernel B alone.  Each wrapper launches its kernels for
CUDA tensors and runs its plain version for CPU tensors; anything else
raises.  Inside ``ops.plain_ops()`` ``gcnii_stack_fwd`` runs the plain
forward and autograd differentiates it.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from mmdfn_torch.ops import _build, _mode, philox

Tensor = torch.Tensor

_p, _i, _f, _u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
# adj, h0, w1, w2, theta_l, alpha, h_in, h1_in, h_out, h1_out, lh, lc, ih,
# hh, lb, do_conv, do_lstm, reason, B, N, H, l_conv, l_lstm, nl, res_h,
# res_lh, res_lc, res_h1, drop, thresh, inv_keep, seed, stream
_ARGTYPES = ([_p] * 5 + [_f] + [_p] * 9 + [_i] * 9 + [_p] * 4
             + [_i, _u, _f, _p, _p])
# adj, h0, w, wt, theta_l, alpha, res_h, res_lh, res_lc, res_h1, ih, hh, lb,
# iht, hht, dh, dlh, dlc, d_hi, hih0, tdpre, xcat, dgates, dh0, dadj,
# part_w, part_l, drop, thresh, inv_keep, seed, reason, l, nl, B, N, H,
# stream
_BWD_ARGTYPES = ([_p] * 5 + [_f] + [_p] * 21 + [_i, _u, _f, _p]
                 + [_i] * 6 + [_p])
# part_w, part_l, R, nl, H, reason, dW, dl, stream
_FINISH_ARGTYPES = [_p, _p, _i, _i, _i, _i, _p, _p, _p]

# the residual slabs, each (B, nlayers, N, H): the pre-layer h, lh, lc of
# every layer and the layer's LSTM output h1
RESIDUALS = ("h", "lh", "lc", "h1")


def _dropout_args(rate: float, seed: Optional[Tensor]):
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} outside [0, 1)")
    if rate > 0.0 and seed is None:
        raise ValueError("dropout needs a seed tensor")
    return rate > 0.0, 1.0 / (1.0 - rate)


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
                      residuals: Optional[Sequence[Tensor]] = None) -> Tensor:
    """Plain PyTorch version of :func:`gcnii_stack_fwd` (same contract);
    differentiable by autograd.  The dropout mask comes from
    :mod:`mmdfn_torch.ops.philox`, bit-equal to the kernel's."""
    drop, inv_keep = _dropout_args(rate, seed)
    B, N, H = h.shape
    lh = torch.zeros_like(h)
    lc = torch.zeros_like(h)
    for l in range(W.shape[0]):
        q = h
        if residuals is not None:
            residuals[0][:, l] = h.detach()
            residuals[1][:, l] = lh.detach()
            residuals[2][:, l] = lc.detach()
        if reason:
            lh, lc, _ = _lstm_step(h, lh, lc, lstm_ih, lstm_hh, lstm_b)
            h = lh
        if residuals is not None:
            residuals[3][:, l] = h.detach()
        hi = adj @ h
        support = hi @ W[l, :H] + h0 @ W[l, H:]
        r = (1.0 - alpha) * hi + alpha * h0
        h = torch.relu(theta[l] * support + (1.0 - theta[l]) * r)
        if drop:
            keep = philox.keep_mask(seed, rate, B, l, N, H)
            h = torch.where(keep, h * inv_keep, 0.0)
        if reason:
            h = h + q
    return h


def _check_all(expect, dev) -> None:
    for name, t, shape in expect:
        if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) \
                or t.device != dev:
            raise ValueError(f"{name}: expected float32 {tuple(shape)} on "
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
                    reason: bool, rate: float = 0.0,
                    seed: Optional[Tensor] = None,
                    residuals: Optional[Sequence[Tensor]] = None) -> Tensor:
    """GCNII stack forward (deterministic at ``rate = 0``).

    Args:
      adj: (B, N, N) normalized adjacency; h: (B, N, H) loop-entry hidden;
      h0: (B, N, H) residual anchor; W: (nlayers, 2H, H); theta: (nlayers,);
      lstm_ih / lstm_hh: (H, 4H) reason-LSTM weights in the JAX orientation
      (a transposed view of torch's (4H, H) weights is copied contiguous,
      so that the kernel's weight reads coalesce);
      lstm_b: (4H,) = b_ih + b_hh.  The LSTM arguments are used iff reason.
      rate: dropout after each layer's ReLU; seed: the step's 64-bit seed,
        one int64 on the device (read by the kernel, never by the host).
      residuals: when given, the four (B, nlayers, N, H) slabs named by
        ``RESIDUALS``, filled in place for the backward.
    Returns:
      (B, N, H) final hidden state (rows of masked nodes are garbage).
      With autograd on (and no ``residuals`` asked for) it goes through
      :class:`GCNIIStackTrain`, so its gradients come from kernel D; inside
      ``ops.plain_ops()`` autograd differentiates the plain version.
    """
    args = (adj, h, h0, W, theta, lstm_ih, lstm_hh, lstm_b)
    opts = dict(alpha=alpha, reason=reason, rate=rate, seed=seed)
    if _mode.plain:
        return gcnii_stack_plain(*args, residuals=residuals, **opts)
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gcnii_stack_fwd: no kernel for {h.device}")
    if residuals is None and torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in args):
        return GCNIIStackTrain.apply(*args, alpha, reason, rate, seed)
    return _forward(*args, residuals=residuals, **opts)


def _forward(adj, h, h0, W, theta, lstm_ih, lstm_hh, lstm_b, *, alpha,
             reason, rate, seed, residuals):
    """Kernel B on CUDA tensors, the plain version on CPU tensors."""

    if h.device.type == "cpu":
        return gcnii_stack_plain(adj, h, h0, W, theta, lstm_ih, lstm_hh,
                                 lstm_b, alpha=alpha, reason=reason,
                                 rate=rate, seed=seed, residuals=residuals)
    B, N, H = h.shape
    nl = W.shape[0]
    dev = h.device
    if H > 128:
        raise ValueError(f"gcnii_stack_fwd: hidden size {H} > 128")
    drop, inv_keep = _dropout_args(rate, seed)
    seed_ptr = _seed_ptr(seed, drop, dev)
    adj, h, h0, W = (t.contiguous() for t in (adj, h, h0, W))
    theta = theta.to(torch.float32).contiguous()
    expect = (("adj", adj, (B, N, N)), ("h", h, (B, N, H)),
              ("h0", h0, (B, N, H)),
              ("W", W, (nl, 2 * H, H)), ("theta", theta, (nl,)))
    if reason:
        lstm_ih, lstm_hh, lstm_b = (
            t.contiguous() for t in (lstm_ih, lstm_hh, lstm_b))
        expect += (("lstm_ih", lstm_ih, (H, 4 * H)),
                   ("lstm_hh", lstm_hh, (H, 4 * H)),
                   ("lstm_b", lstm_b, (4 * H,)))
    else:   # never read by the kernel; any valid pointer will do
        lstm_ih = lstm_hh = lstm_b = h
    if residuals is not None:
        expect += tuple((f"residual {n}", r, (B, nl, N, H))
                        for n, r in zip(RESIDUALS, residuals))
        if not all(r.is_contiguous() for r in residuals):
            raise ValueError("residual slabs must be contiguous")
        res_ptrs = [r.data_ptr() for r in residuals]
    else:
        res_ptrs = [None] * 4
    _check_all(expect, dev)

    out = h.clone()            # layer input / output, updated row-locally
    if B == 0 or N == 0 or nl == 0:
        return out
    lh = torch.zeros_like(h)
    lc = torch.zeros_like(h)
    # h1 (the operand of adj @ h1) is read by every block, so it ping-pongs
    bufs = (torch.empty_like(h), torch.empty_like(h))
    fn = _build.load("gcnii_fwd", "gcnii_layer", _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    layer = 2 * H * H * W.element_size()
    thresh = philox.threshold(rate) if drop else 0

    def launch(l, h1_in, h1_out, do_conv, do_lstm):
        w1 = W.data_ptr() + max(l, 0) * layer
        err = fn(adj.data_ptr(), h0.data_ptr(), w1, w1 + layer // 2,
                 theta.data_ptr() + max(l, 0) * 4, float(alpha),
                 out.data_ptr(), h1_in.data_ptr(), out.data_ptr(),
                 h1_out.data_ptr(), lh.data_ptr(), lc.data_ptr(),
                 lstm_ih.data_ptr(), lstm_hh.data_ptr(), lstm_b.data_ptr(),
                 int(do_conv), int(do_lstm), int(reason), B, N, H, max(l, 0),
                 l + 1, nl, *res_ptrs, int(drop), thresh, float(inv_keep),
                 seed_ptr, stream)
        _build.check(err, "gcnii_layer launch")
        gcnii_stack_fwd.launches += 1

    if reason:     # layer 0's LSTM step: h1_0 into bufs[0]
        launch(-1, bufs[0], bufs[0], False, True)
        h1_src = bufs[0]
    else:          # h1_0 = h, read-only here (out is written in place)
        h1_src = h
    for l in range(nl):
        h1_dst = bufs[(l + 1) % 2]
        launch(l, h1_src, h1_dst, True, reason and l + 1 < nl)
        h1_src = h1_dst
    return out


def gcnii_stack_bwd_plain(adj: Tensor, h0: Tensor, W: Tensor, theta: Tensor,
                          lstm_ih: Optional[Tensor], lstm_hh: Optional[Tensor],
                          lstm_b: Optional[Tensor],
                          residuals: Sequence[Tensor], dh_out: Tensor, *,
                          alpha: float, reason: bool, rate: float = 0.0,
                          seed: Optional[Tensor] = None):
    """Plain PyTorch version of :func:`gcnii_stack_bwd`: the reverse layer
    walk of ``_bwd_kernel`` (``mmdfn_tpu/ops/pallas_gcnii_train.py:183-394``,
    without the ``ablate`` paths), recomputing each layer from its pre-layer
    residuals h, lh, lc and redrawing its dropout bits.

    Returns:
      (d_adj, d_h_entry, d_h0, dW, dW_ih, dW_hh, db): (B, N, N),
      (B, N, H) twice, (nlayers, 2H, H), (H, 4H) twice and (4H,); the LSTM
      gradients are zeros without ``reason``.
    """
    drop, inv_keep = _dropout_args(rate, seed)
    h_res, lh_res, lc_res = residuals[:3]
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
        h, lh, lc = h_res[:, l], lh_res[:, l], lc_res[:, l]
        th = theta[l]
        if reason:
            h1, lc1, (i, f, gg, o) = _lstm_step(h, lh, lc, lstm_ih, lstm_hh,
                                                lstm_b)
        else:
            h1 = h
        hi = adj @ h1
        pre = th * (hi @ W[l, :H] + h0 @ W[l, H:]) \
            + (1.0 - th) * ((1.0 - alpha) * hi + alpha * h0)
        if drop:
            keep = philox.keep_mask(seed, rate, B, l, N, H)
            dh2 = torch.where(keep, dh * inv_keep, 0.0)
        else:
            dh2 = dh
        dpre = torch.where(pre > 0.0, dh2, 0.0)
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
    return dadj, dh, dh0, dW, dih, dhh, dlb


def gcnii_stack_bwd(adj: Tensor, h0: Tensor, W: Tensor, theta: Tensor,
                    lstm_ih: Optional[Tensor], lstm_hh: Optional[Tensor],
                    lstm_b: Optional[Tensor], residuals: Sequence[Tensor],
                    dh_out: Tensor, *, alpha: float, reason: bool,
                    rate: float = 0.0, seed: Optional[Tensor] = None):
    """Kernel D: the gradients of the GCNII stack from the forward's
    residuals (``gcnii_stack_fwd(..., residuals=...)``) and the cotangent
    ``dh_out`` of its output; same contract as
    :func:`gcnii_stack_bwd_plain`, which CPU tensors and ``ops.plain_ops()``
    run instead.  One launch per layer (kernels X, Y and the weight-gradient
    sums) and one that sums the weight-gradient partials."""
    if _mode.plain or h0.device.type == "cpu":
        return gcnii_stack_bwd_plain(adj, h0, W, theta, lstm_ih, lstm_hh,
                                     lstm_b, residuals, dh_out, alpha=alpha,
                                     reason=reason, rate=rate, seed=seed)
    if h0.device.type != "cuda":
        raise ValueError(f"gcnii_stack_bwd: no kernel for {h0.device}")
    B, N, H = h0.shape
    nl = W.shape[0]
    dev = h0.device
    if H > 128:
        raise ValueError(f"gcnii_stack_bwd: hidden size {H} > 128")
    drop, inv_keep = _dropout_args(rate, seed)
    seed_ptr = _seed_ptr(seed, drop, dev)
    adj, h0, W, dh_out = (t.contiguous() for t in (adj, h0, W, dh_out))
    theta = theta.to(torch.float32).contiguous()
    expect = [("adj", adj, (B, N, N)), ("h0", h0, (B, N, H)),
              ("W", W, (nl, 2 * H, H)), ("theta", theta, (nl,)),
              ("dh_out", dh_out, (B, N, H))]
    expect += [(f"residual {n}", r, (B, nl, N, H))
               for n, r in zip(RESIDUALS, residuals)]
    if reason:
        lstm_ih, lstm_hh, lstm_b = (
            t.contiguous() for t in (lstm_ih, lstm_hh, lstm_b))
        expect += [("lstm_ih", lstm_ih, (H, 4 * H)),
                   ("lstm_hh", lstm_hh, (H, 4 * H)),
                   ("lstm_b", lstm_b, (4 * H,))]
    _check_all(expect, dev)
    residuals = [r.contiguous() for r in residuals]

    dadj = torch.zeros_like(adj)
    dh = dh_out.clone()                    # carry: d(layer output)
    dlh = torch.zeros_like(h0)
    dlc = torch.zeros_like(h0)
    dh0 = torch.zeros_like(h0)
    dW = torch.empty_like(W)
    dl = torch.zeros(2 * H + 1, 4 * H, device=dev)   # [dW_ih; dW_hh; db]
    if B == 0 or N == 0 or nl == 0:
        return (dadj, dh, dh0, dW.zero_(), dl[:H], dl[H:2 * H], dl[2 * H])
    R = B * N
    splits = _build.load("gcnii_bwd", "gcnii_bwd_splits", [_i])(R)
    # the transposed weights, contiguous, for the input-gradient products
    WT = W.transpose(1, 2).contiguous()
    if reason:
        iht, hht = lstm_ih.t().contiguous(), lstm_hh.t().contiguous()
    else:   # never read by the kernels; any valid pointer will do
        lstm_ih = lstm_hh = lstm_b = iht = hht = h0
    d_hi = torch.empty_like(h0)
    tdpre = torch.empty_like(h0)
    hih0 = torch.empty(R, 2 * H, device=dev)
    xcat = torch.empty(R, 2 * H + 1, device=dev) if reason else hih0
    dgates = torch.empty(R, 4 * H, device=dev) if reason else hih0
    part_w = torch.empty(nl, splits, 2 * H, H, device=dev)
    part_l = (torch.empty(splits, 2 * H + 1, 4 * H, device=dev) if reason
              else part_w)
    fn = _build.load("gcnii_bwd", "gcnii_bwd_layer", _BWD_ARGTYPES)
    finish = _build.load("gcnii_bwd", "gcnii_bwd_finish", _FINISH_ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    thresh = philox.threshold(rate) if drop else 0
    wl = W.stride(0) * W.element_size()
    pl_w = part_w.stride(0) * part_w.element_size()
    ptr = lambda t: t.data_ptr()
    for l in range(nl - 1, -1, -1):
        err = fn(ptr(adj), ptr(h0), ptr(W) + l * wl, ptr(WT) + l * wl,
                 ptr(theta) + l * 4, float(alpha), *map(ptr, residuals),
                 ptr(lstm_ih), ptr(lstm_hh), ptr(lstm_b), ptr(iht), ptr(hht),
                 ptr(dh), ptr(dlh), ptr(dlc), ptr(d_hi), ptr(hih0),
                 ptr(tdpre), ptr(xcat), ptr(dgates), ptr(dh0), ptr(dadj),
                 ptr(part_w) + l * pl_w, ptr(part_l), int(drop), thresh,
                 float(inv_keep), seed_ptr, int(reason), l, nl, B, N, H,
                 stream)
        _build.check(err, "gcnii_bwd_layer launch")
        gcnii_stack_bwd.launches += 1
    err = finish(ptr(part_w), ptr(part_l), R, nl, H, int(reason), ptr(dW),
                 ptr(dl), stream)
    _build.check(err, "gcnii_bwd_finish launch")
    gcnii_stack_bwd.launches += 1
    return dadj, dh, dh0, dW, dl[:H], dl[H:2 * H], dl[2 * H]


class GCNIIStackTrain(torch.autograd.Function):
    """The training stack: kernel B in training mode forward (residuals
    kept), kernel D backward; their plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, adj, h, h0, W, theta, lstm_ih, lstm_hh, lstm_b, alpha,
                reason, rate, seed):
        B, N, H = h.shape
        slab = (B, W.shape[0], N, H)
        residuals = [torch.empty(slab, device=h.device) for _ in RESIDUALS]
        if not reason:        # the kernel writes no LSTM state without it
            residuals[1].zero_()
            residuals[2].zero_()
        out = _forward(adj, h, h0, W, theta, lstm_ih, lstm_hh, lstm_b,
                       alpha=alpha, reason=reason, rate=rate, seed=seed,
                       residuals=residuals)
        ctx.save_for_backward(adj, h0, W, theta, lstm_ih, lstm_hh, lstm_b,
                              seed, *residuals)
        ctx.opts = dict(alpha=alpha, reason=reason, rate=rate)
        return out

    @staticmethod
    def backward(ctx, dh_out):
        (adj, h0, W, theta, lstm_ih, lstm_hh, lstm_b, seed,
         *residuals) = ctx.saved_tensors
        dadj, dh, dh0, dW, dih, dhh, db = gcnii_stack_bwd(
            adj, h0, W, theta, lstm_ih, lstm_hh, lstm_b, residuals, dh_out,
            seed=seed, **ctx.opts)
        lstm = (dih, dhh, db) if ctx.opts["reason"] else (None,) * 3
        return (dadj, dh, dh0, dW, None, *lstm, None, None, None, None)


gcnii_stack_fwd.launches = 0
gcnii_stack_bwd.launches = 0
