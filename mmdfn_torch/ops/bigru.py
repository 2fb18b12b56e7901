"""Kernels A and C: one masked bidirectional GRU layer's hidden recurrence,
forward and backward.

Kernel A replaces ``mmdfn_tpu/ops/pallas_rnn.py:_bigru_fwd`` (the forward
of ``fused_bigru_layer``).  The CUDA kernel is ``csrc/bigru_fwd.cu``: one
block per (direction, tile of BT batch rows, BT from
:func:`_rows_per_block`), the time loop inside the kernel, W_hh in
registers, h double-buffered in shared memory with one barrier per step,
and xg fetched ahead.  It is bound by the latency of L dependent steps, not
by bytes or FLOPs (see the source note).  In training mode it also writes
``hg = h_prev @ W_hh + b_hh`` per step for the backward.

Kernel C replaces ``mmdfn_tpu/ops/pallas_rnn.py:_bigru_bwd``: the reverse
walk of each direction from the saved ``hg``, ``dxg`` per step (zero at
masked frames), then ``dW_hh``/``db_hh`` summed over batch and time by a
second kernel after the loop (``csrc/bigru_bwd.cu``).

``bigru_layer_fwd`` with autograd on goes through :class:`BiGRULayer`, whose
forward is kernel A's training mode and whose backward is
``bigru_layer_bwd``; with autograd off it runs the serve forward.  Each
wrapper launches its kernel for CUDA tensors and runs its plain version for
CPU tensors; anything else raises.  Inside ``ops.plain_ops()``
``bigru_layer_fwd`` runs the plain forward and autograd differentiates it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from mmdfn_torch.ops import _build, _mode

Tensor = torch.Tensor

_p, _i64, _i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# xg_f, xg_b, w_f, b_f, w_b, b_b, the two weights' strides, mask, ys_f,
# ys_b, hg_f, hg_b (null in serve mode), B, L, H, BT, stream
_ARGTYPES = [_p] * 6 + [_i64] * 4 + [_p] * 5 + [_i32] * 4 + [_p]
# xg_f, xg_b, hg_f, hg_b, w_f, w_b, the two weights' strides, mask, ys_f,
# ys_b, dy_f, dy_b, dxg_f, dxg_b, dhg_f, dhg_b, partials, dwb, B, L, H, BT,
# split_rows, stream
_BWD_ARGTYPES = [_p] * 6 + [_i64] * 4 + [_p] * 11 + [_i32] * 5 + [_p]
_KERNEL_H = 100      # the only hidden width the kernels take (the port's)
_SPLIT_ROWS = 256    # rows of B L per split of kernel C's dW_hh product


def _rows_per_block(B: int, sms: int) -> int:
    """Batch rows per block of kernels A and C: the fewest of 1, 2, 4 for
    which both directions' blocks fit on a card of ``sms`` multiprocessors
    in one wave (one block per SM); 4 beyond that."""
    for bt in (1, 2):
        if 2 * -(-B // bt) <= sms:
            return bt
    return 4


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _gru_gates(xg_t: Tensor, hg: Tensor, h: Tensor) -> Tensor:
    """Torch GRU gate math (r, z, n) from the two projections."""
    xr, xz, xn = xg_t.chunk(3, dim=-1)
    hr, hz, hn = hg.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h


def bigru_layer_plain(xg_f: Tensor, xg_b: Tensor, w_hh_f: Tensor,
                      b_hh_f: Tensor, w_hh_b: Tensor, b_hh_b: Tensor,
                      mask: Tensor, with_hg: bool = False) -> Tuple[Tensor, ...]:
    """Plain PyTorch version of :func:`bigru_layer_fwd` (same contract).

    With ``with_hg`` it returns ``(ys_f, ys_b, hg_f, hg_b)``: hg (B, L, 3H)
    is ``h_prev @ W_hh + b_hh`` of each step, as kernel A's training mode
    writes it."""
    B, L, G = xg_f.shape
    H = G // 3
    gate = mask > 0
    outs, hgs = [], []
    for xg, w, b, steps in ((xg_f, w_hh_f, b_hh_f, range(L)),
                            (xg_b, w_hh_b, b_hh_b, range(L - 1, -1, -1))):
        h = xg.new_zeros(B, H)
        ys, hg = [None] * L, [None] * L
        for t in steps:
            hg[t] = h @ w + b
            h_new = _gru_gates(xg[:, t], hg[t], h)
            # select, never multiply: a non-finite value in a masked frame
            # must not reach the carry (0 * inf would be NaN)
            h = torch.where(gate[:, t, None], h_new, h)
            ys[t] = h
        outs.append(torch.stack(ys, dim=1) if L else xg.new_empty(B, 0, H))
        if with_hg:
            hgs.append(torch.stack(hg, dim=1) if L else xg.new_empty(B, 0, G))
    return (*outs, *hgs)


def bigru_layer_bwd_plain(xg_f: Tensor, xg_b: Tensor, w_hh_f: Tensor,
                          b_hh_f: Tensor, w_hh_b: Tensor, b_hh_b: Tensor,
                          mask: Tensor, ys_f: Tensor, ys_b: Tensor,
                          dy_f: Tensor, dy_b: Tensor,
                          hg_f: Optional[Tensor] = None,
                          hg_b: Optional[Tensor] = None):
    """Plain PyTorch version of :func:`bigru_layer_bwd`: the explicit time
    loop of ``_bwd_kernel`` (``mmdfn_tpu/ops/pallas_rnn.py:127-209``).

    Each direction walks its forward walk backwards; ``h_prev`` is the
    walk-order shifted output (``ys_f[t-1]`` forward, ``ys_b[t+1]``
    backward, zero at the walk's start), and the gates are recomputed from
    it, or taken from the forward's ``hg_f``/``hg_b`` (B, L, 3H) where
    given.  Masked frames are selected away, never multiplied, so a
    non-finite value there reaches no gradient.

    Returns:
      (dxg_f, dxg_b, dW_hh_f, db_hh_f, dW_hh_b, db_hh_b), float32, dW in
      the JAX orientation (H, 3H).
    """
    B, L, G = xg_f.shape
    H = G // 3
    gate = (mask > 0)[..., None]
    out = []
    for xg, w, b, ys, dy, hgs, walk, shift in (
            (xg_f, w_hh_f, b_hh_f, ys_f, dy_f, hg_f, range(L - 1, -1, -1), -1),
            (xg_b, w_hh_b, b_hh_b, ys_b, dy_b, hg_b, range(L), 1)):
        zero = xg.new_zeros(B, H)
        dh = xg.new_zeros(B, H)
        dxg = xg.new_zeros(B, L, G)
        dw = torch.zeros_like(w)
        db = torch.zeros_like(b)
        for t in walk:
            tp = t + shift
            h_prev = ys[:, tp] if 0 <= tp < L else zero
            dh = dh + dy[:, t]
            m = gate[:, t]
            hg = h_prev @ w + b if hgs is None else hgs[:, t]
            xr, xz, xn = xg[:, t].chunk(3, dim=-1)
            hr, hz, hn = hg.chunk(3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            dh_eff = torch.where(m, dh, 0.0)
            dz = dh_eff * (h_prev - n) * z * (1.0 - z)
            dn = dh_eff * (1.0 - z) * (1.0 - n * n)
            dr = dn * hn * r * (1.0 - r)
            dhg = torch.where(m, torch.cat([dr, dz, dn * r], dim=-1), 0.0)
            dxg[:, t] = torch.where(m, torch.cat([dr, dz, dn], dim=-1), 0.0)
            dh = torch.where(m, dh_eff * z + dhg @ w.t(), dh)
            dw = dw + h_prev.t() @ dhg
            db = db + dhg.sum(dim=0)
        out.append((dxg, dw, db))
    (dxg_f, dw_f, db_f), (dxg_b, dw_b, db_b) = out
    return dxg_f, dxg_b, dw_f, db_f, dw_b, db_b


def _check(name: str, t: Tensor, shape, device) -> None:
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) \
            or t.device != device:
        raise ValueError(f"{name}: expected float32 {tuple(shape)} on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def _aligned(t: Tensor) -> Tensor:
    """Contiguous, and 16-byte aligned for the kernels' cp.async copies."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _prepare(xg_f, xg_b, w_hh_f, b_hh_f, w_hh_b, b_hh_b, mask, more=()):
    """Aligned contiguous f32 operands on one CUDA device, shapes checked;
    the hidden weights keep their strides (the kernels take them).  ``more``
    holds (name, tensor, width) operands of shape (B, L, width)."""
    B, L, G = xg_f.shape
    H = G // 3
    dev = xg_f.device
    if dev.type != "cuda":
        raise ValueError(f"bi-GRU kernels: no kernel for {dev}")
    if H != _KERNEL_H:
        raise ValueError(f"bi-GRU kernels take H = {_KERNEL_H}, got {H}")
    xg_f, xg_b, b_hh_f, b_hh_b = map(_aligned, (xg_f, xg_b, b_hh_f, b_hh_b))
    mask = _aligned(mask.to(torch.float32))
    more = tuple((name, _aligned(t), width) for name, t, width in more)
    for name, t, shape in (("xg_f", xg_f, (B, L, G)), ("xg_b", xg_b, (B, L, G)),
                           ("w_hh_f", w_hh_f, (H, G)), ("w_hh_b", w_hh_b, (H, G)),
                           ("b_hh_f", b_hh_f, (G,)), ("b_hh_b", b_hh_b, (G,)),
                           ("mask", mask, (B, L)),
                           *((name, t, (B, L, width))
                             for name, t, width in more)):
        _check(name, t, shape, dev)
    return (xg_f, xg_b, w_hh_f, b_hh_f, w_hh_b, b_hh_b, mask) \
        + tuple(t for _, t, _ in more)


def _forward(xg_f, xg_b, w_hh_f, b_hh_f, w_hh_b, b_hh_b, mask,
             with_hg: bool = False):
    """Kernel A on CUDA tensors, the plain version on CPU tensors.  With
    ``with_hg`` (training mode) it also returns hg_f, hg_b (B, L, 3H) for
    kernel C."""
    if xg_f.device.type == "cpu":
        return bigru_layer_plain(xg_f, xg_b, w_hh_f, b_hh_f, w_hh_b, b_hh_b,
                                 mask, with_hg=with_hg)
    xg_f, xg_b, w_hh_f, b_hh_f, w_hh_b, b_hh_b, mask = _prepare(
        xg_f, xg_b, w_hh_f, b_hh_f, w_hh_b, b_hh_b, mask)
    B, L, G = xg_f.shape
    H = G // 3
    dev = xg_f.device
    ys_f = torch.empty(B, L, H, device=dev)
    ys_b = torch.empty(B, L, H, device=dev)
    hgs = (torch.empty(B, L, G, device=dev),
           torch.empty(B, L, G, device=dev)) if with_hg else ()
    if B == 0 or L == 0:
        return (ys_f, ys_b, *hgs)
    fn = _build.load("bigru_fwd", "bigru_fwd", _ARGTYPES)
    hg_ptrs = [t.data_ptr() for t in hgs] if with_hg else [None, None]
    err = fn(xg_f.data_ptr(), xg_b.data_ptr(), w_hh_f.data_ptr(),
             b_hh_f.data_ptr(), w_hh_b.data_ptr(), b_hh_b.data_ptr(),
             *w_hh_f.stride(), *w_hh_b.stride(), mask.data_ptr(),
             ys_f.data_ptr(), ys_b.data_ptr(), *hg_ptrs, B, L, H,
             _rows_per_block(B, _sm_count(dev)),
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "bigru_fwd launch")
    bigru_layer_fwd.launches += 1
    return (ys_f, ys_b, *hgs)


def bigru_layer_bwd(xg_f: Tensor, xg_b: Tensor, w_hh_f: Tensor,
                    b_hh_f: Tensor, w_hh_b: Tensor, b_hh_b: Tensor,
                    mask: Tensor, ys_f: Tensor, ys_b: Tensor, dy_f: Tensor,
                    dy_b: Tensor, hg_f: Optional[Tensor] = None,
                    hg_b: Optional[Tensor] = None):
    """Kernel C: the gradients of one bi-GRU layer's recurrence.

    Takes the forward's operands (as :func:`bigru_layer_fwd`), its outputs
    ``ys_f``/``ys_b``, their cotangents ``dy_f``/``dy_b`` (B, L, H) and the
    ``hg_f``/``hg_b`` (B, L, 3H) that kernel A's training mode wrote, which
    the kernel needs.  Returns (dxg_f, dxg_b, dW_hh_f, db_hh_f, dW_hh_b,
    db_hh_b) as :func:`bigru_layer_bwd_plain` does, which CPU tensors and
    ``ops.plain_ops()`` run instead (there hg may be None: recomputed).
    """
    if _mode.plain or xg_f.device.type == "cpu":
        return bigru_layer_bwd_plain(xg_f, xg_b, w_hh_f, b_hh_f, w_hh_b,
                                     b_hh_b, mask, ys_f, ys_b, dy_f, dy_b,
                                     hg_f, hg_b)
    if hg_f is None or hg_b is None:
        raise ValueError("bigru_layer_bwd: kernel C needs the hg that kernel "
                         "A's training mode writes")
    B, L, G = xg_f.shape
    H = G // 3
    (xg_f, xg_b, w_hh_f, b_hh_f, w_hh_b, b_hh_b, mask, ys_f, ys_b, dy_f,
     dy_b, hg_f, hg_b) = _prepare(
        xg_f, xg_b, w_hh_f, b_hh_f, w_hh_b, b_hh_b, mask,
        (("ys_f", ys_f, H), ("ys_b", ys_b, H), ("dy_f", dy_f, H),
         ("dy_b", dy_b, H), ("hg_f", hg_f, G), ("hg_b", hg_b, G)))
    dev = xg_f.device
    dxg_f = torch.empty(B, L, G, device=dev)
    dxg_b = torch.empty(B, L, G, device=dev)
    # [dW_hh; db_hh] of each direction
    dwb = torch.empty(2, H + 1, G, device=dev)
    grads = (dxg_f, dxg_b, dwb[0, :H], dwb[0, H], dwb[1, :H], dwb[1, H])
    if B == 0 or L == 0:
        for t in (dxg_f, dxg_b, dwb):
            t.zero_()
        return grads
    # each step's dhg, and the dW_hh product's partials over row splits
    dhg = torch.empty(2, B, L, G, device=dev)
    splits = -(-B * L // _SPLIT_ROWS)
    partials = torch.empty(2, splits, H + 1, G, device=dev)
    fn = _build.load("bigru_bwd", "bigru_bwd", _BWD_ARGTYPES)
    err = fn(xg_f.data_ptr(), xg_b.data_ptr(), hg_f.data_ptr(),
             hg_b.data_ptr(), w_hh_f.data_ptr(), w_hh_b.data_ptr(),
             *w_hh_f.stride(), *w_hh_b.stride(), mask.data_ptr(),
             ys_f.data_ptr(), ys_b.data_ptr(), dy_f.data_ptr(),
             dy_b.data_ptr(), dxg_f.data_ptr(), dxg_b.data_ptr(),
             dhg[0].data_ptr(), dhg[1].data_ptr(), partials.data_ptr(),
             dwb.data_ptr(), B, L, H, _rows_per_block(B, _sm_count(dev)),
             _SPLIT_ROWS,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "bigru_bwd launch")
    bigru_layer_bwd.launches += 1
    return grads


class BiGRULayer(torch.autograd.Function):
    """One bi-GRU layer's recurrence with kernel A forward (training mode)
    and kernel C backward (their plain versions on CPU tensors).  Saves what
    ``_bigru_bwd`` needs: xg, mask, W_hh, b_hh, the outputs, and the gate
    pre-activations hg, so the backward recomputes nothing."""

    @staticmethod
    def forward(ctx, xg_f, xg_b, w_hh_f, b_hh_f, w_hh_b, b_hh_b, mask):
        ys_f, ys_b, hg_f, hg_b = _forward(xg_f, xg_b, w_hh_f, b_hh_f, w_hh_b,
                                          b_hh_b, mask, with_hg=True)
        ctx.save_for_backward(xg_f, xg_b, w_hh_f, b_hh_f, w_hh_b, b_hh_b,
                              mask, ys_f, ys_b, hg_f, hg_b)
        return ys_f, ys_b

    @staticmethod
    def backward(ctx, dy_f, dy_b):
        saved = ctx.saved_tensors
        ys_f = saved[7]
        dy_f = torch.zeros_like(ys_f) if dy_f is None else dy_f
        dy_b = torch.zeros_like(ys_f) if dy_b is None else dy_b
        grads = bigru_layer_bwd(*saved[:9], dy_f, dy_b, *saved[9:])
        return (*grads, None)


def bigru_layer_fwd(xg_f: Tensor, xg_b: Tensor, w_hh_f: Tensor,
                    b_hh_f: Tensor, w_hh_b: Tensor, b_hh_b: Tensor,
                    mask: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """One masked bi-GRU layer's recurrence, both directions.

    Args:
      xg_f / xg_b: (B, L, 3H) ``x @ W_ih + b_ih`` per direction, both in
        natural time order (the backward direction is walked in reverse).
      w_hh_f / w_hh_b: (H, 3H) hidden weights in the JAX orientation (a
        transposed view of torch's (3H, H) ``weight_hh`` is taken as is).
      b_hh_f / b_hh_b: (3H,).
      mask: (B, L) recurrence gate, need not be a prefix; None = all frames.
    Returns:
      (ys_f, ys_b): (B, L, H) float32; a masked frame holds the carried
      state.  With autograd on, their gradients come from kernel C.
    """
    B, L, G = xg_f.shape
    if mask is None:
        mask = xg_f.new_ones(B, L)
    args = (xg_f, xg_b, w_hh_f, b_hh_f, w_hh_b, b_hh_b, mask)
    if _mode.plain:
        return bigru_layer_plain(*args)
    if xg_f.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bigru_layer_fwd: no kernel for {xg_f.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return BiGRULayer.apply(*args)
    return _forward(*args)


bigru_layer_fwd.launches = 0
bigru_layer_bwd.launches = 0
