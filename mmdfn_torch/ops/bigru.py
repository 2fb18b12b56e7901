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

Both kernels take a leading config axis (the grouped sweep's K stacked
configurations, ``train/vmap_sweep.py``): xg (K, B, L, 3H), W_hh (K, H,
3H), b_hh (K, 3H), the mask (B, L) shared.  A block then walks rows of
one configuration only (grid z = the configuration), and kernel C sums
each configuration's dW_hh / db_hh over its own rows.  Under
``torch.func.vmap`` the two Functions' ``vmap`` rules move the config axis
to the front and make that one launch, which autograd records, so the
backward is one config-axis launch of kernel C; on CPU tensors the
config-axis call is the plain version under ``vmap``.

The numerics are one of three modes (``mode``, named as in
``ops/gcnii.py``).  ``'f32'`` is the JAX package's parity default.
``'bf16'`` is ``rnn_backend='pallas'`` under ``rnn_compute_dtype=
'bfloat16'`` (``mmdfn_tpu/nn/rnn.py:280-317``): the f32 mode on operands
rounded to bf16 (JAX widens them, ``ops/pallas_rnn.py:412-423``), its
outputs rounded to bf16; the casts' autograd transposes round kernel C's
gradients as JAX's do.  ``'bf16_scan'`` is JAX's bf16 ``_gru_scan``
(``mmdfn_tpu/nn/rnn.py:63-95``), every op rounded to bf16: kernels A and
C's scan mode, on bf16-exact values held in f32 registers, with
``hg = bf16(bf16(h @ W_hh) + b_hh)`` and the sigmoid ``1 / (1 +
exp(-x))``, each op rounded.  Its backward is JAX's transpose: each op's
gradient rounded, dh carried in bf16, and dW_hh / db_hh formed step by
step, each step's rows summed (W_hh's in f32, rounded once; b_hh's one
row after another in bf16), then summed over the walk's steps as a bf16
running sum from the walk's first step on.  In both bf16 modes the
wrappers take and return bf16 tensors.

Under a ``torch.profiler`` each launch is a span of the program's log
(``runtime/profiling.py``), ``ops.bigru_fwd`` or ``ops.bigru_bwd``, whose
attributes are the shapes as launched (K, B, L, H, G, kernel A's
``train`` and the ``mode``): a roofline reads them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from mmdfn_torch.ops import _build, _mode
from mmdfn_torch.ops.bf16 import (BF16, F32, SCAN, Carry, RowBias, Sigmoid,
                                  Tanh, check_mode, mm, row_sum, to_bf16)
from mmdfn_torch.runtime.profiling import annotate

Tensor = torch.Tensor

_p, _i64, _i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# xg_f, xg_b, w_f, b_f, w_b, b_b, the two weights' (config, row, column)
# strides, mask, ys_f, ys_b, hg_f, hg_b (null in serve mode), K, B, L, H,
# BT, scan, stream
_ARGTYPES = [_p] * 6 + [_i64] * 6 + [_p] * 5 + [_i32] * 6 + [_p]
# xg_f, xg_b, hg_f, hg_b, w_f, w_b, the two weights' (config, row, column)
# strides, mask, ys_f, ys_b, dy_f, dy_b, dxg_f, dxg_b, dhg_f, dhg_b,
# partials, dwb, K, B, L, H, BT, split_rows, scan, stream
_BWD_ARGTYPES = [_p] * 6 + [_i64] * 6 + [_p] * 11 + [_i32] * 7 + [_p]
_KERNEL_H = 100      # the only hidden width the kernels take (the port's)
_SPLIT_ROWS = 256    # rows of B L per split of kernel C's dW_hh product


def _rows_per_block(B: int, sms: int, K: int = 1) -> int:
    """Batch rows per block of kernels A and C: the fewest of 1, 2, 4 for
    which both directions' blocks of the K configurations of B rows fit on
    a card of ``sms`` multiprocessors in one wave (one block per SM); 4
    beyond that.  A block's rows are one configuration's."""
    for bt in (1, 2):
        if 2 * K * -(-B // bt) <= sms:
            return bt
    return 4


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _gates_rz(xg_t: Tensor, hg: Tensor) -> Tuple[Tensor, Tensor]:
    """The r and z gates, sigmoid(xg + hg) over the first 2H columns.  The
    sigmoid reads a strided view of the (., 3H) sum, so that it runs row by
    row, as it does on the same rows under ``vmap`` (on a contiguous
    tensor the CPU kernel runs one flat loop, whose scalar tail falls on
    other elements once K blocks are stacked, a last-bit difference)."""
    H = hg.shape[-1] // 3
    rz = torch.sigmoid((xg_t + hg)[..., :2 * H])
    return rz[..., :H], rz[..., H:]


def _gru_gates(xg_t: Tensor, hg: Tensor, h: Tensor) -> Tensor:
    """Torch GRU gate math (r, z, n) from the two projections."""
    r, z = _gates_rz(xg_t, hg)
    xn, hn = xg_t.chunk(3, dim=-1)[2], hg.chunk(3, dim=-1)[2]
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h


def bigru_layer_plain(xg_f: Tensor, xg_b: Tensor, w_hh_f: Tensor,
                      b_hh_f: Tensor, w_hh_b: Tensor, b_hh_b: Tensor,
                      mask: Tensor, with_hg: bool = False,
                      mode: str = F32) -> Tuple[Tensor, ...]:
    """Plain PyTorch version of :func:`bigru_layer_fwd` (same contract).

    With ``with_hg`` it returns ``(ys_f, ys_b, hg_f, hg_b)``: hg (B, L, 3H)
    is ``h_prev @ W_hh + b_hh`` of each step, as kernel A's training mode
    writes it.  The bf16 scan mode is :func:`_scan_plain` (the bf16 mode
    is the f32 one, :func:`bigru_layer_fwd`)."""
    if mode == SCAN:
        return _scan_plain(xg_f, xg_b, w_hh_f, b_hh_f, w_hh_b, b_hh_b, mask,
                           with_hg)
    if mode != F32:
        raise ValueError(f"bigru_layer_plain: mode {mode!r}")
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


def _scan_plain(xg_f, xg_b, w_hh_f, b_hh_f, w_hh_b, b_hh_b, mask,
                with_hg=False):
    """The bf16 scan mode's plain version: JAX's bf16 ``_gru_scan``
    (``mmdfn_tpu/nn/rnn.py:47-95``) per direction as torch ops on bf16
    tensors, in JAX's order, each op rounding to bf16, h carried in bf16
    and held by a select at masked frames.  Differentiable by autograd,
    whose backward rounds, sums and carries where the transposed scan does
    (:class:`~mmdfn_torch.ops.bf16.RowBias`, ``Carry``, ``Sigmoid``,
    ``Tanh``), so that it equals :func:`_scan_bwd_plain` bit for bit.
    The operands are bf16 (B, L, 3H), (H, 3H), (3H,); the outputs bf16."""
    B, L, G = xg_f.shape
    H = G // 3
    gate = mask > 0
    outs, hgs = [], []
    for xg, w, b, steps in ((xg_f, w_hh_f, b_hh_f, range(L)),
                            (xg_b, w_hh_b, b_hh_b, range(L - 1, -1, -1))):
        h = xg.new_zeros(B, H)
        xs = xg.unbind(1)
        ys, hg = [None] * L, [None] * L
        for t in steps:
            hg[t] = RowBias.apply(mm(h, w), b)
            xr, xz, xn = xs[t].chunk(3, dim=-1)
            hr, hz, hn = hg[t].chunk(3, dim=-1)
            r = Sigmoid.apply(xr + hr)
            z = Sigmoid.apply(xz + hz)
            a = xn + r * hn
            n = Tanh.apply(a, a)
            h, ys[t] = Carry.apply(
                torch.where(gate[:, t, None], (1 - z) * n + z * h, h))
        outs.append(torch.stack(ys, dim=1) if L else xg.new_empty(B, 0, H))
        if with_hg:
            hgs.append(torch.stack(hg, dim=1) if L else xg.new_empty(B, 0, G))
    return (*outs, *hgs)


def _scan_bwd_plain(xg_f, xg_b, w_hh_f, b_hh_f, w_hh_b, b_hh_b, mask, ys_f,
                    ys_b, dy_f, dy_b, hg_f=None, hg_b=None):
    """Kernel C's reverse walk in the bf16 scan mode, in plain ops on f32
    tensors that hold bf16 values (``to_bf16`` after each op): the
    transpose of JAX's bf16 ``_gru_scan`` step, each op's gradient rounded
    where it rounds it, dh carried in bf16; a masked frame passes dh on
    and gives no gradient (a select).  dW_hh and db_hh are formed per step
    (``h_prev^T dhg`` summed in f32 and rounded; the rows of dhg summed
    one after another in bf16) and summed over the walk's steps as a bf16
    running sum.  Same contract as :func:`bigru_layer_bwd_plain`; takes
    and returns bf16 tensors."""
    rd = to_bf16
    (xg_f, xg_b, w_hh_f, b_hh_f, w_hh_b, b_hh_b, ys_f, ys_b, dy_f, dy_b,
     hg_f, hg_b) = (None if t is None else t.float() for t in (
        xg_f, xg_b, w_hh_f, b_hh_f, w_hh_b, b_hh_b, ys_f, ys_b, dy_f, dy_b,
        hg_f, hg_b))
    B, L, G = xg_f.shape
    H = G // 3
    gate = (mask > 0)[..., None]
    sig = lambda x: rd(1.0 / rd(1.0 + rd(torch.exp(-x))))
    acc = lambda old, new: new if old is None else rd(old + new)
    out = []
    for xg, w, b, ys, dy, hgs, walk, shift in (
            (xg_f, w_hh_f, b_hh_f, ys_f, dy_f, hg_f, range(L - 1, -1, -1), -1),
            (xg_b, w_hh_b, b_hh_b, ys_b, dy_b, hg_b, range(L), 1)):
        zero = xg.new_zeros(B, H)
        dh = xg.new_zeros(B, H)
        dxg = xg.new_zeros(B, L, G)
        dw = db = None
        for t in walk:
            tp = t + shift
            hp = ys[:, tp] if 0 <= tp < L else zero
            m = gate[:, t]
            hg = rd(rd(hp @ w) + b) if hgs is None else hgs[:, t]
            xr, xz, xn = xg[:, t].chunk(3, dim=-1)
            hr, hz, hn = hg.chunk(3, dim=-1)
            r, z = sig(rd(xr + hr)), sig(rd(xz + hz))
            n = rd(torch.tanh(rd(xn + rd(r * hn))))
            cy = rd(dh + dy[:, t])
            cz = torch.where(m, cy, 0.0)
            dz = rd(rd(cz * hp) - rd(cz * n))
            dj = rd(rd(rd(1.0 - z) * cz) * rd(1.0 - n))
            dn = rd(dj + rd(dj * n))                 # tanh's input
            dr = rd(rd(dn * hn) * rd(r * rd(1.0 - r)))
            dz = rd(dz * rd(z * rd(1.0 - z)))
            dhg = torch.where(m, torch.cat([dr, dz, rd(r * dn)], dim=-1), 0.0)
            dxg[:, t] = torch.where(m, torch.cat([dr, dz, dn], dim=-1), 0.0)
            dh = torch.where(m, rd(rd(z * cz) + rd(dhg @ w.t())), cy)
            dw = acc(dw, rd(hp.t() @ dhg))
            db = acc(db, row_sum(dhg.to(torch.bfloat16)).float())
        if L == 0:
            dw, db = torch.zeros_like(w), torch.zeros_like(b)
        out.append((dxg, dw, db))
    (dxg_f, dw_f, db_f), (dxg_b, dw_b, db_b) = out
    return tuple(t.to(torch.bfloat16)
                 for t in (dxg_f, dxg_b, dw_f, db_f, dw_b, db_b))


def bigru_layer_bwd_plain(xg_f: Tensor, xg_b: Tensor, w_hh_f: Tensor,
                          b_hh_f: Tensor, w_hh_b: Tensor, b_hh_b: Tensor,
                          mask: Tensor, ys_f: Tensor, ys_b: Tensor,
                          dy_f: Tensor, dy_b: Tensor,
                          hg_f: Optional[Tensor] = None,
                          hg_b: Optional[Tensor] = None, mode: str = F32):
    """Plain PyTorch version of :func:`bigru_layer_bwd`: the explicit time
    loop of ``_bwd_kernel`` (``mmdfn_tpu/ops/pallas_rnn.py:127-209``), or
    in the bf16 scan mode :func:`_scan_bwd_plain`.

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
    if mode == SCAN:
        return _scan_bwd_plain(xg_f, xg_b, w_hh_f, b_hh_f, w_hh_b, b_hh_b,
                               mask, ys_f, ys_b, dy_f, dy_b, hg_f, hg_b)
    if mode != F32:
        raise ValueError(f"bigru_layer_bwd_plain: mode {mode!r}")
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
            r, z = _gates_rz(xg[:, t], hg)
            xn, hn = xg[:, t].chunk(3, dim=-1)[2], hg.chunk(3, dim=-1)[2]
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


def _check(name: str, t: Tensor, shape, device,
           dtype=torch.float32) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device:
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)} on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def _aligned(t: Tensor) -> Tensor:
    """Contiguous, and 16-byte aligned for the kernels' cp.async copies."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _prepare(xg_f, xg_b, w_hh_f, b_hh_f, w_hh_b, b_hh_b, mask, more=(),
             dtype=torch.float32):
    """Aligned contiguous operands on one CUDA device, shapes checked, in
    ``dtype`` (the mask in f32); the hidden weights keep their strides
    (the kernels take them).  ``more`` holds (name, tensor, width, dtype)
    operands of shape (B, L, width).  With a config axis every operand but
    the mask has a leading K."""
    *lead, B, L, G = xg_f.shape
    H = G // 3
    k = tuple(lead)
    dev = xg_f.device
    if dev.type != "cuda":
        raise ValueError(f"bi-GRU kernels: no kernel for {dev}")
    if H != _KERNEL_H:
        raise ValueError(f"bi-GRU kernels take H = {_KERNEL_H}, got {H}")
    xg_f, xg_b, b_hh_f, b_hh_b = map(_aligned, (xg_f, xg_b, b_hh_f, b_hh_b))
    mask = _aligned(mask.to(torch.float32))
    more = tuple((name, _aligned(t), width, dt)
                 for name, t, width, dt in more)
    for name, t, shape, dt in (("xg_f", xg_f, k + (B, L, G), dtype),
                               ("xg_b", xg_b, k + (B, L, G), dtype),
                               ("w_hh_f", w_hh_f, k + (H, G), dtype),
                               ("w_hh_b", w_hh_b, k + (H, G), dtype),
                               ("b_hh_f", b_hh_f, k + (G,), dtype),
                               ("b_hh_b", b_hh_b, k + (G,), dtype),
                               ("mask", mask, (B, L), torch.float32),
                               *((name, t, k + (B, L, width), dt)
                                 for name, t, width, dt in more)):
        _check(name, t, shape, dev, dt)
    return (xg_f, xg_b, w_hh_f, b_hh_f, w_hh_b, b_hh_b, mask) \
        + tuple(t for _, t, _, _ in more)


def _strides(w: Tensor):
    """A hidden weight's (config, row, column) strides; 0 for the config
    of a weight without a config axis."""
    return (w.stride(0), *w.stride()[1:]) if w.dim() == 3 else (0, *w.stride())


def _forward(xg_f, xg_b, w_hh_f, b_hh_f, w_hh_b, b_hh_b, mask,
             with_hg: bool = False, mode: str = F32):
    """Kernel A on CUDA tensors, the plain version on CPU tensors.  With
    ``with_hg`` (training mode) it also returns hg_f, hg_b (B, L, 3H) for
    kernel C.  A 3-d ``w_hh_f`` marks a config axis: one launch for all K
    configurations.  ``mode`` is 'f32' or 'bf16_scan' (bf16 operands and
    ys; on the card hg stays f32, bf16-exact, for kernel C)."""
    args = (xg_f, xg_b, w_hh_f, b_hh_f, w_hh_b, b_hh_b, mask)
    if xg_f.device.type == "cpu":
        plain = lambda *a: bigru_layer_plain(*a, with_hg=with_hg, mode=mode)
        if w_hh_f.dim() == 3:
            return _mode.vmap_plain(plain, args, shared=(6,))
        return plain(*args)
    scan = mode == SCAN
    xg_f, xg_b, w_hh_f, b_hh_f, w_hh_b, b_hh_b, mask = _prepare(
        *args, dtype=torch.bfloat16 if scan else torch.float32)
    *lead, B, L, G = xg_f.shape
    K = lead[0] if lead else 1
    H = G // 3
    dev = xg_f.device
    ys_f = xg_f.new_empty(*lead, B, L, H)
    ys_b = xg_f.new_empty(*lead, B, L, H)
    # hg in f32 (bf16 values in the scan mode), for kernel C
    hgs = tuple(torch.empty(xg_f.shape, device=dev) for _ in range(2)) \
        if with_hg else ()
    if K * B == 0 or L == 0:
        return (ys_f, ys_b, *hgs)
    fn = _build.load("bigru_fwd", "bigru_fwd", _ARGTYPES)
    hg_ptrs = [t.data_ptr() for t in hgs] if with_hg else [None, None]
    with annotate("ops.bigru_fwd", K=K, B=B, L=L, H=H, G=G, train=with_hg,
                  mode=mode):
        err = fn(xg_f.data_ptr(), xg_b.data_ptr(), w_hh_f.data_ptr(),
                 b_hh_f.data_ptr(), w_hh_b.data_ptr(), b_hh_b.data_ptr(),
                 *_strides(w_hh_f), *_strides(w_hh_b), mask.data_ptr(),
                 ys_f.data_ptr(), ys_b.data_ptr(), *hg_ptrs, K, B, L, H,
                 _rows_per_block(B, _sm_count(dev), K), int(scan),
                 torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "bigru_fwd launch")
    bigru_layer_fwd.launches += 1
    return (ys_f, ys_b, *hgs)


def bigru_layer_bwd(xg_f: Tensor, xg_b: Tensor, w_hh_f: Tensor,
                    b_hh_f: Tensor, w_hh_b: Tensor, b_hh_b: Tensor,
                    mask: Tensor, ys_f: Tensor, ys_b: Tensor, dy_f: Tensor,
                    dy_b: Tensor, hg_f: Optional[Tensor] = None,
                    hg_b: Optional[Tensor] = None, mode: str = F32):
    """Kernel C: the gradients of one bi-GRU layer's recurrence.

    Takes the forward's operands (as :func:`bigru_layer_fwd`), its outputs
    ``ys_f``/``ys_b``, their cotangents ``dy_f``/``dy_b`` (B, L, H) and the
    ``hg_f``/``hg_b`` (B, L, 3H) that kernel A's training mode wrote, which
    the kernel needs.  Returns (dxg_f, dxg_b, dW_hh_f, db_hh_f, dW_hh_b,
    db_hh_b) as :func:`bigru_layer_bwd_plain` does, which CPU tensors and
    ``ops.plain_ops()`` run instead (there hg may be None: recomputed).
    With a config axis (every operand but the mask led by K) it is one
    launch, and each configuration's dW_hh, db_hh sums its own rows.
    ``mode`` 'bf16_scan' takes and returns bf16 tensors (hg may be f32).
    """
    args = (xg_f, xg_b, w_hh_f, b_hh_f, w_hh_b, b_hh_b, mask, ys_f, ys_b,
            dy_f, dy_b, hg_f, hg_b)
    if _mode.plain or xg_f.device.type == "cpu":
        plain = lambda *a: bigru_layer_bwd_plain(*a, mode=mode)
        if w_hh_f.dim() == 3:
            return _mode.vmap_plain(plain, args, shared=(6,))
        return plain(*args)
    if hg_f is None or hg_b is None:
        raise ValueError("bigru_layer_bwd: kernel C needs the hg that kernel "
                         "A's training mode writes")
    if mode not in (F32, SCAN):
        raise ValueError(f"bigru_layer_bwd: mode {mode!r}")
    scan = mode == SCAN
    dt = torch.bfloat16 if scan else torch.float32
    f32 = torch.float32
    *lead, B, L, G = xg_f.shape
    K = lead[0] if lead else 1
    H = G // 3
    (xg_f, xg_b, w_hh_f, b_hh_f, w_hh_b, b_hh_b, mask, ys_f, ys_b, dy_f,
     dy_b, hg_f, hg_b) = _prepare(
        xg_f, xg_b, w_hh_f, b_hh_f, w_hh_b, b_hh_b, mask,
        (("ys_f", ys_f, H, dt), ("ys_b", ys_b, H, dt), ("dy_f", dy_f, H, dt),
         ("dy_b", dy_b, H, dt), ("hg_f", hg_f, G, f32),
         ("hg_b", hg_b, G, f32)), dtype=dt)
    dev = xg_f.device
    dxg_f = torch.empty_like(xg_f)
    dxg_b = torch.empty_like(xg_f)
    # [dW_hh; db_hh] of each configuration and direction, in f32 (bf16
    # values in the scan mode, which returns them as bf16)
    dwb = torch.empty(K, 2, H + 1, G, device=dev)

    def grads():
        d = dwb.to(dt)
        dw = d if lead else d[0]
        return (dxg_f, dxg_b, dw[..., 0, :H, :], dw[..., 0, H, :],
                dw[..., 1, :H, :], dw[..., 1, H, :])
    if K * B == 0 or L == 0:
        for t in (dxg_f, dxg_b, dwb):
            t.zero_()
        return grads()
    # each step's dhg, and the dW_hh product's partials: over each
    # configuration's row splits, or in the scan mode over each step
    dhg = torch.empty(2, K * B * L * G, device=dev)
    splits = -(-B * L // _SPLIT_ROWS)
    partials = torch.empty(K, 2, L if scan else splits, H + 1, G,
                           device=dev)
    fn = _build.load("bigru_bwd", "bigru_bwd", _BWD_ARGTYPES)
    with annotate("ops.bigru_bwd", K=K, B=B, L=L, H=H, G=G, mode=mode):
        err = fn(xg_f.data_ptr(), xg_b.data_ptr(), hg_f.data_ptr(),
                 hg_b.data_ptr(), w_hh_f.data_ptr(), w_hh_b.data_ptr(),
                 *_strides(w_hh_f), *_strides(w_hh_b), mask.data_ptr(),
                 ys_f.data_ptr(), ys_b.data_ptr(), dy_f.data_ptr(),
                 dy_b.data_ptr(), dxg_f.data_ptr(), dxg_b.data_ptr(),
                 dhg[0].data_ptr(), dhg[1].data_ptr(), partials.data_ptr(),
                 dwb.data_ptr(), K, B, L, H,
                 _rows_per_block(B, _sm_count(dev), K), _SPLIT_ROWS,
                 int(scan), torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "bigru_bwd launch")
    bigru_layer_bwd.launches += 1
    return grads()


class BiGRULayer(torch.autograd.Function):
    """One bi-GRU layer's recurrence with kernel A forward (training mode)
    and kernel C backward (their plain versions on CPU tensors), in the
    mode given last ('f32' or 'bf16_scan').  Saves what ``_bigru_bwd``
    needs: xg, mask, W_hh, b_hh, the outputs, and the gate pre-activations
    hg, so the backward recomputes nothing.  Its outputs are ys_f, ys_b and
    the hg pair (not differentiable).  Under ``torch.func.vmap`` its rule
    makes one config-axis launch (with autograd off, of the serve mode,
    and the hg pair is None)."""

    @staticmethod
    def forward(xg_f, xg_b, w_hh_f, b_hh_f, w_hh_b, b_hh_b, mask, mode=F32):
        return _forward(xg_f, xg_b, w_hh_f, b_hh_f, w_hh_b, b_hh_b, mask,
                        with_hg=True, mode=mode)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(*output[2:])
        ctx.save_for_backward(*inputs[:7], *output)
        ctx.mode = inputs[7] if len(inputs) > 7 else F32
        ctx.n_inputs = len(inputs)

    @staticmethod
    def backward(ctx, dy_f, dy_b, _dhg_f, _dhg_b):
        saved = ctx.saved_tensors
        ys_f = saved[7]
        dy_f = torch.zeros_like(ys_f) if dy_f is None else dy_f
        dy_b = torch.zeros_like(ys_f) if dy_b is None else dy_b
        grads = bigru_layer_bwd(*saved[:9], dy_f, dy_b, *saved[9:],
                                mode=ctx.mode)
        return (*grads, *(None,) * (ctx.n_inputs - 6))

    @staticmethod
    def vmap(info, in_dims, *args):
        args = _mode.config_axis(info, in_dims, args, shared=(6,))
        if torch.is_grad_enabled():
            return BiGRULayer.apply(*args), (0, 0, 0, 0)
        # serving: kernel A's serve mode, which writes no hg
        mode = args[7] if len(args) > 7 else F32
        return (*_forward(*args[:7], mode=mode), None, None), \
            (0, 0, None, None)


def bigru_layer_fwd(xg_f: Tensor, xg_b: Tensor, w_hh_f: Tensor,
                    b_hh_f: Tensor, w_hh_b: Tensor, b_hh_b: Tensor,
                    mask: Optional[Tensor] = None,
                    mode: str = F32) -> Tuple[Tensor, Tensor]:
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
      Under ``torch.func.vmap`` (every operand but the mask may carry the
      config axis) the kernels take the whole group in one launch.
      mode: 'f32'; 'bf16' or 'bf16_scan' with bf16 operands and outputs
        (the module's note).
    """
    check_mode(mode)
    B, L, G = xg_f.shape
    if mask is None:    # shared by every configuration under vmap
        mask = torch.ones(B, L, device=xg_f.device)
    if mode == BF16:    # the f32 kernels on the widened operands
        ys = bigru_layer_fwd(*(t.float() for t in (
            xg_f, xg_b, w_hh_f, b_hh_f, w_hh_b, b_hh_b)), mask)
        return tuple(y.to(torch.bfloat16) for y in ys)
    args = (xg_f, xg_b, w_hh_f, b_hh_f, w_hh_b, b_hh_b, mask)
    if _mode.plain:
        return bigru_layer_plain(*args, mode=mode)
    if xg_f.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bigru_layer_fwd: no kernel for {xg_f.device}")
    if any(_mode.is_batched(t) for t in args) or torch.is_grad_enabled() \
            and any(t.requires_grad for t in args):
        return BiGRULayer.apply(*args, mode)[:2]
    return _forward(*args, mode=mode)


bigru_layer_fwd.launches = 0
bigru_layer_bwd.launches = 0
