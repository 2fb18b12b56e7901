"""Mask-gated bidirectional GRU and LSTM encoders and the GRU cell of the
DialogueRNN (``mmdfn_tpu/nn/rnn.py``).

The input projection ``x @ W_ih + b_ih`` for the whole sequence is one
``torch.matmul``, outside the kernel, as the JAX package computes it
(``nn/rnn.py:306-309``); the hidden recurrence of each GRU layer, both
directions, is kernel A (:func:`mmdfn_torch.ops.bigru_layer_fwd`).  The
LSTM's recurrence, which the JAX package runs as a ``lax.scan`` and no
kernel, is a step loop of plain ops over both directions at once.

The recurrence is gated per (batch, time) by a mask with a select: a masked
frame carries the state unchanged, so outputs are padding-invariant and a
mask with holes visits a subsequence (the CRN party encoder rides this).
In training, the output of every layer but the last goes through dropout
(``mmdfn_tpu/nn/rnn.py:346-351``), drawn from the caller's generator.

``compute_dtype='bfloat16'`` runs the encoder in bf16 as the JAX package's
``BiRNN`` does (``mmdfn_tpu/nn/rnn.py:265-352``; the mode is
:func:`rnn_mode`): the input cast to bf16, each layer's weights
rounded to bf16 (the f32 masters stay), the projection a
bf16 product plus the bias, each rounded, the inter-layer dropout in bf16,
and the output widened back to the input's type.  The GRU's recurrence is
kernels A and C's bf16 mode where JAX takes its fused Pallas kernel
(``backend='pallas'``), else their bf16 scan mode; the LSTM's is its step
loop in bf16, each op rounded.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
from torch import nn

from mmdfn_torch.nn.dropout import dropout
from mmdfn_torch.ops import bigru_layer_fwd
from mmdfn_torch.ops.bf16 import (BF16, F32, SCAN, Carry, RowBias, Sigmoid,
                                  Tanh, mm)

Tensor = torch.Tensor


def rnn_mode(cell: str, compute_dtype: Optional[str],
             backend: Optional[str]) -> str:
    """The numerics a BiRNN runs in (``ops.bigru``'s modes): f32 unless
    ``compute_dtype`` is 'bfloat16'; then the bf16 mode where JAX's BiRNN
    takes its fused Pallas kernel (a bidirectional GRU under
    ``backend='pallas'``, ``mmdfn_tpu/nn/rnn.py:295-296``), else the bf16
    scan mode (JAX's bf16 scans; the LSTM's bf16 step loop)."""
    if compute_dtype != "bfloat16":
        return F32
    return BF16 if backend == "pallas" and cell == "gru" else SCAN


def _lstm_layer(xg_f: Tensor, xg_b: Tensor, w_hh_f: Tensor, b_hh_f: Tensor,
                w_hh_b: Tensor, b_hh_b: Tensor, mask: Tensor,
                bf16: bool = False) -> Tuple[Tensor, Tensor]:
    """One masked bidirectional LSTM layer's recurrence from the projected
    gates xg (B, L, 4H) and W_hh (H, 4H), gates i, f, g, o
    (``mmdfn_tpu/nn/rnn.py:143-175``):
    the two directions stacked on a leading axis, the backward one over
    reversed time, h and c kept by a select at masked frames.  ``bf16``:
    on bf16 operands, as JAX's bf16 ``_lstm_scan``: ``(xg + bf16(h @
    W_hh)) + b_hh`` and every gate op rounded, with JAX's transposes
    (``ops/bf16.py``)."""
    L = xg_f.shape[1]
    xg = torch.stack([xg_f, xg_b.flip(1)])                    # (2, B, L, 4H)
    keep = torch.stack([mask, mask.flip(1)])[..., None] > 0   # (2, B, L, 1)
    W = torch.stack([w_hh_f, w_hh_b])                         # (2, H, 4H)
    bias = torch.stack([b_hh_f, b_hh_b])[:, None]             # (2, 1, 4H)
    h = c = xg.new_zeros(2, xg.shape[1], W.shape[1])
    if bf16:
        sig, tanh = Sigmoid.apply, lambda x: Tanh.apply(x, x)
    else:
        sig, tanh = torch.sigmoid, torch.tanh
    ys = []
    for t in range(L):
        if bf16:
            g = RowBias.apply(xg[:, :, t] + mm(h, W), bias)
        else:
            g = xg[:, :, t] + torch.baddbmm(bias, h, W)
        i, f, g, o = g.chunk(4, -1)
        c_new = sig(f) * c + sig(i) * tanh(g)
        h_new = sig(o) * tanh(c_new)
        h = torch.where(keep[:, :, t], h_new, h)
        if bf16:
            h, y = Carry.apply(h)
        else:
            y = h
        c = torch.where(keep[:, :, t], c_new, c)
        ys.append(y)
    ys = torch.stack(ys, dim=2)
    return ys[0], ys[1].flip(1)


class BiRNN(nn.Module):
    """2-layer bidirectional GRU (``cell='gru'``, kernel A) or LSTM
    (``cell='lstm'``), batch-first, mask-gated.

    Parameters carry torch ``nn.GRU`` / ``nn.LSTM`` names and shapes
    (``weight_ih_l0``, ``weight_hh_l0_reverse``, ...), so a reference
    state_dict loads as is.  ``compute_dtype`` and ``backend`` take the
    JAX ``BiRNN``'s names and meanings (the module's note; ``mode``).
    """

    def __init__(self, input_size: int, hidden_size: int,
                 num_layers: int = 2, dropout: float = 0.0,
                 cell: str = "gru", rate_tag: Optional[str] = None,
                 compute_dtype: Optional[str] = None,
                 backend: Optional[str] = None):
        super().__init__()
        if cell not in ("gru", "lstm"):
            raise ValueError(f"cell {cell!r}")
        self.mode = rnn_mode(cell, compute_dtype, backend)
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.dropout = dropout
        self.rate_tag = rate_tag
        self.cell = cell
        H = hidden_size
        G = (3 if cell == "gru" else 4) * H
        for layer in range(num_layers):
            in_dim = input_size if layer == 0 else 2 * H
            for suf in ("", "_reverse"):
                for name, shape in (("weight_ih", (G, in_dim)),
                                    ("weight_hh", (G, H)),
                                    ("bias_ih", (G,)),
                                    ("bias_hh", (G,))):
                    self.register_parameter(
                        f"{name}_l{layer}{suf}",
                        nn.Parameter(torch.empty(shape)))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """torch RNN init: every parameter U(-1/sqrt(H), 1/sqrt(H))."""
        k = 1.0 / math.sqrt(self.hidden_size)
        with torch.no_grad():
            for p in self.parameters():
                p.uniform_(-k, k, generator=generator)

    def forward(self, x: Tensor, umask: Optional[Tensor] = None, *,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        """x: (B, L, D) -> (B, L, 2H); ``train`` turns the inter-layer
        dropout on, drawn from ``generator``."""
        if umask is None:
            umask = x.new_ones(x.shape[:2])
        bf16 = self.mode != F32
        if bf16:
            cast = lambda t: t.to(torch.bfloat16)
            project = lambda inp, w, b: mm(inp, w) + b
        else:
            cast = lambda t: t
            project = lambda inp, w, b: inp @ w + b
        if self.cell == "gru":
            recurrence = bigru_layer_fwd if not bf16 else functools.partial(
                bigru_layer_fwd, mode=self.mode)
        else:
            recurrence = functools.partial(_lstm_layer, bf16=bf16)
        out = cast(x)
        for layer in range(self.num_layers):
            w = lambda n, suf="": cast(getattr(self, f"{n}_l{layer}{suf}"))
            xg_f = project(out, w("weight_ih").t(), w("bias_ih"))
            xg_b = project(out, w("weight_ih", "_reverse").t(),
                           w("bias_ih", "_reverse"))
            ys_f, ys_b = recurrence(
                xg_f, xg_b, w("weight_hh").t(), w("bias_hh"),
                w("weight_hh", "_reverse").t(), w("bias_hh", "_reverse"),
                umask)
            out = torch.cat([ys_f, ys_b], dim=-1)
            if train and layer < self.num_layers - 1:
                out = cast(dropout(out, self.dropout, generator,
                                   self.rate_tag, bf16=bf16))
        return out.to(x.dtype)


class GRUCellStep(nn.Module):
    """One GRU cell step with ``nn.GRUCell``'s names and gate math (r, z,
    n), in plain ops (``mmdfn_tpu/nn/rnn.py:355-380``)."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        H = hidden_size
        self.weight_ih = nn.Parameter(torch.empty(3 * H, input_size))
        self.weight_hh = nn.Parameter(torch.empty(3 * H, H))
        self.bias_ih = nn.Parameter(torch.empty(3 * H))
        self.bias_hh = nn.Parameter(torch.empty(3 * H))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        k = 1.0 / math.sqrt(self.weight_hh.shape[1])
        with torch.no_grad():
            for p in self.parameters():
                p.uniform_(-k, k, generator=generator)

    def forward(self, x: Tensor, h: Tensor) -> Tensor:
        xr, xz, xn = (x @ self.weight_ih.t() + self.bias_ih).chunk(3, -1)
        hr, hz, hn = (h @ self.weight_hh.t() + self.bias_hh).chunk(3, -1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        return (1.0 - z) * n + z * h


class LSTMCellStep(nn.Module):
    """One LSTM cell step, carried by the caller (``mmdfn_tpu/nn/rnn.py:
    LSTMCellStep``, the reason-LSTM's cell of ``model_GCN.py:458-467``):
    gates i, f, g, o from ``x @ w_ih + b_ih + h @ w_hh + b_hh`` with the
    weights (H, 4H) in the JAX orientation, all drawn U(-1/sqrt(H), .).
    ``forward(x, (h, c))`` returns ``(h', (h', c'))``."""

    def __init__(self, hidden_size: int):
        super().__init__()
        H = hidden_size
        self.w_ih = nn.Parameter(torch.empty(H, 4 * H))
        self.w_hh = nn.Parameter(torch.empty(H, 4 * H))
        self.b_ih = nn.Parameter(torch.empty(4 * H))
        self.b_hh = nn.Parameter(torch.empty(4 * H))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        k = 1.0 / math.sqrt(self.w_hh.shape[0])
        with torch.no_grad():
            for p in self.parameters():
                p.uniform_(-k, k, generator=generator)

    def forward(self, x: Tensor, carry: Tuple[Tensor, Tensor]):
        h, c = carry
        g = x @ self.w_ih + self.b_ih + h @ self.w_hh + self.b_hh
        i, f, gg, o = g.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
        h = torch.sigmoid(o) * torch.tanh(c)
        return h, (h, c)


def crn_party_delta(rnn: BiRNN, x: Tensor, qmask: Tensor,
                    umask: Tensor, *, train: bool = False,
                    generator: Optional[torch.Generator] = None) -> Tensor:
    """Contextual-reasoning speaker encoder (``mmdfn_tpu/nn/rnn.py:411``).

    All B*P (batch, party) streams run as one RNN batch, each gated by "this
    frame is party p's", which visits exactly that party's frames in time
    order: no gather or scatter.

    Args:
      x: (B, L, D) projected utterance features.
      qmask: (B, L, P) speaker one-hots; umask: (B, L).
    Returns:
      (B, L, D_out) party-contextual features (zero where no speaker).
    """
    B, L, P = qmask.shape
    is_p = (qmask.transpose(1, 2) > 0) & (umask[:, None, :] > 0)   # (B, P, L)
    flat = x[:, None].expand(B, P, L, x.shape[-1]).reshape(B * P, L, -1)
    E = rnn(flat, is_p.reshape(B * P, L).to(x.dtype), train=train,
            generator=generator).reshape(B, P, L, -1)
    # select, not multiply: masked frames hold carried state, and a
    # non-finite value parked in one must stay quarantined (0 * inf = nan)
    return torch.where(is_p[..., None], E, torch.zeros_like(E)).sum(dim=1)
