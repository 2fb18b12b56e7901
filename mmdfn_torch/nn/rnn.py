"""Mask-gated bidirectional GRU encoders (``mmdfn_tpu/nn/rnn.py``).

The input projection ``x @ W_ih + b_ih`` for the whole sequence is one
``torch.matmul``, outside the kernel, as the JAX package computes it
(``nn/rnn.py:306-309``); the hidden recurrence of each layer, both
directions, is kernel A (:func:`mmdfn_torch.ops.bigru_layer_fwd`).

The recurrence is gated per (batch, time) by a mask with a select: a masked
frame carries the state unchanged, so outputs are padding-invariant and a
mask with holes visits a subsequence (the CRN party encoder rides this).
In training, the output of every layer but the last goes through dropout
(``mmdfn_tpu/nn/rnn.py:346-351``), drawn from the caller's generator.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from mmdfn_torch.nn.dropout import dropout
from mmdfn_torch.ops import bigru_layer_fwd

Tensor = torch.Tensor


class BiRNN(nn.Module):
    """2-layer bidirectional GRU, batch-first, mask-gated.

    Parameters carry torch ``nn.GRU`` names and shapes
    (``weight_ih_l0``, ``weight_hh_l0_reverse``, ...), so a reference
    ``nn.GRU`` state_dict loads as is.
    """

    def __init__(self, input_size: int, hidden_size: int,
                 num_layers: int = 2, dropout: float = 0.0):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.dropout = dropout
        H = hidden_size
        for layer in range(num_layers):
            in_dim = input_size if layer == 0 else 2 * H
            for suf in ("", "_reverse"):
                for name, shape in (("weight_ih", (3 * H, in_dim)),
                                    ("weight_hh", (3 * H, H)),
                                    ("bias_ih", (3 * H,)),
                                    ("bias_hh", (3 * H,))):
                    self.register_parameter(
                        f"{name}_l{layer}{suf}",
                        nn.Parameter(torch.empty(shape)))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """torch GRU init: every parameter U(-1/sqrt(H), 1/sqrt(H))."""
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
        out = x
        for layer in range(self.num_layers):
            w = lambda n, suf="": getattr(self, f"{n}_l{layer}{suf}")
            xg_f = out @ w("weight_ih").t() + w("bias_ih")
            xg_b = out @ w("weight_ih", "_reverse").t() + w("bias_ih", "_reverse")
            ys_f, ys_b = bigru_layer_fwd(
                xg_f, xg_b, w("weight_hh").t(), w("bias_hh"),
                w("weight_hh", "_reverse").t(), w("bias_hh", "_reverse"),
                umask)
            out = torch.cat([ys_f, ys_b], dim=-1)
            if train and layer < self.num_layers - 1:
                out = dropout(out, self.dropout, generator)
        return out


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
