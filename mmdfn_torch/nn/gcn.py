"""The deep GCNII stack (``mmdfn_tpu/nn/gcn.py`` ``GCNIIStack`` with the
GCNII_lyc wiring, reference ``model_GCN.py:412-488``).

``fc_in`` and ReLU give ``h = h0``; then per layer l = 1..nlayers, with
``theta_l = log(lamda / l + 1)``: the shared reason-LSTM step (gates
i, f, g, o; bias ``b_ih + b_hh``; state carried across layers), the GCNII
variant update, ReLU, dropout and the additive skip ``+q``.  In training
the input x is dropped before ``fc_in`` and h after its ReLU, with h0 kept
undropped (``mmdfn_tpu/nn/gcn.py:159-165``), and each layer's dropout bits
come from Philox under a seed drawn from the step's generator.  The layer
loop is :func:`mmdfn_torch.ops.gcnii_stack_fwd`: kernel B, and under
autograd kernel B's training mode with kernel D for the backward.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from mmdfn_torch.nn.dropout import dropout
from mmdfn_torch.ops import gcnii_stack_fwd

Tensor = torch.Tensor


class GraphConvolution(nn.Module):
    """One GCNII layer's weight, (2H, H) for the variant, applied as
    ``support @ weight`` (reference ``model_GCN.py:160-189``)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_features, out_features))


class ReasonLSTM(nn.Module):
    """The shared one-layer LSTM's weights under ``nn.LSTM``'s names."""

    def __init__(self, hidden: int):
        super().__init__()
        H = hidden
        self.weight_ih_l0 = nn.Parameter(torch.empty(4 * H, H))
        self.weight_hh_l0 = nn.Parameter(torch.empty(4 * H, H))
        self.bias_ih_l0 = nn.Parameter(torch.empty(4 * H))
        self.bias_hh_l0 = nn.Parameter(torch.empty(4 * H))


class GCNIIStack(nn.Module):
    """Deep GCNII stack; returns ``(x, h)`` (the input, for the residue
    concat, and the final hidden state)."""

    def __init__(self, nfeat: int, nlayers: int, nhidden: int,
                 lamda: float = 0.5, alpha: float = 0.2,
                 reason_flag: bool = False, dropout: float = 0.0):
        super().__init__()
        self.nhidden = nhidden
        self.alpha = alpha
        self.dropout = dropout
        self.reason_flag = reason_flag
        self._cache = None       # (parameter key, packed weights)
        self.fcs = nn.ModuleList([nn.Linear(nfeat, nhidden)])
        self.convs = nn.ModuleList(
            [GraphConvolution(2 * nhidden, nhidden) for _ in range(nlayers)])
        self.rnn = ReasonLSTM(nhidden) if reason_flag else None
        self.register_buffer(
            "theta", torch.log(lamda / torch.arange(1, nlayers + 1,
                                                    dtype=torch.float32) + 1.0),
            persistent=False)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """torch defaults: Linear U(-1/sqrt(in), .); the GCNII conv
        U(-1/sqrt(H), .) (``model_GCN.py:172-174``); LSTM U(-1/sqrt(H), .)."""
        k = 1.0 / math.sqrt(self.nhidden)
        fc = self.fcs[0]
        kf = 1.0 / math.sqrt(fc.in_features)
        with torch.no_grad():
            fc.weight.uniform_(-kf, kf, generator=generator)
            fc.bias.uniform_(-kf, kf, generator=generator)
            for conv in self.convs:
                conv.weight.uniform_(-k, k, generator=generator)
            if self.rnn is not None:
                for p in self.rnn.parameters():
                    p.uniform_(-k, k, generator=generator)

    def _packed(self) -> tuple:
        """The layer weights as kernel B takes them: W stacked to
        (nlayers, 2H, H), the LSTM weights contiguous as (H, 4H) and
        ``b_ih + b_hh``.  With autograd off (serving) they are built once
        and rebuilt only after a parameter moves or is written in place;
        with autograd on they are built afresh so gradients reach them."""
        params = [c.weight for c in self.convs]
        if self.rnn is not None:
            params += list(self.rnn.parameters())
        key = tuple((p.data_ptr(), p._version) for p in params)
        if self._cache is not None and self._cache[0] == key \
                and not torch.is_grad_enabled():
            return self._cache[1]
        W = torch.stack([conv.weight for conv in self.convs])
        if self.reason_flag:
            r = self.rnn
            packed = (W, r.weight_ih_l0.t().contiguous(),
                      r.weight_hh_l0.t().contiguous(),
                      r.bias_ih_l0 + r.bias_hh_l0)
        else:
            packed = (W, None, None, None)
        self._cache = None if torch.is_grad_enabled() else (key, packed)
        return packed

    def forward(self, x: Tensor, adj: Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[Tensor, Tensor]:
        """Returns (x, h): the input as the residue concat takes it
        (dropped in training, as the reference reuses its mutated ``x``)
        and the final hidden state."""
        W, *lstm = self._packed()
        rate = self.dropout if train else 0.0
        x = dropout(x, rate, generator)
        h0 = torch.relu(self.fcs[0](x))
        h = dropout(h0, rate, generator)
        seed = None
        if rate > 0.0:   # the kernels' Philox key, never read by the host
            seed = torch.randint(0, 1 << 62, (1,), generator=generator,
                                 device=x.device)
        h = gcnii_stack_fwd(adj, h, h0, W, self.theta, *lstm,
                            alpha=self.alpha, reason=self.reason_flag,
                            rate=rate, seed=seed)
        return x, h
