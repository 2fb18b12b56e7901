"""The relation graph network of graph type ``relation`` (DialogueGCN's,
``mmdfn_tpu/models/relation_net.py``, reference ``model.py:675-715``) over
dense masked adjacencies, in plain tensor ops.  Parameter names and
orientations are those of torch-geometric 1.4.3's ``RGCNConv`` and
``GraphConv``, which the reference pins."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from mmdfn_torch.nn.attention import MatchingAttention
from mmdfn_torch.nn.dropout import dropout
from mmdfn_torch.nn.gcn import GCNLayer1
from mmdfn_torch.nn.init import reset_linears, reset_uniform
from mmdfn_torch.nn.linear import Linear

Tensor = torch.Tensor


class DenseRGCNConv(nn.Module):
    """Basis-decomposition RGCN layer: for an edge src -> dst of relation
    r, the message ``w[src, dst] x[src] W_r`` with ``W_r = sum_b att[r, b]
    basis_b``; messages are averaged over each node's incoming edges, plus
    ``x @ root + bias``."""

    def __init__(self, in_features: int, out_features: int,
                 num_relations: int, num_bases: int = 30):
        super().__init__()
        self.basis = nn.Parameter(torch.empty(num_bases, in_features,
                                              out_features))
        self.att = nn.Parameter(torch.empty(num_relations, num_bases))
        self.root = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.empty(out_features))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """U(-k, k), k = 1/sqrt(num_bases in_features), for every
        parameter (torch-geometric's ``uniform(size, .)``)."""
        k = 1.0 / math.sqrt(self.basis.shape[0] * self.basis.shape[1])
        reset_uniform(self.parameters(), k, generator)

    def forward(self, x: Tensor, edge_weight: Tensor, rel_ids: Tensor,
                edge_mask: Tensor) -> Tensor:
        hb = torch.einsum("bsf,kfo->bkso", x, self.basis)
        # att[rel_ids] as a product with the one-hot relations (exact: one
        # term a sum), whose backward is a product too; the gather's
        # backward scatters B L^2 rows into a few with atomics (36 of a
        # 42 ms step on an H100 at B = 32, L = 80)
        onehot = nn.functional.one_hot(rel_ids, self.att.shape[0])
        w = edge_weight[..., None] * (onehot.to(x.dtype) @ self.att)
        agg = torch.einsum("bsdk,bkso->bdo", w, hb)
        deg = edge_mask.sum(dim=1)                          # in-degree
        return agg / deg.clamp(min=1.0)[..., None] + x @ self.root + self.bias


class DenseGraphConv(nn.Module):
    """``GraphConv``: ``out[i] = x[i] W_root + b + sum_{src->i} x[src]
    W``, with ``weight`` (in, out) and the root term ``lin``."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_features, out_features))
        self.lin = Linear(in_features, out_features)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """``weight`` U(-1/sqrt(in), .), as torch-geometric draws it; the
        root linear torch's default."""
        reset_uniform([self.weight], 1.0 / math.sqrt(self.weight.shape[0]),
                      generator)
        reset_linears(self, generator)

    def forward(self, x: Tensor, edge_mask: Tensor) -> Tensor:
        agg = torch.einsum("bsd,bso->bdo", edge_mask, x @ self.weight)
        return agg + self.lin(x)


class GraphNetwork(nn.Module):
    """RGCN, GraphConv and the residue concat: the features (the
    multimodal path's ``return_feature=True``); with ``n_classes`` (the
    single-stream head) also the nodal-attention classifier,
    :meth:`classify` (``mmdfn_tpu/models/relation_net.py:131-145``).

    ``use_GCN`` keeps a reference quirk: its conv3 and conv4 are
    ``GCNLayer1`` called with an empty speaker list, whose graph is then
    the identity (``model.py:691-701``), so each is its plain linear."""

    def __init__(self, num_features: int, num_relations: int,
                 hidden_size: int = 64, use_GCN: bool = False,
                 n_classes: Optional[int] = None,
                 nodal_attention: bool = True, dropout: float = 0.0,
                 rate_tag: Optional[str] = None):
        super().__init__()
        self.conv1 = DenseRGCNConv(num_features, hidden_size, num_relations)
        self.conv2 = DenseGraphConv(hidden_size, hidden_size)
        if use_GCN:
            self.conv3 = GCNLayer1(num_features, hidden_size)
            self.conv4 = GCNLayer1(hidden_size, hidden_size)
        if n_classes is not None:
            self.dropout = dropout
            self.rate_tag = rate_tag
            width = num_features + hidden_size * (2 if use_GCN else 1)
            if nodal_attention:
                self.matchatt = MatchingAttention(width, width,
                                                  att_type="general2")
            self.linear = Linear(width, hidden_size)
            self.smax_fc = Linear(hidden_size, n_classes)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.conv1.reset_parameters(generator)
        self.conv2.reset_parameters(generator)
        if hasattr(self, "conv3"):
            reset_linears(self.conv3, generator)
            reset_linears(self.conv4, generator)
        if hasattr(self, "smax_fc"):
            for name in ("matchatt", "linear", "smax_fc"):
                if hasattr(self, name):
                    reset_linears(getattr(self, name), generator)

    def forward(self, x: Tensor, edge_weight: Tensor, rel_ids: Tensor,
                edge_mask: Tensor) -> Tensor:
        out = self.conv2(self.conv1(x, edge_weight, rel_ids, edge_mask),
                         edge_mask)
        if hasattr(self, "conv3"):
            return torch.cat([x, out, self.conv4.linear(
                self.conv3.linear(x))], dim=-1)
        return torch.cat([x, out], dim=-1)

    def classify(self, emotions: Tensor, umask: Tensor, *,
                 train: bool = False,
                 generator: Optional[torch.Generator] = None,
                 avec: bool = False) -> Tensor:
        """Per-utterance log-probs from the features:
        ``MatchingAttention('general2')`` of every utterance
        over the dialogue (without nodal attention the features
        themselves), a ReLU linear, dropout and ``smax_fc``; with
        ``avec`` the raw scores, before the log-softmax."""
        if hasattr(self, "matchatt"):
            emotions, _ = self.matchatt(emotions, emotions, umask)
        hidden = dropout(torch.relu(self.linear(emotions)),
                         self.dropout if train else 0.0, generator,
                         self.rate_tag)
        scores = self.smax_fc(hidden)
        return scores if avec else torch.log_softmax(scores, dim=-1)
