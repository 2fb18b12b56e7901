"""The MM-DFN graph-fusion core (``mmdfn_tpu/models/mm_gcn.py:MMGCN``,
reference ``model_mm.py:44-180``)."""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from mmdfn_torch.graph.adjacency import mm_big_adjacency
from mmdfn_torch.nn.gcn import GCNIIStack

Tensor = torch.Tensor


class MMGCN(nn.Module):
    """Cross-modal GCNII fusion (MM-DFN when ``reason_flag``).

    The modalities, in the order of ``modals``, are stacked into
    one (B, M*L, n_dim) node matrix; the output re-splits the stack per
    modality and concatenates along features: (B, L, M*(n_dim + nhidden))
    with the residue concat.
    """

    def __init__(self, n_dim: int, nlayers: int, nhidden: int,
                 lamda: float = 0.5, alpha: float = 0.2,
                 use_residue: bool = True, modals: str = "avl",
                 reason_flag: bool = False, modal_weight: float = 1.0,
                 dropout: float = 0.0):
        super().__init__()
        if len(modals) < 2:
            raise ValueError("MMGCN needs at least two modalities")
        self.modals = list(modals)
        self.use_residue = use_residue
        self.modal_weight = modal_weight
        self.graph_net = GCNIIStack(n_dim, nlayers, nhidden, lamda=lamda,
                                    alpha=alpha, reason_flag=reason_flag,
                                    dropout=dropout)

    def forward(self, feats: Dict[str, Tensor], umask: Tensor, *,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        L = umask.shape[1]
        ordered = [feats[m] for m in self.modals]
        adj = mm_big_adjacency(ordered, umask, modal_weight=self.modal_weight)
        x_resid, h = self.graph_net(torch.cat(ordered, dim=1), adj,
                                    train=train, generator=generator)
        if self.use_residue:
            h = torch.cat([x_resid, h], dim=-1)      # model_GCN.py:482-483
        parts = [h[:, i * L:(i + 1) * L] for i in range(len(self.modals))]
        return torch.cat(parts, dim=-1)              # model_mm.py:112-116
