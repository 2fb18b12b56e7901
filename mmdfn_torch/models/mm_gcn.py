"""The GCNII graph cores (``mmdfn_tpu/models/mm_gcn.py``): MM-DFN's
cross-modal ``MMGCN`` (reference ``model_mm.py:44-180``), the ``MMGCN2``
ablation (graph type GF2, ``model_mm.py:183-258``) and the per-modality
``DeepGCNII`` baseline (graph type DeepGCN, ``model_GCN.py:224-285``).
All three run the GCNII stack's kernels B and D; each takes ``variant``
(``False``: the original GCNII update, through the fold of its (H, H)
layer weights, ``nn/gcn.py:GCNIIStack``), and ``compute_dtype`` (the
config's ``gcn_compute_dtype``); MMGCN and DeepGCNII also ``backend``
(``gcn_backend``), as the JAX package passes them
(``mmdfn_tpu/models/mm_gcn.py:106-109,189,249-252``).  Only MMGCN's stack
reaches the bf16 mode; MMGCN2's and DeepGCNII's wirings are JAX's layer
scan, which ``compute_dtype='bfloat16'`` runs in kernels B and D's bf16
scan mode (``GCNIIStack``), as MMGCN's does without a Pallas backend."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from mmdfn_torch.graph.adjacency import (gcnii_block_adjacency,
                                         mm_big_adjacency,
                                         mm_wo_speaker_adjacency)
from mmdfn_torch.nn.dropout import dropout
from mmdfn_torch.nn.gcn import GCNIIStack
from mmdfn_torch.nn.init import reset_linear, reset_linears
from mmdfn_torch.nn.linear import Linear

Tensor = torch.Tensor


class MMGCN(nn.Module):
    """Cross-modal GCNII fusion (MM-DFN when ``reason_flag``).

    The modalities, in the order of ``modals``, are stacked into
    one (B, M*L, n_dim) node matrix; the output re-splits the stack per
    modality and concatenates along features: (B, L, M*(n_dim + nhidden))
    with the residue concat.  ``use_speaker`` adds a speaker embedding to
    the text features, ``use_modal`` a modality embedding to each
    (``model_mm.py:79-98``).  ``spmm``: the stack's ``adj @ h``
    (:class:`GCNIIStack`).
    """

    def __init__(self, n_dim: int, nlayers: int, nhidden: int,
                 lamda: float = 0.5, alpha: float = 0.2,
                 use_residue: bool = True, modals: str = "avl",
                 reason_flag: bool = False, modal_weight: float = 1.0,
                 dropout: float = 0.0, n_speakers: int = 2,
                 use_speaker: bool = False, use_modal: bool = False,
                 spmm: Optional[Callable] = None,
                 rate_tag: Optional[str] = None, variant: bool = True,
                 backend: Optional[str] = None,
                 compute_dtype: Optional[str] = None):
        super().__init__()
        if len(modals) < 2:
            raise ValueError("MMGCN needs at least two modalities")
        self.modals = list(modals)
        self.use_residue = use_residue
        self.modal_weight = modal_weight
        if use_speaker and "l" in modals:
            self.speaker_embeddings = nn.Embedding(n_speakers, n_dim)
        if use_modal:
            self.modal_embeddings = nn.Embedding(3, n_dim)
        self.graph_net = GCNIIStack(n_dim, nlayers, nhidden, lamda=lamda,
                                    alpha=alpha, reason_flag=reason_flag,
                                    dropout=dropout, spmm=spmm,
                                    rate_tag=rate_tag, variant=variant,
                                    backend=backend,
                                    compute_dtype=compute_dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The embeddings N(0, 1) (``nn.Embedding``'s default), then the
        stack's defaults."""
        with torch.no_grad():
            for name in ("speaker_embeddings", "modal_embeddings"):
                if hasattr(self, name):
                    getattr(self, name).weight.normal_(generator=generator)
        self.graph_net.reset_parameters(generator)

    def forward(self, feats: Dict[str, Tensor], qmask: Tensor, umask: Tensor,
                *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        L = umask.shape[1]
        um = umask[..., None]
        feats = dict(feats)
        if hasattr(self, "speaker_embeddings"):
            spk = qmask.argmax(dim=-1)
            feats["l"] = feats["l"] + self.speaker_embeddings.weight[spk] * um
        if hasattr(self, "modal_embeddings"):
            for i, m in enumerate("avl"):
                if m in feats and m in self.modals:
                    feats[m] = feats[m] + self.modal_embeddings.weight[i] * um
        ordered = [feats[m] for m in self.modals]
        adj = mm_big_adjacency(ordered, umask, modal_weight=self.modal_weight)
        x_resid, h = self.graph_net(torch.cat(ordered, dim=1), adj,
                                    train=train, generator=generator)
        if self.use_residue:
            h = torch.cat([x_resid, h], dim=-1)      # model_GCN.py:482-483
        parts = [h[:, i * L:(i + 1) * L] for i in range(len(self.modals))]
        return torch.cat(parts, dim=-1)              # model_mm.py:112-116


class MMGCN2(GCNIIStack):
    """The MMGCN2 ablation (graph type GF2): per-modality dropout, ``fc_m``
    and ReLU encoders, the stacked node matrix through the GCNII stack in
    MM_GCN2's wiring (no ``fc_in``; h0 is the encoded nodes), the
    per-modality re-split, and the residue concat of the raw text features.

    The graph is built from the *raw* features with the raw-arccos
    similarity and constant 0.99999 cross edges (``graph_construct``
    "direct", ``model_mm.py:239,260-296``), or from the encoded ones by
    ``mm_wo_speaker_adjacency`` ("single", "window", "fc").  The
    reference names the encoders ``fcs`` in the order a, l, v
    (``model_mm.py:224-234``) and the layers ``convs``.
    """

    _FC_INDEX = {"a": 0, "l": 1, "v": 2}

    def __init__(self, nfeat: int, nlayers: int, nhidden: int,
                 lamda: float = 0.5, alpha: float = 0.1,
                 use_residue: bool = True, modals: str = "avl",
                 graph_construct: str = "direct", dropout: float = 0.0,
                 rate_tag: Optional[str] = None, variant: bool = True,
                 compute_dtype: Optional[str] = None):
        super().__init__(nhidden, nlayers, nhidden, lamda=lamda, alpha=alpha,
                         dropout=dropout, has_fc_in=False,
                         dropout_mode="before", post_loop_dropout=True,
                         rate_tag=rate_tag, variant=variant,
                         compute_dtype=compute_dtype)
        if graph_construct not in ("direct", "single", "window", "fc"):
            raise ValueError(f"graph_construct {graph_construct!r}")
        if use_residue and "l" not in modals:
            raise ValueError("GF2's residue concat takes the text features")
        self.modals = list(modals)
        self.use_residue = use_residue
        self.graph_construct = graph_construct
        self.fcs = nn.ModuleDict({str(self._FC_INDEX[m]): Linear(
            nfeat, nhidden) for m in sorted(modals, key=self._FC_INDEX.get)})

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_linears(self.fcs, generator)
        super().reset_parameters(generator)

    def forward(self, feats: Dict[str, Tensor], qmask: Tensor, umask: Tensor,
                *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        L = umask.shape[1]
        rate = self.dropout if train else 0.0
        encoded = [torch.relu(self.fcs[str(self._FC_INDEX[m])](
            dropout(feats[m], rate, generator, self.rate_tag)))
            for m in self.modals]
        if self.graph_construct == "direct":
            adj = mm_big_adjacency([feats[m] for m in self.modals], umask,
                                   variant="arccos", cross_constant=0.99999)
        else:
            adj = mm_wo_speaker_adjacency(encoded, umask,
                                          scheme=self.graph_construct)
        _, h = super().forward(torch.cat(encoded, dim=1), adj, train=train,
                               generator=generator)
        out = torch.cat([h[:, i * L:(i + 1) * L]
                         for i in range(len(self.modals))], dim=-1)
        if self.use_residue:
            out = torch.cat([feats["l"], out], dim=-1)   # model_mm.py:254
        return out


class DeepGCNII(GCNIIStack):
    """One stream's GCNII network (graph type DeepGCN): the angular block
    graph of its own utterances, the stack in the GCNII wiring (no dropout
    inside the layer loop, one after it) and the residue concat; with
    ``n_classes`` (the single-stream head) then the classifier, the
    reference's ``fcs[1]`` (``mmdfn_tpu``'s ``fc_out``), and log-softmax."""

    def __init__(self, nfeat: int, nlayers: int, nhidden: int,
                 lamda: float = 0.5, alpha: float = 0.1,
                 use_residue: bool = True, reason_flag: bool = False,
                 dropout: float = 0.0, n_classes: Optional[int] = None,
                 spmm: Optional[Callable] = None,
                 rate_tag: Optional[str] = None, variant: bool = True,
                 backend: Optional[str] = None,
                 compute_dtype: Optional[str] = None):
        super().__init__(nfeat, nlayers, nhidden, lamda=lamda, alpha=alpha,
                         reason_flag=reason_flag, dropout=dropout,
                         dropout_mode="none", post_loop_dropout=True,
                         spmm=spmm, rate_tag=rate_tag, variant=variant,
                         backend=backend, compute_dtype=compute_dtype)
        self.use_residue = use_residue
        if n_classes is not None:
            self.fcs.append(Linear(
                nfeat + nhidden if use_residue else nhidden, n_classes))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        super().reset_parameters(generator)
        if len(self.fcs) > 1:
            reset_linear(self.fcs[1], generator)

    def forward(self, x: Tensor, qmask: Tensor, umask: Tensor, *,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        adj = gcnii_block_adjacency(x, umask)
        x_resid, h = super().forward(x, adj, train=train, generator=generator)
        if self.use_residue:
            h = torch.cat([x_resid, h], dim=-1)
        if len(self.fcs) > 1:
            return torch.log_softmax(self.fcs[1](h), dim=-1)
        return h
