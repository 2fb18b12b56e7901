"""The ERC model on the serve path (``mmdfn_tpu/models/dialogue_gnn.py``):
only ``base_model='LSTM'``, multimodal, graph type ``GF``/``GDF``
(``dialogue_gnn.py:195-326``).

Encoders: ``linear_a/v/l`` project each modality to 200; ``lstm_l`` (a
bi-GRU) encodes the text; the shared ``rnn_parties`` bi-GRU runs over the
three stacked modality projections at once and adds ``sw[m] * delta`` per
modality (a weight of 0 is still multiplied).  Then ``MMGCN``, ReLU,
``smax_fc`` and ``log_softmax``.  Submodule and parameter names are the
reference ``DialogueGNNModel.state_dict()`` keys.

``forward(..., train=True, generator=g)`` is the training forward: the
encoders' inter-layer dropout, the GCNII stack's dropouts and the head's
``dropout_`` (``mmdfn_tpu/models/dialogue_gnn.py:322-323``), all drawn from
``g``; without it every dropout is the identity.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mmdfn_torch.config import D_E, GRAPH_H, HIDDEN_MODALITY, ExperimentConfig
from mmdfn_torch.models.mm_gcn import MMGCN
from mmdfn_torch.nn.dropout import dropout
from mmdfn_torch.nn.gcn import GCNIIStack
from mmdfn_torch.nn.rnn import BiRNN, crn_party_delta

Tensor = torch.Tensor

_LATER = "a later slice of the port (other graph families)"


class DialogueGNN(nn.Module):
    """Top-level ERC model; construct with :meth:`from_config`."""

    def __init__(self, D_text: int, D_audio: int, D_visual: int,
                 n_classes: int, modals: str = "avl", nlayers: int = 16,
                 lamda: float = 0.5, alpha: float = 0.2,
                 reason_flag: bool = False, speaker_weights: str = "3-0-1",
                 use_crn_speaker: bool = True, use_residue: bool = True,
                 modal_weight: float = 1.0, dropout: float = 0.0):
        super().__init__()
        self.modals = modals
        self.dropout = dropout
        self.use_crn_speaker = use_crn_speaker
        sw = list(map(float, speaker_weights.split("-")))
        self.speaker_weight = {"a": sw[0], "v": sw[1], "l": sw[2]}
        dims = {"a": D_audio, "v": D_visual, "l": D_text}
        for m in "avl":
            if m in modals:
                setattr(self, f"linear_{m}", nn.Linear(dims[m], HIDDEN_MODALITY))
        if "l" in modals:
            self.lstm_l = BiRNN(HIDDEN_MODALITY, D_E, dropout=dropout)
        if use_crn_speaker:
            self.rnn_parties = BiRNN(HIDDEN_MODALITY, D_E, dropout=dropout)
        self.graph_model = MMGCN(
            2 * D_E, nlayers, GRAPH_H, lamda=lamda, alpha=alpha,
            use_residue=use_residue, modals=modals, reason_flag=reason_flag,
            modal_weight=modal_weight, dropout=dropout)
        feat = len(modals) * (2 * D_E + GRAPH_H if use_residue else GRAPH_H)
        self.smax_fc = nn.Linear(feat, n_classes)

    @classmethod
    def from_config(cls, cfg: ExperimentConfig) -> "DialogueGNN":
        if cfg.base_model != "LSTM":
            raise NotImplementedError(
                f"base_model {cfg.base_model!r}: {_LATER}")
        if cfg.graph_type not in ("GF", "GDF"):
            raise NotImplementedError(
                f"graph_type {cfg.graph_type!r}: {_LATER}")
        if cfg.mm_fusion_mthd != "concat_subsequently":
            raise NotImplementedError(
                f"mm_fusion_mthd {cfg.mm_fusion_mthd!r}: {_LATER}")
        if cfg.use_speaker or cfg.use_modal:
            raise NotImplementedError(
                f"use_speaker / use_modal embeddings: {_LATER}")
        info = cfg.info
        return cls(
            D_text=info["D_text"], D_audio=info["D_audio"],
            D_visual=info["D_visual"], n_classes=info["n_classes"],
            modals=cfg.modals, nlayers=cfg.Deep_GCN_nlayers, lamda=cfg.lamda,
            alpha=cfg.alpha,
            reason_flag=cfg.reason_flag and cfg.graph_type == "GDF",
            speaker_weights=cfg.speaker_weights,
            use_crn_speaker=cfg.use_crn_speaker, use_residue=cfg.use_residue,
            modal_weight=cfg.modal_weight, dropout=cfg.dropout)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Fresh torch-default weights drawn from ``generator``."""
        for m in self.modules():
            if isinstance(m, (BiRNN, GCNIIStack)):
                m.reset_parameters(generator)
        with torch.no_grad():
            for name in ("linear_a", "linear_v", "linear_l", "smax_fc"):
                lin = getattr(self, name, None)
                if lin is not None:
                    k = 1.0 / lin.in_features ** 0.5
                    lin.weight.uniform_(-k, k, generator=generator)
                    lin.bias.uniform_(-k, k, generator=generator)

    def forward(self, text: Tensor, qmask: Tensor, umask: Tensor,
                audio: Optional[Tensor] = None,
                visual: Optional[Tensor] = None, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        """Per-utterance log-probs (B, L, n_classes); pad rows are garbage.
        ``train`` turns every dropout on, drawn from ``generator``."""
        kw = dict(train=train, generator=generator)
        inputs = {"a": audio, "v": visual, "l": text}
        order = [m for m in "avl" if m in self.modals]
        proj = {m: getattr(self, f"linear_{m}")(inputs[m]) for m in order}
        base = dict(proj)
        if "l" in proj:
            base["l"] = self.lstm_l(proj["l"], umask, **kw)
        if self.use_crn_speaker:
            # one party-GRU batch for all modalities (the RNN is shared)
            M, B = len(order), umask.shape[0]
            delta = crn_party_delta(
                self.rnn_parties, torch.cat([proj[m] for m in order], dim=0),
                qmask.repeat(M, 1, 1), umask.repeat(M, 1), **kw)
            emotions = {m: base[m] + self.speaker_weight[m]
                        * delta[i * B:(i + 1) * B]
                        for i, m in enumerate(order)}
        else:
            emotions = base
        feat = self.graph_model(emotions, umask, **kw)
        if train:
            feat = dropout(feat, self.dropout, generator)
        feat = torch.relu(feat)
        return torch.log_softmax(self.smax_fc(feat), dim=-1)
