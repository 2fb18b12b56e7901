"""The multimodal ERC model (``mmdfn_tpu/models/dialogue_gnn.py``,
reference ``DialogueGNNModel``, ``model.py:784-1407``): base encoder x
graph family x fusion head.

Encoders (``base_model='LSTM'``): ``linear_a/v/l`` project each modality to
200; ``lstm_l`` (a bi-GRU) encodes the text, and with ``av_using_lstm``
``lstm_a`` and ``lstm_v`` the audio and visual; the shared ``rnn_parties``
bi-GRU runs over the three stacked projections at once and adds
``sw[m] * delta`` per modality (a weight of 0 is still multiplied).
``base_model='None'`` keeps the projections alone.

The single stream (``multi_modal`` off, or ``mm_fusion_mthd='concat'``,
early fusion: ``ExperimentConfig.multi_modal_path``) reads one input, the
text features, another modality or their concatenation
(``ExperimentConfig.input_modals``), through one of four bases
(``dialogue_gnn.py:171-289``): ``LSTM`` (``linear_`` to 250/150/100 by
the number of modals, the ``lstm`` bi-GRU and the CRN's ``rnn_parties``
at the text speaker weight), ``GRU`` (``gru``), ``DialogRNN``
(``dialog_rnn_f`` and, on the reversed valid prefix, ``dialog_rnn_r``)
or ``None`` (``base_linear``); then one ``graph_net`` that classifies:
relation (the nodal-attention classifier), DeepGCN (the configured lamda
and alpha, ``fcs[1]``), GCN3 (its ``linear``) or 'None' (a linear to the
classes).  GF, GDF and GF2 fuse modalities and take no single stream.

Graph families (``dialogue_gnn.py:303-441``):

* ``GDF`` / ``GF``: :class:`MMGCN` (MM-DFN with the reason-LSTM / MMGCN);
* ``GF2``: :class:`MMGCN2`, 64 layers, lamda 0.5, alpha 0.1 (hard-coded);
* ``DeepGCN``: a :class:`DeepGCNII` per modality (lamda 0.5, alpha 0.1);
* ``GCN3``: a :class:`GCN2Layers` per modality;
* ``relation``: a :class:`GraphNetwork` per modality, the edge weights of
  all three from the *last* modality's features (a reference quirk,
  ``model.py:1183-1223``);
* ``'None'``: a linear per modality beside its input.

The per-modality families end in a fusion head (``_fuse``):
concatenation, the gated attention, MFN, TFN or LMF; ``'mfn'`` also runs
MFN over the fused features of GF, GDF and GF2.  Then dropout, ReLU
(except after relation and ``'None'``), ``smax_fc`` and ``log_softmax``.
Submodule and parameter names are the reference ``state_dict()`` keys.

``forward(..., train=True, generator=g)`` is the training forward, every
dropout drawn from ``g``; without it every dropout is the identity.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
from torch import nn

from mmdfn_torch.config import (D_A, D_E, D_G, D_P, DATASET_INFO, GRAPH_H,
                                HIDDEN_MODALITY, MAX_SEQ_LEN, ExperimentConfig)
from mmdfn_torch.graph.relation import relation_type_ids, window_edge_mask
from mmdfn_torch.models.baselines import (DialogueRNN,
                                          bidirectional_dialogue_rnn)
from mmdfn_torch.models.mm_gcn import MMGCN, MMGCN2, DeepGCNII
from mmdfn_torch.models.relation_net import GraphNetwork
from mmdfn_torch.nn.attention import MaskedEdgeAttention, MMGatedAttention
from mmdfn_torch.nn.dropout import dropout
from mmdfn_torch.nn.fusion import LMF, MFN, TFN
from mmdfn_torch.nn.gcn import GCN2Layers
from mmdfn_torch.nn.init import reset_linear
from mmdfn_torch.nn.linear import Linear
from mmdfn_torch.nn.rnn import BiRNN, crn_party_delta

Tensor = torch.Tensor

GRAPH_TYPES = ("GF", "GDF", "GF2", "DeepGCN", "GCN3", "relation", "None")
BASES = ("LSTM", "GRU", "DialogRNN", "None")
# the override tag of every site whose rate is cfg.dropout (JAX's
# rate_tag="dropout"; nn/drop_override.py): the grouped sweep varies it
TAG = "dropout"
GF2_NLAYERS = 64     # MMGCN2's depth, hard-coded upstream (model.py:956)


def _rnn_kw(cfg: ExperimentConfig) -> dict:
    """The encoders' numerics knobs, which JAX's ``DialogueGNN`` passes to
    every ``BiRNN`` it builds (``mmdfn_tpu/models/dialogue_gnn.py:
    175-260``)."""
    return dict(compute_dtype=cfg.rnn_compute_dtype, backend=cfg.rnn_backend)


class DialogueGNN(nn.Module):
    """Top-level ERC model; construct with :meth:`from_config`."""

    def __init__(self, cfg: ExperimentConfig, D_m_a: Optional[int] = None,
                 D_m_v: Optional[int] = None,
                 gcn_spmm: Optional[Callable] = None):
        """``D_m_a`` / ``D_m_v``: the widths of the audio and visual
        features, when not the dataset's (the raw-input model's frontends
        give 300 and 342).  ``gcn_spmm``: the GCNII stacks' ``adj @ h``
        (``GCNIIStack``), for GF, GDF and DeepGCN, as the JAX model passes
        it (``mmdfn_tpu/models/dialogue_gnn.py:317,405``); GF2's stack
        takes none there either."""
        super().__init__()
        info = cfg.info
        self.multi_modal = cfg.multi_modal_path
        self.order = [m for m in "avl" if m in cfg.modals]
        self.graph_type = gt = cfg.graph_type
        self.base_model = cfg.base_model
        self.fusion = cfg.mm_fusion_mthd
        self.dropout = cfg.dropout
        self.windows = (cfg.windowp, cfg.windowf)
        lstm = cfg.base_model == "LSTM"
        self.use_crn_speaker = lstm and cfg.use_crn_speaker
        sw = list(map(float, cfg.speaker_weights.split("-")))
        self.speaker_weight = {"a": sw[0], "v": sw[1], "l": sw[2]}
        if not self.multi_modal:
            self._single_stream(cfg, gcn_spmm)
            return
        if cfg.base_model not in ("LSTM", "None"):
            raise ValueError(f"base_model {cfg.base_model!r} feeds one "
                             "stream: it takes mm_fusion_mthd 'concat' or "
                             "multi_modal off, not the multimodal "
                             f"{cfg.mm_fusion_mthd!r} head")
        dims = {"a": D_m_a or info["D_audio"], "v": D_m_v or info["D_visual"],
                "l": info["D_text"]}
        for m in self.order:
            setattr(self, f"linear_{m}", Linear(dims[m], HIDDEN_MODALITY))
        rnn_kw = _rnn_kw(cfg)
        for m in self.order:
            if lstm and (m == "l" or cfg.av_using_lstm):
                setattr(self, f"lstm_{m}", BiRNN(HIDDEN_MODALITY, D_E,
                                                 dropout=cfg.dropout,
                                                 rate_tag=TAG, **rnn_kw))
        if self.use_crn_speaker:
            self.rnn_parties = BiRNN(HIDDEN_MODALITY, D_E, dropout=cfg.dropout,
                                     rate_tag=TAG, **rnn_kw)

        M, n_dim, res = len(self.order), 2 * D_E, cfg.use_residue
        if gt in ("GF", "GDF"):
            self.graph_model = MMGCN(
                n_dim, cfg.Deep_GCN_nlayers, GRAPH_H, lamda=cfg.lamda,
                alpha=cfg.alpha, use_residue=res, modals=cfg.modals,
                reason_flag=cfg.reason_flag and gt == "GDF",
                modal_weight=cfg.modal_weight, dropout=cfg.dropout,
                n_speakers=info["n_speakers"], use_speaker=cfg.use_speaker,
                use_modal=cfg.use_modal, spmm=gcn_spmm, rate_tag=TAG,
                backend=cfg.gcn_backend,
                compute_dtype=cfg.gcn_compute_dtype)
            feat = M * (n_dim + GRAPH_H if res else GRAPH_H)
        elif gt == "GF2":
            self.graph_model = MMGCN2(
                n_dim, GF2_NLAYERS, GRAPH_H, lamda=0.5, alpha=0.1,
                use_residue=res, modals=cfg.modals,
                graph_construct=cfg.graph_construct, dropout=cfg.dropout,
                rate_tag=TAG, compute_dtype=cfg.gcn_compute_dtype)
            feat = (n_dim if res else 0) + M * GRAPH_H
        else:
            if gt == "relation":
                self.att_model = MaskedEdgeAttention(
                    n_dim, MAX_SEQ_LEN, cfg.edge_attn_type)
                net = lambda: GraphNetwork(
                    n_dim, 2 * info["n_speakers"] ** 2, GRAPH_H, cfg.use_gcn)
                width = n_dim + GRAPH_H * (2 if cfg.use_gcn else 1)
            elif gt == "DeepGCN":
                net = lambda: DeepGCNII(
                    n_dim, cfg.Deep_GCN_nlayers, GRAPH_H, lamda=0.5,
                    alpha=0.1, use_residue=res, reason_flag=cfg.reason_flag,
                    dropout=cfg.dropout, spmm=gcn_spmm, rate_tag=TAG,
                    backend=cfg.gcn_backend,
                    compute_dtype=cfg.gcn_compute_dtype)
                width = n_dim + GRAPH_H if res else GRAPH_H
            elif gt == "GCN3":
                net = lambda: GCN2Layers(n_dim, GRAPH_H, info["n_classes"],
                                         use_residue=res)
                width = n_dim + GRAPH_H if res else info["n_classes"]
            else:                                              # 'None'
                net = lambda: Linear(n_dim, GRAPH_H)
                width = n_dim + GRAPH_H
            for m in self.order:
                setattr(self, f"graph_net_{m}", net())
            feat = self._fusion_head(width, cfg.modals)
        if self.fusion == "mfn" and gt in ("GF", "GDF", "GF2"):
            feat = self._make_mfn(feat)
        self.smax_fc = Linear(feat, info["n_classes"])

    def _single_stream(self, cfg: ExperimentConfig,
                       gcn_spmm: Optional[Callable]) -> None:
        """The single-stream encoder and classifying graph net."""
        info, gt, base = cfg.info, cfg.graph_type, cfg.base_model
        if gt in ("GF", "GDF", "GF2"):
            raise ValueError(
                f"graph_type {gt!r} fuses the modalities and takes no single "
                f"stream (multi_modal={cfg.multi_modal}, mm_fusion_mthd="
                f"{cfg.mm_fusion_mthd!r})")
        D_m, n_dim, res = cfg.D_m, 2 * D_E, cfg.use_residue
        n_classes = info["n_classes"]
        rnn_kw = _rnn_kw(cfg)
        if base == "LSTM":
            M = len(cfg.modals)
            hidden = 250 if M == 3 else (150 if cfg.modals in ("al", "vl")
                                         else 100)
            self.linear_ = Linear(D_m, hidden)
            self.lstm = BiRNN(hidden, D_E, dropout=cfg.dropout,
                              rate_tag=TAG, **rnn_kw)
            if self.use_crn_speaker:
                self.rnn_parties = BiRNN(hidden, D_E, dropout=cfg.dropout,
                                         rate_tag=TAG, **rnn_kw)
        elif base == "GRU":
            self.gru = BiRNN(D_m, D_E, dropout=cfg.dropout, rate_tag=TAG,
                             **rnn_kw)
        elif base == "DialogRNN":
            rnn = lambda: DialogueRNN(D_m, D_G, D_P, D_E, cfg.active_listener,
                                      cfg.attention, D_A, cfg.rec_dropout)
            self.dialog_rnn_f = rnn()
            self.dialog_rnn_r = rnn()
        else:                                                  # 'None'
            self.base_linear = Linear(D_m, n_dim)
        if gt == "relation":
            self.att_model = MaskedEdgeAttention(n_dim, MAX_SEQ_LEN,
                                                 cfg.edge_attn_type)
            self.graph_net = GraphNetwork(
                n_dim, 2 * info["n_speakers"] ** 2, GRAPH_H, cfg.use_gcn,
                n_classes=n_classes, nodal_attention=cfg.nodal_attention,
                dropout=cfg.dropout, rate_tag=TAG)
        elif gt == "DeepGCN":
            self.graph_net = DeepGCNII(
                n_dim, cfg.Deep_GCN_nlayers, GRAPH_H, lamda=cfg.lamda,
                alpha=cfg.alpha, use_residue=res, reason_flag=cfg.reason_flag,
                dropout=cfg.dropout, n_classes=n_classes, spmm=gcn_spmm,
                rate_tag=TAG, backend=cfg.gcn_backend,
                compute_dtype=cfg.gcn_compute_dtype)
        elif gt == "GCN3":
            self.graph_net = GCN2Layers(n_dim, GRAPH_H, n_classes,
                                        use_residue=res, return_feature=False)
        else:                                                  # 'None'
            self.graph_net = Linear(n_dim, n_classes)

    def _make_mfn(self, width: int) -> int:
        self.mfn = MFN()
        if width != 3 * self.mfn.d:
            raise ValueError(f"mm_fusion_mthd 'mfn' with graph_type "
                             f"{self.graph_type!r}: MFN takes 3 x "
                             f"{self.mfn.d} features, this family gives "
                             f"{width}")
        return 3 * self.mfn.dh + self.mfn.mem_dim

    def _fusion_head(self, width: int, modals: str) -> int:
        """The per-modality families' fusion head (``_fuse``); returns its
        output width."""
        f, M = self.fusion, len(self.order)
        if f in ("concat_subsequently", "concat_only"):
            return M * width
        if f == "gated":
            self.gatedatt = MMGatedAttention(width, GRAPH_H, modals)
            return GRAPH_H * (3 if M == 3 else 1)
        if M != 3:
            raise ValueError(f"mm_fusion_mthd {f!r} fuses three modalities")
        if f in ("mfn", "mfn_only"):
            if f == "mfn" and self.graph_type in ("DeepGCN", "GCN3"):
                raise ValueError(
                    f"mm_fusion_mthd 'mfn' with graph_type "
                    f"{self.graph_type!r}: the reference runs MFN on MFN's "
                    "own output, which it does not take")
            return self._make_mfn(3 * width)
        head = (TFN if f == "tfn_only" else LMF)(width)
        setattr(self, f[:3], head)
        return head.output_dim

    @classmethod
    def from_config(cls, cfg: ExperimentConfig,
                    gcn_spmm: Optional[Callable] = None,
                    **widths) -> "DialogueGNN":
        if cfg.dataset not in DATASET_INFO:
            raise ValueError(f"dataset {cfg.dataset!r}: the port knows "
                             f"{', '.join(DATASET_INFO)}")
        if cfg.dataset == "DailyDialogue":
            raise ValueError(
                "dataset 'DailyDialogue' reads token ids: its model is "
                "DialogueGCNDailyModel (mmdfn_torch.models.from_config), "
                "trained by DailyTrainer")
        if not cfg.graph_model:
            raise ValueError("graph_model=False selects a baseline: build "
                             "it with mmdfn_torch.models.from_config")
        if cfg.graph_type not in GRAPH_TYPES:
            raise ValueError(f"unknown graph_type {cfg.graph_type!r}")
        if cfg.base_model not in BASES:
            raise ValueError(f"unknown base_model {cfg.base_model!r}")
        if cfg.base_model == "DialogRNN" and cfg.multi_modal_path:
            raise NotImplementedError(
                "base_model='DialogRNN' is single-stream only (as in the "
                "reference)")
        return cls(cfg, gcn_spmm=gcn_spmm, **widths)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Fresh torch-default weights drawn from ``generator``: the
        encoders, graph nets and heads child by child in registration
        order, then the bare linears (the projections, 'None''s nets,
        ``smax_fc``), the order in which a seed has always drawn the GF
        and GDF models."""
        children = list(self.children())
        for child in children:
            if not isinstance(child, nn.Linear):
                child.reset_parameters(generator)
        for child in children:
            if isinstance(child, nn.Linear):
                reset_linear(child, generator)

    def _fuse(self, feats: List[Tensor], **kw) -> Tensor:
        f = self.fusion
        if f in ("concat_subsequently", "concat_only"):
            return torch.cat(feats, dim=-1)
        if f == "gated":
            return self.gatedatt(dict(zip(self.order, feats)), **kw)
        if f in ("mfn", "mfn_only"):                       # l, a, v
            return self.mfn(torch.cat([feats[2], feats[0], feats[1]],
                                      dim=-1), **kw)
        return getattr(self, f[:3])(*feats, **kw)

    def _mfn_maybe(self, feat: Tensor, **kw) -> Tensor:
        return self.mfn(feat, **kw) if self.fusion == "mfn" else feat

    def _encode(self, inputs: Dict[str, Tensor], qmask: Tensor,
                umask: Tensor, **kw) -> Dict[str, Tensor]:
        proj = {m: getattr(self, f"linear_{m}")(inputs[m])
                for m in self.order}
        base = {m: (getattr(self, f"lstm_{m}")(proj[m], umask, **kw)
                    if hasattr(self, f"lstm_{m}") else proj[m])
                for m in self.order}
        if not self.use_crn_speaker:
            return base
        # one party-GRU batch for all modalities (the RNN is shared)
        M, B = len(self.order), umask.shape[0]
        delta = crn_party_delta(
            self.rnn_parties, torch.cat([proj[m] for m in self.order], dim=0),
            qmask.repeat(M, 1, 1), umask.repeat(M, 1), **kw)
        return {m: base[m] + self.speaker_weight[m] * delta[i * B:(i + 1) * B]
                for i, m in enumerate(self.order)}

    def forward(self, text: Tensor, qmask: Tensor, umask: Tensor,
                audio: Optional[Tensor] = None,
                visual: Optional[Tensor] = None, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        """Per-utterance log-probs (B, L, n_classes); pad rows are garbage.
        ``train`` turns every dropout on, drawn from ``generator``."""
        kw = dict(train=train, generator=generator)
        if not self.multi_modal:
            return self._forward_single(text, qmask, umask, **kw)
        drop = lambda x: dropout(x, self.dropout if train else 0.0, generator,
                                 TAG)
        emotions = self._encode({"a": audio, "v": visual, "l": text}, qmask,
                                umask, **kw)
        nets = [getattr(self, f"graph_net_{m}", None) for m in self.order]
        gt = self.graph_type
        if gt in ("GF", "GDF", "GF2"):
            feat = self.graph_model(emotions, qmask, umask, **kw)
            feat = torch.relu(drop(self._mfn_maybe(feat, **kw)))
        elif gt == "relation":
            edge_mask = window_edge_mask(umask, *self.windows)
            rel_ids = relation_type_ids(qmask)
            edge_w = self.att_model(emotions[self.order[-1]], edge_mask)
            feat = drop(self._fuse([
                net(emotions[m], edge_w, rel_ids, edge_mask)
                for m, net in zip(self.order, nets)], **kw))
        elif gt == "DeepGCN":
            feat = self._fuse([net(emotions[m], qmask, umask, **kw)
                               for m, net in zip(self.order, nets)], **kw)
            feat = torch.relu(drop(feat))
        elif gt == "GCN3":
            feat = self._fuse([net(emotions[m], qmask, umask)
                               for m, net in zip(self.order, nets)], **kw)
            feat = torch.relu(drop(feat))
        else:                                                  # 'None'
            feat = drop(self._fuse([
                torch.cat([net(emotions[m]), emotions[m]], dim=-1)
                for m, net in zip(self.order, nets)], **kw))
        return torch.log_softmax(self.smax_fc(feat), dim=-1)

    def _forward_single(self, x: Tensor, qmask: Tensor, umask: Tensor,
                        **kw) -> Tensor:
        base = self.base_model
        if base == "LSTM":
            U = self.linear_(x)
            u = self.lstm(U, umask, **kw)
            if self.use_crn_speaker:
                u = u + self.speaker_weight["l"] * crn_party_delta(
                    self.rnn_parties, U, qmask, umask, **kw)
        elif base == "GRU":
            u = self.gru(x, umask, **kw)
        elif base == "DialogRNN":
            u = bidirectional_dialogue_rnn(self.dialog_rnn_f,
                                           self.dialog_rnn_r, x, qmask,
                                           umask, **kw)
        else:
            u = self.base_linear(x)
        gt = self.graph_type
        if gt == "relation":
            edge_mask = window_edge_mask(umask, *self.windows)
            feat = self.graph_net(u, self.att_model(u, edge_mask),
                                  relation_type_ids(qmask), edge_mask)
            return self.graph_net.classify(feat, umask, **kw)
        if gt == "DeepGCN":
            return self.graph_net(u, qmask, umask, **kw)
        if gt == "GCN3":
            return self.graph_net(u, qmask, umask)
        return torch.log_softmax(self.graph_net(u), dim=-1)
