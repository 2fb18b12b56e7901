"""The DailyDialogue model family (``mmdfn_tpu/models/daily.py``, reference
``model.py:1410-1545`` and ``model_GCN.py:192-221``): a trainable TextCNN
over token ids, a DialogRNN / LSTM / GRU / None context encoder and the
windowed relation graph net, batch-first (B, L, ...).

The convolutions run over the word axis as ``F.conv1d`` (cuDNN on the
card), as the JAX package leaves them to XLA's ``nn.Conv``: no TPU kernel
is behind them.  The GRU base's bi-GRU is kernels A and C, as everywhere
else.  The max over the word axis is ``amax``, which shares the gradient
among tied positions as ``jnp.max`` does, and the embedding table is a
plain gather (no ``padding_idx``), so row 0 takes the gradient of the
zero-padded word slots as in the JAX package.  Submodule and parameter
names are the reference ``state_dict`` keys.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from mmdfn_torch.graph.relation import relation_type_ids, window_edge_mask
from mmdfn_torch.models.baselines import (DialogueRNN, _reset_children,
                                          bidirectional_dialogue_rnn)
from mmdfn_torch.models.relation_net import GraphNetwork
from mmdfn_torch.nn.attention import MaskedEdgeAttention
from mmdfn_torch.nn.dropout import dropout
from mmdfn_torch.nn.init import reset_linear, reset_uniform
from mmdfn_torch.nn.rnn import BiRNN

Tensor = torch.Tensor


def _conv_max(convs: nn.ModuleList, x: Tensor) -> Tensor:
    """x (N, D, T) through each valid 1-D convolution, ReLU and the max
    over T, concatenated: (N, len(convs) * C)."""
    return torch.cat([torch.relu(conv(x)).amax(dim=2) for conv in convs],
                     dim=-1)


def _reset_convs(convs: nn.ModuleList,
                 generator: Optional[torch.Generator]) -> None:
    """``nn.Conv1d``'s default: weight and bias U(-k, k), k = 1/sqrt(in
    channels x width)."""
    for conv in convs:
        k = 1.0 / math.sqrt(conv.in_channels * conv.kernel_size[0])
        reset_uniform(conv.parameters(), k, generator)


class CNNFeatureExtractor(nn.Module):
    """Token ids (B, L, W) -> utterance features (B, L, output_size),
    zero where ``umask`` is (reference ``model.py:1410-1443``): the
    embedding table, a convolution of each width over the words, ReLU, the
    max over the words, dropout, ``fc`` and ReLU."""

    def __init__(self, vocab_size: int, embedding_dim: int = 300,
                 output_size: int = 100, filters: int = 50,
                 kernel_sizes: Sequence[int] = (3, 4, 5),
                 dropout: float = 0.5):
        super().__init__()
        self.dropout = dropout
        self.embedding = nn.Embedding(vocab_size, embedding_dim)
        self.convs = nn.ModuleList(nn.Conv1d(embedding_dim, filters, K)
                                   for K in kernel_sizes)
        self.fc = nn.Linear(len(kernel_sizes) * filters, output_size)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The table N(0, 1), the convolutions and ``fc`` torch's
        defaults."""
        with torch.no_grad():
            self.embedding.weight.normal_(generator=generator)
        _reset_convs(self.convs, generator)
        reset_linear(self.fc, generator)

    def forward(self, tokens: Tensor, umask: Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        B, L, W = tokens.shape
        emb = F.embedding(tokens.reshape(B * L, W), self.embedding.weight)
        cat = _conv_max(self.convs, emb.transpose(1, 2))    # (BL, 3F)
        cat = dropout(cat, self.dropout if train else 0.0, generator)
        feat = torch.relu(self.fc(cat))
        return feat.reshape(B, L, -1) * umask[..., None]


class TextCNN(nn.Module):
    """A frame sequence (B, L, input_dim) pooled to one (B, emb_size)
    vector (reference ``model_GCN.py:192-221``): a full-width convolution
    of each height, ReLU, the max over L, dropout, ``embd`` and ReLU.  The
    DailyDialogue model does not call it."""

    def __init__(self, input_dim: int, emb_size: int = 128,
                 out_channels: int = 128,
                 kernel_heights: Sequence[int] = (3, 4, 5),
                 dropout: float = 0.5):
        super().__init__()
        self.dropout = dropout
        self.convs = nn.ModuleList(nn.Conv1d(input_dim, out_channels, K)
                                   for K in kernel_heights)
        self.embd = nn.Linear(len(kernel_heights) * out_channels, emb_size)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        _reset_convs(self.convs, generator)
        reset_linear(self.embd, generator)

    def forward(self, frame_x: Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        cat = _conv_max(self.convs, frame_x.transpose(1, 2))
        cat = dropout(cat, self.dropout if train else 0.0, generator)
        return torch.relu(self.embd(cat))


class DialogueGCNDailyModel(nn.Module):
    """DailyDialogue ERC (reference ``model.py:1446-1545``): the TextCNN
    frontend, a context encoder by ``base_model`` (``DialogRNN``: a
    DialogueRNN each way over the valid prefix, the cells dropping at
    ``dropout_rec``; ``LSTM`` / ``GRU``: a 2-layer bidirectional RNN of
    width ``D_e``; ``None``: a linear to ``2 D_e``), the windowed edge
    attention and the relation graph net with its classifier.

    ``avec`` keeps the reference's meaning: the forward DialogueRNN alone
    and raw scores in place of log-probs.  ``D_h`` is unused, as upstream.
    """

    def __init__(self, base_model: str, D_m: int, D_g: int, D_p: int,
                 D_e: int, D_h: int, D_a: int, graph_hidden_size: int,
                 n_speakers: int, max_seq_len: int, window_past: int,
                 window_future: int, vocab_size: int,
                 embedding_dim: int = 100, cnn_output_size: int = 100,
                 cnn_filters: int = 50,
                 cnn_kernel_sizes: Sequence[int] = (3, 4, 5),
                 cnn_dropout: float = 0.5, n_classes: int = 7,
                 listener_state: bool = False,
                 context_attention: str = "simple",
                 dropout_rec: float = 0.5, dropout: float = 0.5,
                 nodal_attention: bool = True, avec: bool = False):
        super().__init__()
        if D_m != cnn_output_size:
            raise ValueError(f"D_m {D_m} must be the TextCNN's output width "
                             f"{cnn_output_size}: the encoder reads it")
        if avec and base_model == "DialogRNN":
            raise ValueError("avec with base_model 'DialogRNN' gives the "
                             f"graph net {D_e} features where it takes "
                             f"{2 * D_e}")
        self.base_model = base_model
        self.windows = (window_past, window_future)
        self.avec = avec
        self.cnn_feat_extractor = CNNFeatureExtractor(
            vocab_size, embedding_dim, cnn_output_size, cnn_filters,
            cnn_kernel_sizes, cnn_dropout)
        if base_model == "DialogRNN":
            rnn = lambda: DialogueRNN(D_m, D_g, D_p, D_e, listener_state,
                                      context_attention, D_a, dropout_rec)
            self.dialog_rnn_f = rnn()
            if not avec:
                self.dialog_rnn_r = rnn()
        elif base_model in ("LSTM", "GRU"):
            setattr(self, base_model.lower(), BiRNN(
                D_m, D_e, dropout=dropout, cell=base_model.lower()))
        elif base_model == "None":
            self.base_linear = nn.Linear(D_m, 2 * D_e)
        else:
            raise NotImplementedError(f"base_model {base_model!r}")
        self.att_model = MaskedEdgeAttention(2 * D_e, max_seq_len)
        self.graph_net = GraphNetwork(
            2 * D_e, 2 * n_speakers ** 2, graph_hidden_size,
            n_classes=n_classes, nodal_attention=nodal_attention,
            dropout=dropout)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Each child's torch default, in registration order."""
        _reset_children(self, generator)

    def forward(self, tokens: Tensor, qmask: Tensor, umask: Tensor, *,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        """Per-utterance log-probs (B, L, n_classes) from token ids (B, L,
        W); pad rows are garbage.  ``train`` turns every dropout on, drawn
        from ``generator``."""
        kw = dict(train=train, generator=generator)
        U = self.cnn_feat_extractor(tokens, umask, **kw)
        base = self.base_model
        if base == "DialogRNN":
            emotions = (self.dialog_rnn_f(U, qmask, **kw) if self.avec
                        else bidirectional_dialogue_rnn(
                            self.dialog_rnn_f, self.dialog_rnn_r, U, qmask,
                            umask, **kw))
        elif base == "None":
            emotions = self.base_linear(U)
        else:
            emotions = getattr(self, base.lower())(U, umask, **kw)
        edge_mask = window_edge_mask(umask, *self.windows)
        feat = self.graph_net(emotions, self.att_model(emotions, edge_mask),
                              relation_type_ids(qmask), edge_mask)
        return self.graph_net.classify(feat, umask, avec=self.avec, **kw)
