"""The non-graph baselines (``mmdfn_tpu/models/baselines.py``, reference
``model.py:168-417``): the DialogueRNN party-state recurrence, and the
GRU, LSTM and bidirectional DialogueRNN models that the reference trains
with ``--graph_model`` off and the masked NLL loss.

The JAX package has no kernel for these: the DialogueRNN is an
``nn.scan`` and the bi-LSTM a ``lax.scan``.  Here each recurrence is a
step loop of plain ops, one Python step per utterance; the GRU model's
bi-GRU is kernel A (C in training), as everywhere else.  Every model
takes ``(text, qmask, umask, audio, visual)`` like ``DialogueGNN``, reads
the text alone and returns per-utterance log-probs (B, L, n_classes), pad
rows garbage.  Parameter names are the reference's state_dict keys.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from mmdfn_torch.nn.attention import MatchingAttention, SimpleAttention
from mmdfn_torch.nn.dropout import dropout
from mmdfn_torch.nn.init import reset_linear
from mmdfn_torch.nn.linear import Linear
from mmdfn_torch.nn.rnn import BiRNN, GRUCellStep
from mmdfn_torch.utils.masking import flip_valid

Tensor = torch.Tensor


def _reset_children(module: nn.Module,
                    generator: Optional[torch.Generator]) -> None:
    """Each child's torch default, in registration order."""
    for child in module.children():
        if isinstance(child, nn.Linear):
            reset_linear(child, generator)
        else:
            child.reset_parameters(generator)


def _select(x: Tensor, idx: Tensor) -> Tensor:
    """x (B, P, D) at party ``idx`` (B,) -> (B, D)."""
    return x.gather(1, idx[:, None, None].expand(-1, 1, x.shape[-1]))[:, 0]


class DialogueRNNCell(nn.Module):
    """One DialogueRNN step (reference ``DialogueRNNCell``,
    ``model.py:168-240``; ``mmdfn_tpu`` ``DialogueRNNStep``): the global
    state from the utterance and its speaker's state, the context by
    attention over the global states so far (none at t = 0, c = 0), every
    party's state (the listeners' from ``l_cell`` with the listener state,
    else kept), and the emotion state from the speaker's new state.  The
    speaker is ``argmax(qmask)``: party 0 on a pad's all-zero row, as in
    the JAX package."""

    def __init__(self, D_m: int, D_g: int, D_p: int, D_e: int,
                 listener_state: bool = False,
                 context_attention: str = "simple", D_a: int = 100,
                 dropout: float = 0.5):
        super().__init__()
        self.D_g = D_g
        self.dropout = dropout
        self.g_cell = GRUCellStep(D_m + D_p, D_g)
        self.p_cell = GRUCellStep(D_m + D_g, D_p)
        self.e_cell = GRUCellStep(D_p, D_e)
        if listener_state:
            self.l_cell = GRUCellStep(D_m + D_p, D_p)
        self.attention = (SimpleAttention(D_g) if context_attention == "simple"
                          else MatchingAttention(D_g, D_m, D_a,
                                                 context_attention))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        _reset_children(self, generator)

    def forward(self, U_t: Tensor, qm_t: Tensor, g_hist: List[Tensor],
                q: Tensor, e: Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[Tensor, Tensor, Tensor]:
        """U_t (B, D_m), qm_t (B, P), the global states so far, q (B, P,
        D_p), e (B, D_e) -> (g_t, q_t, e_t)."""
        drop = lambda x: dropout(x, self.dropout if train else 0.0,
                                 generator)
        B, P = qm_t.shape
        idx = qm_t.argmax(dim=-1)
        g_prev = g_hist[-1] if g_hist else U_t.new_zeros(B, self.D_g)
        g = drop(self.g_cell(torch.cat([U_t, _select(q, idx)], dim=-1),
                             g_prev))
        if g_hist:
            G = torch.stack(g_hist, dim=1)                    # (B, t, D_g)
            c = (self.attention(G)[0]
                 if isinstance(self.attention, SimpleAttention)
                 else self.attention(G, U_t)[0])
        else:
            c = U_t.new_zeros(B, self.D_g)
        U_c = torch.cat([U_t, c], dim=-1)
        flat = lambda x: x[:, None].expand(B, P, x.shape[-1]).reshape(B * P, -1)
        q_flat = q.reshape(B * P, -1)
        qs = drop(self.p_cell(flat(U_c), q_flat).reshape(q.shape))
        if hasattr(self, "l_cell"):
            ss = _select(qs, idx)
            ql = drop(self.l_cell(torch.cat([flat(U_t), flat(ss)], dim=-1),
                                  q_flat).reshape(q.shape))
        else:
            ql = q
        qm = qm_t[..., None]
        q = ql * (1 - qm) + qs * qm
        e = drop(self.e_cell(_select(q, idx), e))
        return g, q, e


class DialogueRNN(nn.Module):
    """The party-state recurrence over a dialogue (reference
    ``DialogueRNN``, ``model.py:243-278``): one cell step per utterance,
    pads included; returns the emotion states (B, L, D_e)."""

    def __init__(self, D_m: int, D_g: int, D_p: int, D_e: int,
                 listener_state: bool = False,
                 context_attention: str = "simple", D_a: int = 100,
                 dropout: float = 0.5):
        super().__init__()
        self.D_p, self.D_e = D_p, D_e
        self.dialogue_cell = DialogueRNNCell(D_m, D_g, D_p, D_e,
                                             listener_state,
                                             context_attention, D_a, dropout)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.dialogue_cell.reset_parameters(generator)

    def forward(self, U: Tensor, qmask: Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        B, L, _ = U.shape
        q = U.new_zeros(B, qmask.shape[-1], self.D_p)
        e = U.new_zeros(B, self.D_e)
        g_hist: List[Tensor] = []
        es = []
        for t in range(L):
            g, q, e = self.dialogue_cell(U[:, t], qmask[:, t], g_hist, q, e,
                                         train=train, generator=generator)
            g_hist.append(g)
            es.append(e)
        return torch.stack(es, dim=1)


def bidirectional_dialogue_rnn(fwd: DialogueRNN, bwd: DialogueRNN,
                               U: Tensor, qmask: Tensor, umask: Tensor,
                               rate: float = 0.0, **kw) -> Tensor:
    """The forward stream beside the backward one run over each dialogue's
    valid prefix reversed (pads in place) and flipped back, each dropped
    at ``rate`` (``baselines.py:262-289``): (B, L, 2 D_e)."""
    gen = kw.get("generator")
    ef = dropout(fwd(U, qmask, **kw), rate, gen)
    eb = bwd(flip_valid(U, umask), flip_valid(qmask, umask), **kw)
    return torch.cat([ef, dropout(flip_valid(eb, umask), rate, gen)], dim=-1)


class _AttHeadModel(nn.Module):
    """The baselines' shared head (``baselines.py:176-200``): for every
    utterance at once, ``MatchingAttention('general2')`` over the whole
    dialogue, a ReLU linear, dropout, ``smax_fc`` and log-softmax; its
    modules at the model's top level, as the reference names them."""

    def _make_head(self, D_e2: int, D_h: int, n_classes: int,
                   dropout: float) -> None:
        self.dropout = dropout
        self.matchatt = MatchingAttention(D_e2, D_e2, att_type="general2")
        self.linear = Linear(D_e2, D_h)
        self.smax_fc = Linear(D_h, n_classes)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        _reset_children(self, generator)

    def _head(self, emotions: Tensor, umask: Tensor, train: bool,
              generator: Optional[torch.Generator]) -> Tensor:
        att, _ = self.matchatt(emotions, emotions, umask)
        hidden = dropout(torch.relu(self.linear(att)),
                         self.dropout if train else 0.0, generator)
        return torch.log_softmax(self.smax_fc(hidden), dim=-1)


class GRUModel(_AttHeadModel):
    """2-layer bi-GRU baseline (reference ``model.py:281-317``): kernel A
    for the recurrence."""

    def __init__(self, D_m: int, D_e: int, D_h: int, n_classes: int = 7,
                 dropout: float = 0.5):
        super().__init__()
        self.gru = BiRNN(D_m, D_e, dropout=dropout)
        self._make_head(2 * D_e, D_h, n_classes, dropout)

    def forward(self, text: Tensor, qmask: Tensor, umask: Tensor,
                audio: Optional[Tensor] = None,
                visual: Optional[Tensor] = None, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        emotions = self.gru(text, umask, train=train, generator=generator)
        return self._head(emotions, umask, train, generator)


class LSTMModel(_AttHeadModel):
    """2-layer bi-LSTM baseline (reference ``model.py:320-356``), its
    recurrence a step loop of plain ops."""

    def __init__(self, D_m: int, D_e: int, D_h: int, n_classes: int = 7,
                 dropout: float = 0.5):
        super().__init__()
        self.lstm = BiRNN(D_m, D_e, dropout=dropout, cell="lstm")
        self._make_head(2 * D_e, D_h, n_classes, dropout)

    def forward(self, text: Tensor, qmask: Tensor, umask: Tensor,
                audio: Optional[Tensor] = None,
                visual: Optional[Tensor] = None, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        emotions = self.lstm(text, umask, train=train, generator=generator)
        return self._head(emotions, umask, train, generator)


class DialogRNNModel(_AttHeadModel):
    """Bidirectional DialogueRNN baseline (reference ``model.py:359-417``).
    The cells drop at ``dropout_rec``; the emotion streams at ``dropout +
    0.15`` (at most 1), a reference quirk the JAX package keeps."""

    def __init__(self, D_m: int, D_g: int, D_p: int, D_e: int, D_h: int,
                 D_a: int = 100, n_classes: int = 7,
                 listener_state: bool = False,
                 context_attention: str = "simple", dropout_rec: float = 0.5,
                 dropout: float = 0.5):
        super().__init__()
        rnn = lambda: DialogueRNN(D_m, D_g, D_p, D_e, listener_state,
                                  context_attention, D_a, dropout_rec)
        self.dialog_rnn_f = rnn()
        self.dialog_rnn_r = rnn()
        self._make_head(2 * D_e, D_h, n_classes, dropout)

    def forward(self, text: Tensor, qmask: Tensor, umask: Tensor,
                audio: Optional[Tensor] = None,
                visual: Optional[Tensor] = None, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        rate = min(self.dropout + 0.15, 1.0) if train else 0.0
        emotions = bidirectional_dialogue_rnn(
            self.dialog_rnn_f, self.dialog_rnn_r, text, qmask, umask, rate,
            train=train, generator=generator)
        return self._head(emotions, umask, train, generator)
