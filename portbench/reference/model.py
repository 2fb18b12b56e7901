"""MM-DFN (Hu et al., "MM-DFN: Multimodal Dynamic Fusion Network for
Emotion Recognition in Conversations", ICASSP 2022) with the GDF graph and
the reason-LSTM, written out in plain PyTorch over a leading axis of
configurations: every parameter is (Kb, ...), the batch is shared.

Its parameters carry the names of the published model's ``state_dict``
(``linear_a``, ``lstm_l``, ``rnn_parties``, ``graph_model.graph_net``,
``smax_fc``).  The forward:

* each modality projected to 200 (``linear_a/v/l``);
* the text through a 2-layer bidirectional GRU (``lstm_l``, hidden 100),
  a masked frame carrying the state unchanged, dropout between the layers;
* the speaker encoder: one shared 2-layer bi-GRU (``rnn_parties``) over
  every (modality, dialogue, party) stream, each visiting the frames of
  its party alone; its outputs summed over the parties and added to each
  modality with its speaker weight;
* the dynamic cross-modal graph: per modality the angular similarity
  ``1 - arccos(0.99999 cos) / pi`` between utterances, between modalities
  the same utterance's similarity times the modal weight, pads masked,
  then ``D^-1/2 A D^-1/2``;
* the GCNII stack over the 3L nodes: dropout on the input, ``fcs.0`` and
  ReLU give h0, dropout gives h; per layer l = 1..n, theta_l = log(lamda /
  l + 1): the shared LSTM step on h (its state carried across layers),
  ``hi = adj @ h``, ``theta_l [hi | h0] W_l + (1 - theta_l) ((1 - alpha)
  hi + alpha h0)``, ReLU, dropout from Philox, plus the layer's input;
* the dropped input and the stack's output side by side, re-split per
  modality, dropout, ReLU, ``smax_fc``, log-softmax.

Dropout: every site but the stack's layers draws ``torch.rand`` from the
step's generator in the order above, one draw for every configuration,
and keeps where the draw is below the configuration's keep probability;
the stack's layers keep where Philox's bits (:mod:`.philox`) lie below
the configuration's keep threshold, under a seed drawn from the same
generator after the stack's two entry draws.  A kept value is scaled by
1 / keep.  ``Draws`` records the draws of one step, so that blocks of
configurations computed one after another share them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from portbench.reference import philox

Tensor = torch.Tensor


class Draws:
    """A step's dropout draws, in the order the forward asks for them:
    drawn from the generator by the first block, handed out again to the
    next."""

    def __init__(self, generator: Optional[torch.Generator], device):
        self.generator, self.device = generator, device
        self.made: List[Tensor] = []
        self.i = 0

    def _next(self, make):
        if self.i == len(self.made):
            self.made.append(make())
        out = self.made[self.i]
        self.i += 1
        return out

    def rand(self, shape) -> Tensor:
        out = self._next(lambda: torch.rand(shape, generator=self.generator,
                                            device=self.device))
        assert tuple(out.shape) == tuple(shape)
        return out

    def seed(self) -> int:
        t = self._next(lambda: torch.randint(
            0, 1 << 62, (1,), generator=self.generator, device=self.device))
        return 0 if t.device.type == "meta" else int(t[0])

    def rewind(self) -> None:
        self.i = 0


class Rates:
    """Each configuration's dropout rate as the forward applies it: the
    keep probability and scale in f32 (worked out in float64, rounded
    once) and Philox's keep threshold, as (Kb, 1, ...) columns."""

    def __init__(self, rates: Sequence[float], device):
        r = np.asarray(rates, np.float64)
        col = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
        self.keep = col((1.0 - r).astype(np.float32), torch.float32)
        self.scale = col((1.0 / (1.0 - r)).astype(np.float32), torch.float32)
        self.thresh = col(np.asarray([philox.threshold(x) for x in r]),
                          torch.int64)

    def view(self, t: Tensor, ndim: int) -> Tensor:
        return t.reshape(-1, *([1] * (ndim - 1)))


def param_shapes(widths: dict, nlayers: int) -> Dict[str, tuple]:
    """Every parameter's shape, in the published model's ``state_dict``
    order."""
    H, D, G = (widths["encoder_hidden"], widths["hidden_modality"],
               widths["graph_hidden"])
    dims = {"a": widths["D_audio"], "v": widths["D_visual"],
            "l": widths["D_text"]}
    out = {}
    for m, d in dims.items():
        out[f"linear_{m}.weight"] = (D, d)
        out[f"linear_{m}.bias"] = (D,)
    for pre in ("lstm_l", "rnn_parties"):
        for layer in (0, 1):
            for r in ("", "_reverse"):
                out[f"{pre}.weight_ih_l{layer}{r}"] = (3 * H, D)
                out[f"{pre}.weight_hh_l{layer}{r}"] = (3 * H, H)
                out[f"{pre}.bias_ih_l{layer}{r}"] = (3 * H,)
                out[f"{pre}.bias_hh_l{layer}{r}"] = (3 * H,)
    g = "graph_model.graph_net"
    out[f"{g}.fcs.0.weight"] = (G, D)
    out[f"{g}.fcs.0.bias"] = (G,)
    for l in range(nlayers):
        out[f"{g}.convs.{l}.weight"] = (2 * G, G)
    out[f"{g}.rnn.weight_ih_l0"] = (4 * G, G)
    out[f"{g}.rnn.weight_hh_l0"] = (4 * G, G)
    out[f"{g}.rnn.bias_ih_l0"] = (4 * G,)
    out[f"{g}.rnn.bias_hh_l0"] = (4 * G,)
    out["smax_fc.weight"] = (widths["n_classes"], 3 * (D + G))
    out["smax_fc.bias"] = (widths["n_classes"],)
    return out


def ref_config(conf: dict) -> dict:
    """What the forward reads of a configuration file."""
    m = conf["model"]
    return dict(speaker_weights=m["speaker_weights"],
                modal_weight=m.get("modal_weight", 1.0),
                Deep_GCN_nlayers=m["Deep_GCN_nlayers"], alpha=m["alpha"],
                lamda=m["lamda"])


def class_weights(conf: dict, device) -> Optional[Tensor]:
    """The focal loss's per-class alpha: the inverse of the published class
    frequencies, where the configuration weights its classes."""
    if not conf["model"].get("class_weight"):
        return None
    w = np.asarray([1.0 / f for f in conf["class_frequencies"]], np.float32)
    return torch.as_tensor(w, device=device)


def _dropout(x: Tensor, draws: Draws, rates: Rates) -> Tensor:
    """x: (Kb, *shape); one draw of ``shape`` for every configuration."""
    u = draws.rand(x.shape[1:])
    keep = u[None] < rates.view(rates.keep, x.dim())
    return torch.where(keep, x * rates.view(rates.scale, x.dim()), 0.0)


def linear(x: Tensor, W: Tensor, b: Tensor) -> Tensor:
    """x (Kb, ..., in), W (Kb, out, in), b (Kb, out)."""
    Kb = W.shape[0]
    lead = x.shape[1:-1]
    y = torch.bmm(x.reshape(Kb, -1, x.shape[-1]), W.transpose(1, 2))
    return (y + b[:, None, :]).reshape(Kb, *lead, W.shape[1])


def _gru_layer(xs: Tensor, p: Dict[str, Tensor], pre: str, layer: int,
               mask: Tensor) -> Tensor:
    """One bidirectional GRU layer: xs (Kb, S, L, D), mask (S, L) bool ->
    (Kb, S, L, 2H); both directions stepped together."""
    Kb, S, L, _ = xs.shape
    w = lambda n, d: p[f"{pre}.{n}_l{layer}{d}"]
    xg = [linear(xs, w("weight_ih", d), w("bias_ih", d)) for d in
          ("", "_reverse")]
    xg = torch.stack([xg[0], xg[1].flip(2)], dim=1)     # (Kb, 2, S, L, 3H)
    Whh = torch.stack([w("weight_hh", ""), w("weight_hh", "_reverse")], 1)
    bhh = torch.stack([w("bias_hh", ""), w("bias_hh", "_reverse")], 1)
    H = Whh.shape[-1]
    gate = torch.stack([mask, mask.flip(1)])[None, :, :, :, None]
    h = xs.new_zeros(Kb, 2, S, H)
    ys = []
    for t in range(L):
        hg = torch.einsum("kdsh,kdgh->kdsg", h, Whh) + bhh[:, :, None, :]
        x_t = xg[:, :, :, t]
        r = torch.sigmoid(x_t[..., :H] + hg[..., :H])
        z = torch.sigmoid(x_t[..., H:2 * H] + hg[..., H:2 * H])
        n = torch.tanh(x_t[..., 2 * H:] + r * hg[..., 2 * H:])
        h = torch.where(gate[:, :, :, t], (1.0 - z) * n + z * h, h)
        ys.append(h)
    ys = torch.stack(ys, dim=3)                         # (Kb, 2, S, L, H)
    return torch.cat([ys[:, 0], ys[:, 1].flip(2)], dim=-1)


def bigru(xs: Tensor, p: Dict[str, Tensor], pre: str, mask: Tensor,
          draws: Optional[Draws], rates: Optional[Rates]) -> Tensor:
    out = _gru_layer(xs, p, pre, 0, mask)
    if draws is not None:
        out = _dropout(out, draws, rates)
    return _gru_layer(out, p, pre, 1, mask)


def _unit(x: Tensor) -> Tensor:
    s = (x * x).sum(-1, keepdim=True)
    return x / torch.sqrt(torch.where(s > 0, s, torch.ones_like(s)))


def _angular(cos: Tensor) -> Tensor:
    """``1 - arccos(0.99999 cos) / pi``; arccos's gradient taken at the
    argument clipped to 1 - 1e-6 in magnitude, its value exact."""
    z = (cos * 0.99999).clamp(-1.0, 1.0)
    zc = z.clamp(-1.0 + 1e-6, 1.0 - 1e-6)
    ac = torch.arccos(zc) + (torch.arccos(z) - torch.arccos(zc)).detach()
    return 1.0 - ac / math.pi


def adjacency(feats: Sequence[Tensor], umask: Tensor,
              modal_weight: float = 1.0) -> Tensor:
    """MM-DFN's cross-modal graph over M modalities: (Kb, B, ML, ML)."""
    M = len(feats)
    B, L = umask.shape
    m = umask.to(torch.float32)
    pair = m[:, :, None] * m[:, None, :]
    eye = torch.eye(L, device=umask.device)
    units = [_unit(f) for f in feats]
    rows = []
    for i in range(M):
        row = []
        for j in range(M):
            if i == j:
                cos = units[i] @ units[i].transpose(-1, -2)
                row.append(_angular(cos) * pair)
            else:
                cos = (units[i] * units[j]).sum(-1)
                dia = _angular(cos) * m * modal_weight
                row.append(dia[..., :, None] * eye)
        rows.append(torch.cat(row, dim=-1))
    adj = torch.cat(rows, dim=-2)
    node = m.repeat(1, M)
    deg = adj.sum(-1)
    pos = deg > 0
    dinv = torch.where(pos, torch.rsqrt(torch.where(pos, deg,
                                                    torch.ones_like(deg))),
                       torch.zeros_like(deg))
    adj = dinv[..., :, None] * adj * dinv[..., None, :]
    return adj * (node[:, :, None] * node[:, None, :])


def gcnii(x: Tensor, adj: Tensor, p: Dict[str, Tensor], pre: str,
          nlayers: int, alpha: float, lamda: float,
          draws: Optional[Draws], rates: Optional[Rates]):
    """The GCNII stack with the reason-LSTM: returns (the input as dropped,
    the last layer's h)."""
    if draws is not None:
        x = _dropout(x, draws, rates)
    h0 = torch.relu(linear(x, p[f"{pre}.fcs.0.weight"],
                           p[f"{pre}.fcs.0.bias"]))
    h = _dropout(h0, draws, rates) if draws is not None else h0
    keep = None
    Kb, B, N, H = h.shape
    if draws is not None:
        bits = philox.bits(draws.seed(), nlayers, B, N, H, h.device)
        # (Kb, nl, B, N, H); a keep scale of exactly 1 (rate 0) keeps all
        keep = ((bits[None] < rates.view(rates.thresh, 5))
                | (rates.view(rates.scale, 5) == 1.0))
        scale = rates.view(rates.scale, 4)
    W_ih = p[f"{pre}.rnn.weight_ih_l0"].transpose(1, 2)[:, None]
    W_hh = p[f"{pre}.rnn.weight_hh_l0"].transpose(1, 2)[:, None]
    b = (p[f"{pre}.rnn.bias_ih_l0"] + p[f"{pre}.rnn.bias_hh_l0"])[
        :, None, None]
    theta = torch.log(lamda / torch.arange(1, nlayers + 1,
                                           dtype=torch.float32) + 1.0)
    lh = torch.zeros_like(h)
    lc = torch.zeros_like(h)
    for l in range(nlayers):
        q = h
        g = h @ W_ih + lh @ W_hh + b
        i, f, gg, o = g.chunk(4, dim=-1)
        lc = torch.sigmoid(f) * lc + torch.sigmoid(i) * torch.tanh(gg)
        lh = torch.sigmoid(o) * torch.tanh(lc)
        hi = adj @ lh
        W = p[f"{pre}.convs.{l}.weight"][:, None]     # (Kb, 1, 2H, H)
        support = hi @ W[..., :H, :] + h0 @ W[..., H:, :]
        t = float(theta[l])
        pre_act = t * support + (1.0 - t) * ((1.0 - alpha) * hi + alpha * h0)
        h = torch.relu(pre_act)
        if keep is not None:
            h = torch.where(keep[:, l], h * scale, 0.0)
        h = h + q
    return x, h


def forward(p: Dict[str, Tensor], cfg: dict, text: Tensor, audio: Tensor,
            visual: Tensor, qmask: Tensor, umask: Tensor,
            draws: Optional[Draws] = None,
            rates: Optional[Rates] = None) -> Tensor:
    """Per-utterance log-probs (Kb, B, L, C) of the Kb configurations in
    ``p``; ``draws`` (with ``rates``) makes it the training forward."""
    B, L = umask.shape
    valid = umask > 0
    Kb = p["smax_fc.weight"].shape[0]
    proj = {m: linear(x.expand(Kb, *x.shape), p[f"linear_{m}.weight"],
                      p[f"linear_{m}.bias"])
            for m, x in (("a", audio), ("v", visual), ("l", text))}
    base = dict(proj)
    base["l"] = bigru(proj["l"], p, "lstm_l", valid, draws, rates)
    # the speaker streams: (modality, dialogue, party), each over its
    # party's frames
    P = qmask.shape[-1]
    is_p = (qmask.transpose(1, 2) > 0) & valid[:, None, :]    # (B, P, L)
    order = "avl"
    x = torch.cat([proj[m] for m in order], dim=1)            # (Kb, 3B, L, D)
    D = x.shape[-1]
    streams = x[:, :, None].expand(Kb, 3 * B, P, L, D).reshape(
        Kb, 3 * B * P, L, D)
    mask = is_p.repeat(3, 1, 1).reshape(3 * B * P, L)
    E = bigru(streams, p, "rnn_parties", mask, draws, rates)
    E = E.reshape(Kb, 3 * B, P, L, -1)
    delta = torch.where(is_p.repeat(3, 1, 1)[None, ..., None], E,
                        torch.zeros_like(E)).sum(2)          # (Kb, 3B, L, .)
    sw = [float(s) for s in cfg["speaker_weights"].split("-")]
    emo = [base[m] + sw[i] * delta[:, i * B:(i + 1) * B]
           for i, m in enumerate(order)]
    adj = adjacency(emo, umask, cfg.get("modal_weight", 1.0))
    x_in, h = gcnii(torch.cat(emo, dim=2), adj, p, "graph_model.graph_net",
                    cfg["Deep_GCN_nlayers"], cfg["alpha"], cfg["lamda"],
                    draws, rates)
    both = torch.cat([x_in, h], dim=-1)                      # (Kb, B, 3L, .)
    feat = torch.cat([both[:, :, i * L:(i + 1) * L] for i in range(3)], -1)
    if draws is not None:
        feat = _dropout(feat, draws, rates)
    feat = torch.relu(feat)
    return torch.log_softmax(linear(feat, p["smax_fc.weight"],
                                    p["smax_fc.bias"]), dim=-1)


def focal_loss(logp: Tensor, label: Tensor, umask: Tensor,
               gammas: Sequence[float], alpha: Optional[Tensor]) -> Tensor:
    """Each configuration's focal loss (Kb,): ``-(1 - pt)^gamma alpha_y
    log pt`` over the valid utterances, their mean; ``pt`` carries no
    gradient."""
    Kb = logp.shape[0]
    y = label.long()
    logpt = logp.gather(-1, y.expand(Kb, *y.shape)[..., None])[..., 0]
    pt = logpt.detach().exp()
    if alpha is not None:
        logpt = logpt * alpha[y]
    weight = torch.stack([(1.0 - pt[k]) ** float(g)
                          for k, g in enumerate(gammas)])
    m = umask.to(logpt.dtype)
    return -(weight * logpt * m).sum((1, 2)) / m.sum().clamp(min=1.0)
