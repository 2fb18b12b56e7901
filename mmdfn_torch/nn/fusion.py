"""The fusion heads MFN, TFN and LMF (``mmdfn_tpu/nn/fusion.py``, reference
``code/model_fusion.py``), as plain tensor ops: the JAX package runs them
without a Pallas kernel too.  Parameter names are the reference's."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from mmdfn_torch.nn.dropout import dropout
from mmdfn_torch.nn.init import reset_linears, reset_uniform
from mmdfn_torch.nn.linear import Linear

Tensor = torch.Tensor


class MFN(nn.Module):
    """Memory Fusion Network over (B, L, 3 d) sequences, the modalities in
    the order l, a, v -> (B, L, 3 dh + mem) (reference
    ``model_fusion.py:10-120``): three LSTM cells, the cross-view
    Delta-memory attention and the gated memory, as a time loop.  The
    attention and gate layers drop their hidden ReLU outputs at their own
    rates (0.2) in training."""

    d, dh, mem_dim, h_att, h_gamma = 300, 100, 100, 100, 100
    att_dropout = gamma_dropout = 0.2

    def __init__(self):
        super().__init__()
        d, dh = self.d, self.dh
        for m in "lav":
            setattr(self, f"lstm_{m}", nn.LSTMCell(d, dh))
        att_in = 2 * 3 * dh
        self.att1_fc1 = Linear(att_in, self.h_att)
        self.att1_fc2 = Linear(self.h_att, att_in)
        self.att2_fc1 = Linear(att_in, self.h_att)
        self.att2_fc2 = Linear(self.h_att, self.mem_dim)
        self.gamma1_fc1 = Linear(att_in + self.mem_dim, self.h_gamma)
        self.gamma1_fc2 = Linear(self.h_gamma, self.mem_dim)
        self.gamma2_fc1 = Linear(att_in + self.mem_dim, self.h_gamma)
        self.gamma2_fc2 = Linear(self.h_gamma, self.mem_dim)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """torch defaults: the LSTM cells U(-1/sqrt(dh), .), the linears
        U(-1/sqrt(in), .)."""
        k = 1.0 / math.sqrt(self.dh)
        for m in "lav":
            reset_uniform(getattr(self, f"lstm_{m}").parameters(), k,
                          generator)
        reset_linears(self, generator)

    @staticmethod
    def _cell(cell: nn.LSTMCell, x: Tensor, h: Tensor, c: Tensor):
        g = x @ cell.weight_ih.t() + cell.bias_ih + h @ cell.weight_hh.t() \
            + cell.bias_hh
        i, f, gg, o = g.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
        return torch.sigmoid(o) * torch.tanh(c), c

    def forward(self, x: Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        B, L, D = x.shape
        if D != 3 * self.d:
            raise ValueError(f"MFN takes 3 x {self.d} features, got {D}")
        drop = lambda v, rate: dropout(v, rate if train else 0.0, generator)
        mlp = lambda fc1, fc2, v, rate: fc2(drop(torch.relu(fc1(v)), rate))
        cells = [getattr(self, f"lstm_{m}") for m in "lav"]
        hs = [x.new_zeros(B, self.dh) for _ in range(3)]
        cs = [x.new_zeros(B, self.dh) for _ in range(3)]
        mem = x.new_zeros(B, self.mem_dim)
        out = []
        for t in range(L):
            xs = x[:, t].split(self.d, dim=-1)
            prev = torch.cat(cs, dim=-1)
            for j in range(3):
                hs[j], cs[j] = self._cell(cells[j], xs[j], hs[j], cs[j])
            c_star = torch.cat([prev, *cs], dim=-1)
            attention = torch.softmax(mlp(self.att1_fc1, self.att1_fc2,
                                          c_star, self.att_dropout), dim=-1)
            attended = attention * c_star
            c_hat = torch.tanh(mlp(self.att2_fc1, self.att2_fc2, attended,
                                   self.att_dropout))
            both = torch.cat([attended, mem], dim=-1)
            gamma1 = torch.sigmoid(mlp(self.gamma1_fc1, self.gamma1_fc2,
                                       both, self.gamma_dropout))
            gamma2 = torch.sigmoid(mlp(self.gamma2_fc1, self.gamma2_fc2,
                                       both, self.gamma_dropout))
            mem = gamma1 * mem + gamma2 * c_hat
            out.append(torch.cat([*hs, mem], dim=-1))
        return torch.stack(out, dim=1)


def _with_one(x: Tensor) -> Tensor:
    return torch.cat([x.new_ones(*x.shape[:-1], 1), x], dim=-1)


class TFN(nn.Module):
    """Tensor Fusion Network (reference ``model_fusion.py:123-211``): the
    outer product of the three ``[1, projection]`` vectors (101^3 floats an
    utterance), dropout 0.4 in training, two ReLU layers; ``input_dim``
    wide inputs."""

    hidden, dropouts, post_fusion_dim, output_dim = 100, 0.4, 300, 300

    def __init__(self, input_dim: int):
        super().__init__()
        h = self.hidden
        self.audio_subnet = Linear(input_dim, h)
        self.video_subnet = Linear(input_dim, h)
        self.text_subnet = Linear(input_dim, h)
        self.post_fusion_layer_1 = Linear((h + 1) ** 3,
                                             self.post_fusion_dim)
        self.post_fusion_layer_2 = Linear(self.post_fusion_dim,
                                             self.output_dim)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_linears(self, generator)

    def forward(self, audio: Tensor, video: Tensor, text: Tensor, *,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        a = _with_one(self.audio_subnet(audio))
        v = _with_one(self.video_subnet(video))
        t = _with_one(self.text_subnet(text))
        fusion = torch.einsum("...a,...v,...t->...avt", a, v, t)
        fusion = fusion.reshape(*fusion.shape[:-3], -1)
        fusion = dropout(fusion, self.dropouts if train else 0.0, generator)
        out = torch.relu(self.post_fusion_layer_1(fusion))
        return torch.relu(self.post_fusion_layer_2(out))


class LMF(nn.Module):
    """Low-rank Multimodal Fusion (reference ``model_fusion.py:214-310``):
    per-modality rank factors over ``[1, projection]``, their product, and
    the rank's weighted sum plus a bias; ``input_dim`` wide inputs."""

    hidden, output_dim, rank = 300, 300, 4

    def __init__(self, input_dim: int):
        super().__init__()
        h, out = self.hidden, self.output_dim
        self.audio_subnet = Linear(input_dim, h)
        self.video_subnet = Linear(input_dim, h)
        self.text_subnet = Linear(input_dim, h)
        for name in ("audio", "video", "text"):
            setattr(self, f"{name}_factor", nn.Parameter(
                torch.empty(self.rank, h + 1, out)))
        self.fusion_weights = nn.Parameter(torch.empty(1, self.rank))
        self.fusion_bias = nn.Parameter(torch.zeros(1, out))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The subnets torch's linear default; the factors and the fusion
        weights xavier-normal, the bias 0 (``model_fusion.py:268-271``)."""
        reset_linears(self, generator)
        with torch.no_grad():
            for p in (self.audio_factor, self.video_factor,
                      self.text_factor, self.fusion_weights):
                # torch's fans: dim 1 (times the rest) in, dim 0 out
                rf = math.prod(p.shape[2:])
                std = math.sqrt(2.0 / (p.shape[1] * rf + p.shape[0] * rf))
                p.normal_(0.0, std, generator=generator)
            self.fusion_bias.zero_()

    def forward(self, audio: Tensor, video: Tensor, text: Tensor, *,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        fa = torch.einsum("...i,rio->r...o", _with_one(
            self.audio_subnet(audio)), self.audio_factor)
        fv = torch.einsum("...i,rio->r...o", _with_one(
            self.video_subnet(video)), self.video_factor)
        ft = torch.einsum("...i,rio->r...o", _with_one(
            self.text_subnet(text)), self.text_factor)
        return torch.einsum("r,r...o->...o", self.fusion_weights[0],
                            fa * fv * ft) + self.fusion_bias[0]
