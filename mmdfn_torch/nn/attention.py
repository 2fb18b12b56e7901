"""The gated fusion head, the relation graph's edge attention and the
sequence attentions of the single-stream heads and the baselines
(``mmdfn_tpu/nn/attention.py`` ``MMGatedAttention``,
``MaskedEdgeAttention``, ``SimpleAttention``, ``MatchingAttention``,
``MultiHeadAttention``), as plain tensor ops.  Parameter names are the
reference's."""

from __future__ import annotations

import math

from typing import Optional

import torch
from torch import nn

from mmdfn_torch.nn.dropout import dropout
from mmdfn_torch.nn.init import reset_linears, reset_uniform
from mmdfn_torch.nn.linear import Linear

Tensor = torch.Tensor


class MMGatedAttention(nn.Module):
    """Gated trimodal fusion, ``att_type='general'`` (``model.py:718-781``):
    pairwise sigmoid gates ``z = sigma(W [x, y, x*y])`` blend the
    tanh-projected modalities; the output concatenates the gated pairs
    (one pair with two modalities).  In training the inputs are dropped at
    the head's own rate, 0.5, not the model's."""

    def __init__(self, mem_dim: int, cand_dim: int, modals: str = "avl",
                 dropout: float = 0.5):
        super().__init__()
        self.modals = modals
        self.dropout = dropout
        for m in "avl":
            if m in modals:
                setattr(self, f"transform_{m}", Linear(mem_dim, cand_dim))
        for pair in ("av", "al", "vl"):
            if pair[0] in modals and pair[1] in modals:
                setattr(self, f"transform_{pair}",
                        Linear(3 * mem_dim, 1))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_linears(self, generator)

    def forward(self, feats: dict, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        x = {m: dropout(f, self.dropout if train else 0.0, generator)
             for m, f in feats.items()}
        h = {m: torch.tanh(getattr(self, f"transform_{m}")(x[m])) for m in x}
        parts = []
        for p, q in ("av", "al", "vl"):
            if p in x and q in x:
                z = torch.sigmoid(getattr(self, f"transform_{p}{q}")(
                    torch.cat([x[p], x[q], x[p] * x[q]], dim=-1)))
                parts.append(z * h[p] + (1 - z) * h[q])
        return torch.cat(parts, dim=-1)


class SimpleAttention(nn.Module):
    """Scalar-scored softmax pooling over a sequence (``model.py:14-29``);
    its ``scalar`` is also the relation graph's attn2 score."""

    def __init__(self, input_dim: int):
        super().__init__()
        self.scalar = Linear(input_dim, 1, bias=False)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_linears(self, generator)

    def forward(self, M: Tensor, mask: Optional[Tensor] = None):
        """M (B, L, D) -> (pooled (B, D), alpha (B, L)); with ``mask`` the
        softmax is renormalised over the valid positions."""
        alpha = torch.softmax(self.scalar(M)[..., 0], dim=-1)
        if mask is not None:
            alpha = alpha * mask
            alpha = alpha / alpha.sum(-1, keepdim=True).clamp(min=1e-12)
        return torch.einsum("bl,bld->bd", alpha, M), alpha


class MatchingAttention(nn.Module):
    """Candidate-conditioned attention over a memory, the reference's four
    score types (``model.py:32-85``), batched over every candidate at
    once: x is (B, D_cand) or (B, T, D_cand), the scores (B, T, L).

    * ``dot``: x . M; ``general``: transform(x) . M (no bias); softmax;
    * ``general2`` (the nodal attention and the baselines' head):
      transform(x) with a bias against the masked memory, the scores
      masked by multiplication before the tanh, softmaxed, masked again
      and renormalised by ``max(sum, 1e-12)``;
    * ``concat``: ``vector_prod(tanh(transform([M, x])))``, softmax.
    """

    def __init__(self, mem_dim: int, cand_dim: int,
                 alpha_dim: Optional[int] = None, att_type: str = "general"):
        super().__init__()
        if att_type not in ("dot", "general", "general2", "concat"):
            raise ValueError(f"att_type {att_type!r}")
        self.att_type = att_type
        if att_type in ("general", "general2"):
            self.transform = Linear(cand_dim, mem_dim,
                                       bias=att_type == "general2")
        elif att_type == "concat":
            self.transform = Linear(cand_dim + mem_dim, alpha_dim,
                                       bias=False)
            self.vector_prod = Linear(alpha_dim, 1, bias=False)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_linears(self, generator)

    def forward(self, M: Tensor, x: Tensor, mask: Optional[Tensor] = None):
        """M (B, L, D_mem), x (B, [T,] D_cand), mask (B, L) -> (pooled
        (B, [T,] D_mem), alpha (B, [T,] L))."""
        squeeze = x.dim() == 2
        if squeeze:
            x = x[:, None]
        if self.att_type == "dot":
            alpha = torch.softmax(x @ M.transpose(1, 2), dim=-1)
        elif self.att_type == "general":
            alpha = torch.softmax(self.transform(x) @ M.transpose(1, 2),
                                  dim=-1)
        elif self.att_type == "general2":
            if mask is None:
                mask = M.new_ones(M.shape[:2])
            m = mask[:, None, :]
            scores = self.transform(x) @ (M * mask[..., None]).transpose(
                1, 2) * m
            alpha = torch.softmax(torch.tanh(scores), dim=-1) * m
            alpha = alpha / alpha.sum(-1, keepdim=True).clamp(min=1e-12)
        else:                                                  # concat
            B, L, _ = M.shape
            T = x.shape[1]
            Mx = torch.cat([M[:, None].expand(B, T, L, M.shape[-1]),
                            x[:, :, None].expand(B, T, L, x.shape[-1])],
                           dim=-1)
            alpha = torch.softmax(self.vector_prod(torch.tanh(
                self.transform(Mx)))[..., 0], dim=-1)
        pooled = alpha @ M
        if squeeze:
            return pooled[:, 0], alpha[:, 0]
        return pooled, alpha


class MultiHeadAttention(nn.Module):
    """Multi-head attention (reference ``model.py:88-165``, the JAX
    package's ``MultiHeadAttention``): ``w_k`` and ``w_q`` project to
    ``n_head`` heads of ``hidden_dim``, scored by ``dot_product``,
    ``scaled_dot_product``, ``mlp`` (``tanh([k | q] @ weight)``) or
    ``bi_linear`` (``q weight k^T``); the heads are concatenated, ``proj``
    maps them to ``out_dim`` and dropout follows.  The scores are
    softmaxed over the keys, or with ``faithful_softmax_dim0`` over the
    fused head-batch axis, as the reference does (``model.py:160``)."""

    def __init__(self, embed_dim: int, hidden_dim: Optional[int] = None,
                 out_dim: Optional[int] = None, n_head: int = 1,
                 score_function: str = "dot_product", dropout: float = 0.0,
                 faithful_softmax_dim0: bool = False):
        super().__init__()
        if score_function not in ("dot_product", "scaled_dot_product",
                                  "mlp", "bi_linear"):
            raise ValueError("invalid score_function")
        self.hidden_dim = hidden_dim or embed_dim // n_head
        self.n_head = n_head
        self.score_function = score_function
        self.dropout = dropout
        self.faithful_softmax_dim0 = faithful_softmax_dim0
        d = self.hidden_dim
        self.w_k = Linear(embed_dim, n_head * d)
        self.w_q = Linear(embed_dim, n_head * d)
        self.proj = Linear(n_head * d, out_dim or embed_dim)
        if score_function == "mlp":
            self.weight = nn.Parameter(torch.empty(2 * d))
        elif score_function == "bi_linear":
            self.weight = nn.Parameter(torch.empty(d, d))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The reference's: ``weight`` U(-1/sqrt(hidden), .), the linears
        torch's defaults."""
        if hasattr(self, "weight"):
            reset_uniform([self.weight], 1.0 / math.sqrt(self.hidden_dim),
                          generator)
        reset_linears(self, generator)

    def forward(self, k: Tensor, q: Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """k (B, Lk, E) and q (B, Lq, E) (or (B, E), one step) -> (out
        (B, Lq, out_dim), scores (n_head B, Lq, Lk))."""
        q = q[:, None] if q.dim() == 2 else q
        k = k[:, None] if k.dim() == 2 else k
        B, Lk, _ = k.shape
        Lq, nh, d = q.shape[1], self.n_head, self.hidden_dim
        # heads to the front: row n = head * B + b
        kx = self.w_k(k).view(B, Lk, nh, d).permute(2, 0, 1, 3) \
            .reshape(nh * B, Lk, d)
        qx = self.w_q(q).view(B, Lq, nh, d).permute(2, 0, 1, 3) \
            .reshape(nh * B, Lq, d)
        if self.score_function == "mlp":
            kq = torch.cat([kx[:, None].expand(-1, Lq, -1, -1),
                            qx[:, :, None].expand(-1, -1, Lk, -1)], dim=-1)
            score = torch.tanh(kq @ self.weight)
        elif self.score_function == "bi_linear":
            score = (qx @ self.weight) @ kx.transpose(1, 2)
        else:
            score = qx @ kx.transpose(1, 2)
            if self.score_function == "scaled_dot_product":
                score = score / math.sqrt(d)
        score = torch.softmax(score, dim=0 if self.faithful_softmax_dim0
                              else -1)
        out = torch.cat((score @ kx).split(B, dim=0), dim=-1)
        out = dropout(self.proj(out), self.dropout if train else 0.0,
                      generator)
        return out, score


class MaskedEdgeAttention(nn.Module):
    """The relation graph's dense edge weights ``w[b, src, dst]``
    (``model.py:420-509``).

    * ``attn1`` (the reference's): a linear map scores every (channel =
      src, position = dst) pair, softmax over positions, the window's edge
      set kept with ``1e-10`` leaking off it into the denominator, and the
      rows renormalized;
    * ``attn2``: each node's scalar score, softmaxed within each source
      row's edge set;
    * ``attn3``: all-ones weights on the edge set (degenerate upstream, as
      the JAX package documents); no parameters.
    """

    def __init__(self, input_dim: int, max_seq_len: int,
                 attn_type: str = "attn1"):
        super().__init__()
        if attn_type not in ("attn1", "attn2", "attn3"):
            raise ValueError(f"edge_attn_type {attn_type!r}")
        self.attn_type = attn_type
        if attn_type == "attn1":
            self.scalar = Linear(input_dim, max_seq_len, bias=False)
        elif attn_type == "attn2":
            self.simpleatt = SimpleAttention(input_dim)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_linears(self, generator)

    def forward(self, M: Tensor, edge_mask: Tensor) -> Tensor:
        L = M.shape[1]
        edge = edge_mask > 0
        if self.attn_type == "attn3":
            return edge_mask
        if self.attn_type == "attn2":
            s = self.simpleatt.scalar(M)[..., 0]                # (B, dst)
            logits = torch.where(edge, s[:, None, :], -1e30)
            return torch.where(edge, torch.softmax(logits, dim=-1), 0.0)
        # (B, pos, channel) -> (B, channel = src, pos = dst)
        alpha = torch.softmax(self.scalar(M).transpose(1, 2), dim=-1)[:, :L]
        masked = alpha * torch.where(edge, 1.0, 1e-10)
        sums = masked.sum(dim=-1, keepdim=True)
        return masked / sums.clamp(min=1e-30) * edge_mask
