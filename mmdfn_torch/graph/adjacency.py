"""The dynamic adjacency constructions (``mmdfn_tpu/graph/adjacency.py``) as
plain tensor ops, as they were plain XLA there: MM-DFN's cross-modal
adjacency (``mm_big_adjacency``) with MMGCN2's arccos variant, MMGCN2's
``mm_graph`` family (``mm_wo_speaker_adjacency``), the single-modality
GCNII block graph and the directed speaker chain of ``GCNLayer1``.

Numerics: ``arccos`` near +/-1 is ill-conditioned, so the cosines are full
f32.  On the card that needs TF32 off for matrix products, which
:func:`mmdfn_torch.device.resolve_device` sees to (the JAX package's
counterpart is ``_cos_precision``, HIGHEST).  Pad rows and columns
are masked before the degree normalization, and the zero-degree guard is a
double ``where`` so ``rsqrt`` never sees 0.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

Tensor = torch.Tensor

_SCALE = 0.99999  # reference multiplies cosines by this before arccos
                  # (model_mm.py:149) to stay inside the arccos domain


def _safe_unit(x: Tensor, dim: int = -1) -> Tensor:
    """L2-normalize, mapping zero vectors (pads) to zero."""
    x = x.to(torch.float32)
    s = (x * x).sum(dim=dim, keepdim=True)
    return x / torch.sqrt(torch.where(s > 0, s, torch.ones_like(s)))


def _safe_arccos(z: Tensor) -> Tensor:
    """arccos with the exact forward value and a gradient clipped away from
    +/-1 (same expression as the JAX package)."""
    zg = z.clamp(-1.0 + 1e-6, 1.0 - 1e-6)
    return torch.arccos(zg) + (torch.arccos(z) - torch.arccos(zg)).detach()


def angular_similarity(cos: Tensor) -> Tensor:
    """``1 - arccos(0.99999 * cos) / pi`` (reference ``model_mm.py:149-151``)."""
    return 1.0 - _safe_arccos((cos * _SCALE).clamp(-1.0, 1.0)) / math.pi


def arccos_similarity(cos: Tensor) -> Tensor:
    """Raw ``arccos(0.99999 * cos)``, without the ``1 - x/pi`` map: the
    MM_GCN2 variant (reference ``model_mm.py:274``), kept as it is."""
    return _safe_arccos((cos * _SCALE).clamp(-1.0, 1.0))


def angular_exact_similarity(cos: Tensor) -> Tensor:
    """``1 - arccos(clamp(cos)) / pi`` without the 0.99999 scale
    (reference ``model_GCN.py:33-41``, ``atom_calculate_edge_weight``)."""
    return 1.0 - _safe_arccos(cos.clamp(-1.0, 1.0)) / math.pi


_SIM = {"angular": angular_similarity, "arccos": arccos_similarity,
        "angular_exact": angular_exact_similarity}


def intra_modal_similarity(x: Tensor, umask: Tensor,
                           variant: str = "angular") -> Tensor:
    """(B, L, D), (B, L) -> (B, L, L) masked pairwise similarity."""
    n = _safe_unit(x)
    cos = n @ n.transpose(1, 2)
    m = umask.to(torch.float32)
    return _SIM[variant](cos) * (m[:, :, None] * m[:, None, :])


def cross_modal_diag_similarity(x: Tensor, y: Tensor, umask: Tensor,
                                variant: str = "angular") -> Tensor:
    """(B, L) similarity between the same utterance in two modalities
    (reference ``model_mm.py:161-167``)."""
    cos = (_safe_unit(x) * _safe_unit(y)).sum(dim=-1)
    return _SIM[variant](cos) * umask.to(torch.float32)


def symmetric_normalize(adj: Tensor, node_mask: Tensor) -> Tensor:
    """``D^-1/2 A D^-1/2`` with a zero-degree guard, pads re-zeroed."""
    d = adj.sum(dim=-1)
    pos = d > 0
    # double where: rsqrt never sees 0 (its gradient would be inf * 0 = nan)
    dinv = torch.where(pos, torch.rsqrt(torch.where(pos, d, torch.ones_like(d))),
                       torch.zeros_like(d))
    out = dinv[..., :, None] * adj * dinv[..., None, :]
    m = node_mask.to(adj.dtype)
    return out * (m[..., :, None] * m[..., None, :])


def mm_big_adjacency(feats: Sequence[Tensor], umask: Tensor,
                     modal_weight: float = 1.0, variant: str = "angular",
                     cross_constant: Optional[float] = None) -> Tensor:
    """The MM-DFN dynamic cross-modal adjacency (``model_mm.py:122-180``).

    Intra-modal blocks are dense similarities, cross-modal blocks
    connect the same utterance across modalities (a diagonal) scaled by
    ``modal_weight``, and the matrix is symmetrically normalized.  Node
    ``m * L + t`` is utterance t of modality m.

    Args:
      feats: M tensors (B, L, D), in the order a, v, l of those present.
      umask: (B, L) validity mask.
      variant: "angular" (MM_GCN) or "arccos" (MM_GCN2).
      cross_constant: if set, the cross-modal diagonal is this constant
        instead of the similarity times ``modal_weight`` (MM_GCN2: 0.99999,
        ``model_mm.py:289``).
    Returns:
      (B, M*L, M*L) float32 normalized adjacency, pads exactly zero.
    """
    M = len(feats)
    B, L = umask.shape
    m1 = umask.to(torch.float32)
    eye = torch.eye(L, dtype=torch.float32, device=umask.device)
    rows = []
    for i in range(M):
        blocks = []
        for j in range(M):
            if i == j:
                blocks.append(intra_modal_similarity(feats[i], umask,
                                                     variant))
            elif cross_constant is not None:
                blocks.append(cross_constant * m1[:, :, None] * eye[None])
            else:
                dia = cross_modal_diag_similarity(
                    feats[i], feats[j], umask, variant) * modal_weight
                blocks.append(dia[:, :, None] * eye[None])
        rows.append(torch.cat(blocks, dim=2))
    adj = torch.cat(rows, dim=1)
    return symmetric_normalize(adj, m1.repeat(1, M))


WINDOW = 10   # MM_GCN2's cross-modal window (model_mm.py:352)


def cross_mask(scheme: str, L: int, a: int, b: int,
               device=None) -> Tensor:
    """(L, L) bool: the cross-modal edges of ``mm_wo_speaker_adjacency``'s
    block (a, b), a != b, rows utterance j of modality a, columns
    utterance pin of modality b: "single" j = pin, "window" the band ``pin
    - j`` in [-w, w-1] (w = ``WINDOW``) from the lower-indexed modality to
    the higher, "fc" every ``j <= pin`` from the lower; the block from the
    higher to the lower is its transpose."""
    i = torch.arange(L, device=device)
    delta = i[:, None] - i[None, :]
    if scheme == "single":
        lo_hi = delta == 0
    elif scheme == "window":
        lo_hi = (delta <= WINDOW) & (delta >= -(WINDOW - 1))
    else:
        lo_hi = delta <= 0
    return lo_hi if a < b else lo_hi.t()


def mm_wo_speaker_adjacency(feats: Sequence[Tensor], umask: Tensor,
                            scheme: str = "single") -> Tensor:
    """MMGCN2's ``mm_graph`` cross-modal adjacency
    (``MM_GCN2.message_passing_wo_speaker``, ``model_mm.py:298-477``), as
    the JAX package completes it (``mmdfn_tpu/graph/adjacency.py:196``):
    every modality block is the identity plus dense angular-exact
    similarity edges within the dialogue; the cross-modal edges between
    the lower- and the higher-indexed modality follow ``scheme``:
    "single" the same utterance, "window" the band ``pin - j`` in
    [-w, w-1] (w = ``WINDOW``), "fc" every ``j <= pin``, each mirrored.

    Returns:
      (B, M*L, M*L) float32 normalized adjacency, pads exactly zero.
    """
    if scheme not in ("single", "window", "fc"):
        raise ValueError(f"mm_graph scheme must be single/window/fc, "
                         f"got {scheme!r}")
    M = len(feats)
    B, L = umask.shape
    m1 = umask.to(torch.float32)
    pm = m1[:, :, None] * m1[:, None, :]
    i = torch.arange(L, device=umask.device)
    delta = i[:, None] - i[None, :]
    eye = (delta == 0).to(torch.float32)
    units = [_safe_unit(f) for f in feats]
    rows = []
    for a in range(M):
        blocks = []
        for b in range(M):
            sim = angular_exact_similarity(
                units[a] @ units[b].transpose(1, 2)) * pm
            if a == b:
                blocks.append(torch.where(delta != 0, sim, 0.0)
                              + eye[None] * m1[:, :, None])
            else:
                blocks.append(torch.where(
                    cross_mask(scheme, L, a, b, umask.device), sim, 0.0))
        rows.append(torch.cat(blocks, dim=2))
    adj = torch.cat(rows, dim=1)
    return symmetric_normalize(adj, m1.repeat(1, M))


def gcnii_block_adjacency(x: Tensor, umask: Tensor) -> Tensor:
    """The single-modality per-dialogue dense angular graph of the GCNII
    baseline (``GCNII.create_big_adj``, ``model_GCN.py:287-310``):
    (B, L, L)."""
    return symmetric_normalize(intra_modal_similarity(x, umask), umask)


def window_relation_adjacency(x: Tensor, umask: Tensor, window: int = 10,
                              variant: str = "angular_exact") -> Tensor:
    """The windowed-clique graph (``message_passing_relation_graph``,
    ``model_GCN.py:386-409``, ``model_mm.py:527-550``): the reference's
    union over every centre k of the pairs inside ``[k-w, k+w]`` is every
    pair with ``0 < |i - j| <= 2w``, weighted by their similarity, plus
    the identity, normalized: (B, L, L)."""
    L = umask.shape[1]
    i = torch.arange(L, device=umask.device)
    dist = (i[:, None] - i[None, :]).abs()
    in_window = (dist > 0) & (dist <= 2 * window)
    n = _safe_unit(x)
    sim = _SIM[variant](n @ n.transpose(1, 2))
    m1 = umask.to(torch.float32)
    adj = torch.where(in_window, sim, 0.0) * (m1[:, :, None] * m1[:, None, :])
    adj = adj + torch.eye(L, device=umask.device)[None] * m1[:, :, None]
    return symmetric_normalize(adj, umask)


def directed_speaker_adjacency(x: Tensor, qmask: Tensor,
                               umask: Tensor) -> Tensor:
    """The speaker chain of ``GCNLayer1``, unnormalized
    (``message_passing_directed_speaker``, ``model_GCN.py:85-118``): the
    identity plus edges, both ways, between consecutive utterances of one
    chain, weighted by their angular-exact similarity.  The chains are
    binary, speaker 0 against everyone else, whatever the number of
    speakers, as in the reference.

    Returns:
      (B, L, L) float32.
    """
    B, L, _ = qmask.shape
    t = torch.arange(L, device=x.device)
    valid = umask[:, None, :] > 0                            # (B, 1, L)
    is_spk0 = (qmask[:, :, 0][:, None, :] > 0) & valid
    is_p = torch.cat([is_spk0, ~is_spk0 & valid], dim=1)     # (B, 2, L)
    # each chain's members in time order, then everyone else
    perm = torch.argsort(torch.where(is_p, t, t + L), dim=-1, stable=True)
    counts = is_p.sum(dim=-1)                                # (B, 2)
    src, dst = perm[..., :-1], perm[..., 1:]
    pair = torch.arange(L - 1, device=x.device) < (counts[..., None] - 1)
    n = _safe_unit(x)
    take = lambda idx: torch.gather(
        n[:, None].expand(B, 2, L, n.shape[-1]), 2,
        idx[..., None].expand(*idx.shape, n.shape[-1]))
    sim = angular_exact_similarity((take(src) * take(dst)).sum(dim=-1))
    vals = torch.where(pair, sim, 0.0)
    src, dst = torch.where(pair, src, 0), torch.where(pair, dst, 0)
    b = torch.arange(B, device=x.device)[:, None, None].expand_as(src)
    adj = torch.eye(L, device=x.device)[None] * umask[:, :, None]
    # a scatter-add, as the JAX package's ``.at[].add``: pairs that do not
    # exist add 0 at (0, 0)
    adj = adj.index_put((b, src, dst), vals, accumulate=True)
    return adj.index_put((b, dst, src), vals, accumulate=True)
