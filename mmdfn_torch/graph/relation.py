"""The windowed relation graph of the DialogueGCN-style relation path
(``mmdfn_tpu/graph/relation.py``), dense: a (B, L, L) edge mask and a
(B, L, L) relation-id map, ``[b, src, dst]``."""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def window_edge_mask(umask: Tensor, window_past: int,
                     window_future: int) -> Tensor:
    """(B, L) -> (B, L, L) float edge mask: 1 iff both are valid and ``dst``
    lies in ``[src - window_past, src + window_future]``; a window of -1 is
    unbounded on its side (reference ``model.py:532-550``)."""
    L = umask.shape[1]
    idx = torch.arange(L, device=umask.device)
    delta = idx[None, :] - idx[:, None]          # dst - src
    ok = torch.ones(L, L, dtype=torch.bool, device=umask.device)
    if window_past != -1:
        ok &= delta >= -window_past
    if window_future != -1:
        ok &= delta <= window_future
    m = umask.to(torch.float32)
    return ok[None].to(torch.float32) * m[:, :, None] * m[:, None, :]


def relation_type_ids(qmask: Tensor) -> Tensor:
    """(B, L, P) speaker one-hots -> (B, L, L) relation ids
    ``2 (spk_src P + spk_dst) + dir`` with ``dir = 0`` iff ``src < dst``
    (reference ``model.py:592-598,974-980``): ``2 P^2`` relations."""
    P = qmask.shape[-1]
    spk = qmask.argmax(dim=-1)
    L = spk.shape[1]
    idx = torch.arange(L, device=qmask.device)
    dir_bit = (idx[:, None] >= idx[None, :]).long()
    return 2 * (spk[:, :, None] * P + spk[:, None, :]) + dir_bit[None]
