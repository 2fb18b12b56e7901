"""Mask helpers (``mmdfn_tpu/utils/masking.py``) for left-contiguous masks:
every real utterance precedes the padding."""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def lengths_from_mask(umask: Tensor) -> Tensor:
    """(B, L) 0/1 mask -> (B,) int64 lengths."""
    return (umask > 0).sum(dim=-1)


def mask_from_lengths(lengths: Tensor, max_len: int) -> Tensor:
    """(B,) lengths -> (B, max_len) float mask."""
    pos = torch.arange(max_len, device=lengths.device)[None, :]
    return (pos < lengths[:, None]).to(torch.float32)


def pair_mask(umask: Tensor) -> Tensor:
    """(B, L) -> (B, L, L) outer-product validity mask for adjacencies."""
    m = umask.to(torch.float32)
    return m[:, :, None] * m[:, None, :]


def flip_valid(x: Tensor, umask: Tensor) -> Tensor:
    """Reverse each sequence within its valid prefix, pads left in place
    (the reference's ``_reverse_seq``, ``model.py:1008-1017``): position t
    reads ``len - 1 - t`` for ``t < len`` and itself otherwise.  One
    ``torch.gather`` along time; x is (B, L, ...)."""
    B, L = x.shape[:2]
    n = lengths_from_mask(umask)[:, None]
    t = torch.arange(L, device=x.device)[None]
    src = torch.where(t < n, n - 1 - t, t)                     # (B, L)
    src = src.reshape(B, L, *([1] * (x.dim() - 2))).expand(x.shape)
    return x.gather(1, src)
