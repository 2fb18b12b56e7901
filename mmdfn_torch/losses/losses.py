"""Mask-aware losses (``mmdfn_tpu/losses/losses.py``, reference
``code/loss.py``) over padded (..., C) log-probabilities."""

from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor


def focal_loss(log_probs: Tensor, targets: Tensor, mask: Tensor,
               gamma: float = 0.0, alpha: Optional[Tensor] = None) -> Tensor:
    """Focal loss over log-probabilities (reference ``FocalLoss``,
    ``code/loss.py:5-34``): ``pt = exp(logpt)`` is detached (the reference
    wraps it in ``Variable(logpt.data.exp())``, so ``(1 - pt)^gamma``
    carries no gradient); per-class ``alpha`` scales ``logpt``; mean over
    the valid elements."""
    logpt = log_probs.gather(-1, targets[..., None].long())[..., 0]
    pt = logpt.detach().exp()
    if alpha is not None:
        logpt = logpt * alpha[targets.long()]
    loss = -1.0 * (1.0 - pt) ** gamma * logpt
    mask = mask.to(loss.dtype)
    return (loss * mask).sum() / mask.sum().clamp(min=1.0)


def masked_nll_loss(log_probs: Tensor, targets: Tensor, mask: Tensor,
                    weight: Optional[Tensor] = None) -> Tensor:
    """Masked NLL (reference ``MaskedNLLLoss``, ``code/loss.py:38-58``),
    normalised by ``sum(mask)`` or, weighted, ``sum(weight[target] mask)``."""
    logpt = log_probs.gather(-1, targets[..., None].long())[..., 0]
    mask = mask.to(logpt.dtype)
    if weight is None:
        return -(logpt * mask).sum() / mask.sum().clamp(min=1.0)
    w = weight[targets.long()]
    return -(w * logpt * mask).sum() / (w * mask).sum().clamp(min=1e-8)
