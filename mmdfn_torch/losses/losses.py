"""Mask-aware losses (``mmdfn_tpu/losses/losses.py``, reference
``code/loss.py``) over padded (..., C) log-probabilities.

Each is a sum over the valid elements over a denominator.  Under data
parallelism each rank holds a block of the batch: ``global_sum`` then sums
the block's denominator over the ranks, so that every rank divides by the
whole batch's, the ranks' losses add up to the batch's loss and their
gradients to its gradient (a rank of padding alone adds zero to both)."""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import torch

Tensor = torch.Tensor


def _same(t: Tensor) -> Tensor:
    return t


def focal_loss(log_probs: Tensor, targets: Tensor, mask: Tensor,
               gamma: Union[float, Tuple[Sequence[float], Tensor]] = 0.0,
               alpha: Optional[Tensor] = None,
               global_sum: Callable[[Tensor], Tensor] = _same) -> Tensor:
    """Focal loss over log-probabilities (reference ``FocalLoss``,
    ``code/loss.py:5-34``): ``pt = exp(logpt)`` is detached (the reference
    wraps it in ``Variable(logpt.data.exp())``, so ``(1 - pt)^gamma``
    carries no gradient); per-class ``alpha`` scales ``logpt``; mean over
    the valid elements.

    ``gamma`` may be ``(values, index)``: the grouped sweep's gamma per
    configuration, ``values[index]`` (index an int tensor, 0-d under
    ``vmap``), each ``(1 - pt) ** value`` computed with its Python
    exponent, as a run alone computes it, and the configuration's picked."""
    logpt = log_probs.gather(-1, targets[..., None].long())[..., 0]
    pt = logpt.detach().exp()
    if alpha is not None:
        logpt = logpt * alpha[targets.long()]
    if isinstance(gamma, tuple):
        values, index = gamma
        weight = (1.0 - pt) ** values[0]
        for j, g in enumerate(values[1:], 1):
            weight = torch.where(index == j, (1.0 - pt) ** g, weight)
    else:
        weight = (1.0 - pt) ** gamma
    loss = -1.0 * weight * logpt
    mask = mask.to(loss.dtype)
    return (loss * mask).sum() / global_sum(mask.sum()).clamp(min=1.0)


def masked_nll_loss(log_probs: Tensor, targets: Tensor, mask: Tensor,
                    weight: Optional[Tensor] = None,
                    global_sum: Callable[[Tensor], Tensor] = _same
                    ) -> Tensor:
    """Masked NLL (reference ``MaskedNLLLoss``, ``code/loss.py:38-58``),
    normalised by ``sum(mask)`` or, weighted, ``sum(weight[target] mask)``."""
    logpt = log_probs.gather(-1, targets[..., None].long())[..., 0]
    mask = mask.to(logpt.dtype)
    if weight is None:
        return -(logpt * mask).sum() / global_sum(mask.sum()).clamp(min=1.0)
    w = weight[targets.long()]
    return -(w * logpt * mask).sum() / global_sum(
        (w * mask).sum()).clamp(min=1e-8)


def masked_mse_loss(pred: Tensor, target: Tensor, mask: Tensor) -> Tensor:
    """Masked MSE (reference ``MaskedMSELoss``, ``code/loss.py:61-74``):
    ``sum((pred * mask - target)^2) / max(sum(mask), 1)``, as
    ``mmdfn_tpu``'s, which keeps it from the reference's AVEC regression."""
    mask = mask.to(pred.dtype)
    return ((pred * mask - target) ** 2).sum() / mask.sum().clamp(min=1.0)
