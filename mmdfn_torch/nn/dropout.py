"""Dropout drawn from an explicit generator (``flax.linen.Dropout`` in the
JAX package, whose draws come from the step's ``dropout`` key).

The draws never touch the global RNG: the trainer seeds one generator per
step, so a step is reproducible and the plain-version run on the card draws
the same bits as the kernel run.  ``torch.rand`` will not give
``jax.random``'s bits, so parity with the JAX package is tested at rate 0.
"""

from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor


def dropout(x: Tensor, rate: float, generator: Optional[torch.Generator]
            ) -> Tensor:
    """``where(rand < keep, x / keep, 0)`` with ``keep = 1 - rate``; the
    identity at rate 0 and zeros at rate 1, as flax's."""
    if rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    if not 0.0 < rate < 1.0:
        raise ValueError(f"dropout rate {rate} outside [0, 1]")
    keep = 1.0 - rate
    rand = torch.rand(x.shape, generator=generator, device=x.device)
    return torch.where(rand < keep, x / keep, 0.0)
