"""Dropout drawn from an explicit generator (``flax.linen.Dropout`` in the
JAX package, whose draws come from the step's ``dropout`` key).

The draws never touch the global RNG: the trainer seeds one generator per
step, so a step is reproducible and the plain-version run on the card draws
the same bits as the kernel run.  ``torch.rand`` will not give
``jax.random``'s bits, so parity with the JAX package is tested at rate 0.

A site built with a ``tag`` reads its rate from the innermost
:func:`mmdfn_torch.nn.drop_override.override` for that tag when one is
installed and the site draws (a training forward passes the step's
generator; an eval forward passes none and is the identity).  Under the
grouped sweep's ``vmap`` the override holds each configuration's keep and
keep scale, and the draw is one for the whole group (``randomness=
"same"``), as each configuration's run alone draws it.
"""

from __future__ import annotations

from typing import Optional

import torch

from mmdfn_torch.nn import drop_override

Tensor = torch.Tensor


def dropout(x: Tensor, rate: float, generator: Optional[torch.Generator],
            tag: Optional[str] = None, bf16: bool = False) -> Tensor:
    """``where(rand < keep, x * inv_keep, 0)`` with ``keep = 1 - rate``
    and ``inv_keep = 1 / keep`` (JAX's ``drop_override.dropout``); the
    identity at rate 0 and zeros at rate 1, as flax's.  Under an override
    for ``tag`` every draw happens and a rate-0 configuration keeps all,
    scaled by exactly 1.  ``bf16``: in bf16, as the GCNII stack's bf16
    layer scan drops its carry (``mmdfn_tpu/nn/gcn.py:_dropout``): x and
    inv_keep rounded to bf16, their product rounded; the result widened
    to f32."""
    ov = drop_override.get(tag) if generator is not None else None
    if ov is None:
        if rate == 0.0:
            return x
        if rate == 1.0:
            return torch.zeros_like(x)
        if not 0.0 < rate < 1.0:
            raise ValueError(f"dropout rate {rate} outside [0, 1]")
    keep, inv_keep, _ = drop_override.resolve(
        tag if ov is not None else None, rate)
    rand = torch.rand(x.shape, generator=generator, device=x.device)
    if bf16:
        scale = torch.as_tensor(inv_keep, dtype=torch.float32,
                                device=x.device).to(torch.bfloat16)
        return torch.where(rand < keep, x.to(torch.bfloat16) * scale,
                           0.0).float()
    return torch.where(rand < keep, x * inv_keep, 0.0)
