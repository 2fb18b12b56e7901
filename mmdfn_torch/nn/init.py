"""torch's default initialisations (and flax's, for the frontends'
convolutions), drawn from an explicit generator, so that a model's fresh
weights follow from its seed alone."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


def reset_linear(lin: nn.Linear, generator: Optional[torch.Generator]
                 ) -> None:
    """``nn.Linear``'s default: U(-1/sqrt(in), 1/sqrt(in)) for the weight
    and the bias."""
    k = 1.0 / math.sqrt(lin.in_features)
    with torch.no_grad():
        lin.weight.uniform_(-k, k, generator=generator)
        if lin.bias is not None:
            lin.bias.uniform_(-k, k, generator=generator)


def reset_linears(module: nn.Module,
                  generator: Optional[torch.Generator]) -> None:
    """:func:`reset_linear` on every ``nn.Linear`` under ``module``, in
    registration order."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            reset_linear(m, generator)


def reset_uniform(params, bound: float,
                  generator: Optional[torch.Generator]) -> None:
    """U(-bound, bound) on each tensor of ``params`` (torch's RNN and
    GCNII-conv defaults)."""
    with torch.no_grad():
        for p in params:
            p.uniform_(-bound, bound, generator=generator)


def reset_conv(conv: nn.Module, generator: Optional[torch.Generator]
               ) -> None:
    """flax's ``Conv`` default: LeCun normal (truncated at two standard
    deviations, fan-in = in channels x window) for the kernel, zeros for
    the bias."""
    fan_in = conv.weight[0].numel()
    # variance_scaling's truncated normal: the std of the truncated draw
    # is sqrt(1 / fan_in)
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(conv.weight, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        if conv.bias is not None:
            conv.bias.zero_()
