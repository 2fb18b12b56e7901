"""The port's linear layer: ``nn.Linear``, whose product over stacked
configurations (the grouped sweep's config axis under ``torch.func.vmap``)
sums each configuration as its run alone does."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mmdfn_torch.ops import _mode


class _StackedLinear(torch.autograd.Function):
    """``F.linear`` whose ``vmap`` rule is one ``baddbmm`` over the config
    axis: torch's own rule splits the product and the bias add, where a run
    alone's ``addmm`` starts its sums from the bias, and past one block of
    the inner dimension (the audio's 1582 features) the two differ in the
    last bits.  ``baddbmm`` sums each configuration as ``addmm`` does, and
    autograd differentiates it as it does ``addmm``."""

    @staticmethod
    def forward(x, weight, bias):
        return F.linear(x, weight, bias)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, x, weight, bias):
        x, weight, bias = _mode.config_axis(info, in_dims, (x, weight, bias))
        K, *lead, D = x.shape
        out = torch.baddbmm(bias[:, None, :], x.reshape(K, -1, D),
                            weight.transpose(1, 2))
        return out.reshape(K, *lead, -1), 0


class Linear(nn.Linear):
    """``nn.Linear``; with a weight batched over configurations, one
    ``baddbmm`` for all of them (:class:`_StackedLinear`)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bias is not None and _mode.is_batched(self.weight):
            return _StackedLinear.apply(x, self.weight, self.bias)
        return F.linear(x, self.weight, self.bias)
