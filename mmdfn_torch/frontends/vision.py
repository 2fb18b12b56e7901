"""The vision frontend (``mmdfn_tpu/frontends/vision.py``): a compact
DenseNet-BC over face crops, with GroupNorm in place of BatchNorm.

The reference feeds frozen "denseface" vectors (342-d) from an offline
DenseNet run; the raw-input model trains this one end to end.  Each dense
layer's input is the concatenation of every earlier feature map (``growth``
new channels a layer); a transition halves the channels and the image
side.  GroupNorm keeps an utterance's output independent of the rest of
the batch (serving runs one dialogue) and keeps no running statistics.

The module works in NCHW (cuDNN's layout for f32 convolutions): the
(B, L, H, W, C) frames are permuted once.  Every convolution pads as
flax's ``'SAME'`` at stride 1 (3x3: one pixel each side) and has no bias.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from mmdfn_torch.nn.init import reset_conv, reset_linear

Tensor = torch.Tensor

GN_EPS = 1e-6       # flax GroupNorm's epsilon (torch's default is 1e-5)


def group_norm(channels: int) -> nn.GroupNorm:
    """GroupNorm whose group count (the first of 8, 4, 2, 1 that divides
    ``channels``) fits any DenseNet width (24, 56, 120, ...)."""
    groups = next(g for g in (8, 4, 2, 1) if channels % g == 0)
    return nn.GroupNorm(groups, channels, eps=GN_EPS)


def _conv(cin: int, cout: int, k: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, padding=k // 2, bias=False)


class _DenseLayer(nn.Module):
    """norm, ReLU, 1x1 conv to 4 x growth, ReLU, 3x3 conv to growth; the
    output is the input with the new channels appended."""

    def __init__(self, cin: int, growth: int):
        super().__init__()
        self.norm = group_norm(cin)
        self.conv1x1 = _conv(cin, 4 * growth, 1)
        self.conv3x3 = _conv(4 * growth, growth, 3)

    def forward(self, x: Tensor) -> Tensor:
        h = torch.relu(self.conv1x1(torch.relu(self.norm(x))))
        return torch.cat([x, self.conv3x3(h)], dim=1)


class _Transition(nn.Module):
    """norm, ReLU, 1x1 conv to ``cout``, 2x2 average pooling (stride 2)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm = group_norm(cin)
        self.conv = _conv(cin, cout, 1)

    def forward(self, x: Tensor) -> Tensor:
        return F.avg_pool2d(self.conv(torch.relu(self.norm(x))), 2)


class DenseNetFrontend(nn.Module):
    """(B, L, H, W, C) face crops -> (B, L, out_dim) utterance features.

    Submodule names follow the JAX module's parameter tree (``stem``,
    ``block{b}_layer{i}``, ``trans{b}``, ``final_norm``, ``head``)."""

    def __init__(self, out_dim: int = 342, growth: int = 12,
                 block_config: Sequence[int] = (4, 8, 6),
                 stem_channels: int = 32, in_channels: int = 3):
        super().__init__()
        self.stem = _conv(in_channels, stem_channels, 3)
        self.layers = []
        ch = stem_channels
        for bi, n_layers in enumerate(block_config):
            for li in range(n_layers):
                self._add(f"block{bi}_layer{li}", _DenseLayer(ch, growth))
                ch += growth
            if bi < len(block_config) - 1:
                self._add(f"trans{bi}", _Transition(ch, ch // 2))
                ch //= 2
        self.final_norm = group_norm(ch)
        self.head = nn.Linear(ch, out_dim)
        self.reset_parameters()

    def _add(self, name: str, module: nn.Module) -> None:
        setattr(self, name, module)
        self.layers.append(name)

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        """flax's defaults: LeCun normal convolutions, unit scales and zero
        biases in the norms, and torch's ``nn.Linear`` draw for the head
        (``TorchDense``)."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                reset_conv(m, generator)
            elif isinstance(m, nn.GroupNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        reset_linear(self.head, generator)

    def forward(self, frames: Tensor) -> Tensor:
        B, L, H, W, C = frames.shape
        x = self.stem(frames.reshape(B * L, H, W, C).permute(0, 3, 1, 2)
                      .contiguous())
        for name in self.layers:
            x = getattr(self, name)(x)
        x = torch.relu(self.final_norm(x)).mean(dim=(2, 3))
        return self.head(x).reshape(B, L, -1)
