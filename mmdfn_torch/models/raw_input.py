"""The raw-input ERC model (``mmdfn_tpu/models/raw_input.py``): trainable
frontends in front of ``DialogueGNN``.

The reference's precomputed utterance features (offline OpenSmile and
DenseNet runs) are replaced by on-device extractors: waveforms through
:class:`LogMelFrontend`, face crops through :class:`DenseNetFrontend`; the
text features pass through.  The fused features feed the unchanged
``DialogueGNN``, so every multimodal family trains on raw inputs, and the
flagship's step runs kernels A-D behind the frontends' convolutions.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mmdfn_torch.config import ExperimentConfig
from mmdfn_torch.frontends import DenseNetFrontend, LogMelFrontend
from mmdfn_torch.models.dialogue_gnn import DialogueGNN

Tensor = torch.Tensor


class RawInputDialogueGNN(nn.Module):
    """(text features, waveforms, face crops) -> per-utterance log-probs."""

    def __init__(self, model: DialogueGNN, audio_out_dim: int = 300,
                 visual_out_dim: int = 342, n_mels: int = 64,
                 n_fft: int = 400, hop: int = 160,
                 densenet_growth: int = 12):
        super().__init__()
        self.model = model
        self.audio_frontend = LogMelFrontend(out_dim=audio_out_dim,
                                             n_mels=n_mels, n_fft=n_fft,
                                             hop=hop)
        self.visual_frontend = DenseNetFrontend(out_dim=visual_out_dim,
                                                growth=densenet_growth)

    @classmethod
    def from_config(cls, cfg: ExperimentConfig, audio_out_dim: int = 300,
                    visual_out_dim: int = 342,
                    **frontend) -> "RawInputDialogueGNN":
        """The config's multimodal ``DialogueGNN`` on the frontends' widths,
        behind the two frontends (``frontend``: ``n_mels``, ``n_fft``,
        ``hop``, ``densenet_growth``)."""
        model = DialogueGNN.from_config(cfg, D_m_a=audio_out_dim,
                                        D_m_v=visual_out_dim)
        return cls(model, audio_out_dim, visual_out_dim, **frontend)

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        """The graph model's weights first, drawn as ``DialogueGNN`` alone
        draws them from the same generator, then the frontends'."""
        self.model.reset_parameters(generator)
        self.audio_frontend.reset_parameters(generator)
        self.visual_frontend.reset_parameters(generator)

    def forward(self, text: Tensor, qmask: Tensor, umask: Tensor,
                waveforms: Tensor, frames: Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        """waveforms: (B, L, n_samples); frames: (B, L, H, W, C).  Pad
        utterances pass through the frontends, and their features are
        zeroed by ``umask`` before the graph model."""
        um = umask[..., None]
        audio = self.audio_frontend(waveforms) * um
        visual = self.visual_frontend(frames) * um
        return self.model(text, qmask, umask, audio, visual, train=train,
                          generator=generator)
