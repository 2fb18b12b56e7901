"""Trainable feature frontends of the raw-input model: log-mel audio and a
DenseNet over face crops (``mmdfn_tpu/frontends``)."""

from mmdfn_torch.frontends.audio import LogMelFrontend, log_mel_spectrogram
from mmdfn_torch.frontends.vision import DenseNetFrontend

__all__ = ["DenseNetFrontend", "LogMelFrontend", "log_mel_spectrogram"]
