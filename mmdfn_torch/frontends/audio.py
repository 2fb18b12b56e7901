"""The audio frontend (``mmdfn_tpu/frontends/audio.py``): the log-mel
spectrogram as two products against fixed bases, and ``LogMelFrontend``,
a trainable utterance encoder over it.

The reference feeds frozen OpenSmile IS10 vectors (1582-d) computed
offline; the raw-input model computes a trainable utterance embedding from
the waveform instead.  The frames are a strided view of the waveform
(``Tensor.unfold``), the STFT one product with a Hann-windowed DFT basis
(real and imaginary parts), the mel projection another; on the card all
three are f32 products (``device.resolve_device`` turns TF32 off).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from mmdfn_torch.nn.init import reset_conv, reset_linear

Tensor = torch.Tensor


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + f / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def mel_filterbank(n_mels: int, n_fft: int, sample_rate: int,
                   fmin: float = 0.0, fmax: Optional[float] = None
                   ) -> np.ndarray:
    """Triangular mel filterbank (n_fft//2+1, n_mels), HTK-style."""
    fmax = fmax or sample_rate / 2
    freqs = np.linspace(0, sample_rate / 2, n_fft // 2 + 1)
    mel_pts = np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    fb = np.zeros((len(freqs), n_mels), np.float32)
    for m in range(n_mels):
        lo, c, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (freqs - lo) / max(c - lo, 1e-8)
        down = (hi - freqs) / max(hi - c, 1e-8)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    return fb


@functools.lru_cache(maxsize=8)
def _dft_basis(n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
    """Real/imag DFT bases (n_fft, n_fft//2+1) with a Hann window folded in."""
    k = np.arange(n_fft // 2 + 1)
    n = np.arange(n_fft)
    ang = -2.0 * np.pi * np.outer(n, k) / n_fft
    window = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / n_fft)
    return ((np.cos(ang) * window[:, None]).astype(np.float32),
            (np.sin(ang) * window[:, None]).astype(np.float32))


@functools.lru_cache(maxsize=8)
def _bases(n_fft: int, n_mels: int, sample_rate: int,
           device: torch.device) -> Tuple[Tensor, Tensor, Tensor]:
    """The two DFT bases and the filterbank on ``device``, copied there
    once (never written: every caller shares them)."""
    cos_b, sin_b = _dft_basis(n_fft)
    fb = mel_filterbank(n_mels, n_fft, sample_rate)
    return tuple(torch.from_numpy(b).to(device) for b in (cos_b, sin_b, fb))


def log_mel_spectrogram(wav: Tensor, *, sample_rate: int = 16000,
                        n_fft: int = 400, hop: int = 160,
                        n_mels: int = 64) -> Tensor:
    """(..., n_samples) -> (..., n_frames, n_mels) log-mel features, with
    ``n_frames = 1 + (n_samples - n_fft) // hop``."""
    *lead, S = wav.shape
    frames = wav.reshape(-1, S).unfold(-1, n_fft, hop)     # (N, F, n_fft)
    cos_b, sin_b, fb = _bases(n_fft, n_mels, sample_rate, wav.device)
    re = frames @ cos_b
    im = frames @ sin_b
    power = re * re + im * im                              # (N, F, n_fft/2+1)
    out = torch.log(power @ fb + 1e-6)
    return out.reshape(*lead, out.shape[-2], n_mels)


def same_pad(x: Tensor, kernel: int, stride: int) -> Tensor:
    """Pad the last axis as flax's ``'SAME'`` does for a strided window:
    ``ceil(T / stride)`` outputs, the padding split with the extra element
    at the end."""
    T = x.shape[-1]
    total = max((math.ceil(T / stride) - 1) * stride + kernel - T, 0)
    return F.pad(x, (total // 2, total - total // 2))


class LogMelFrontend(nn.Module):
    """(B, L, n_samples) waveforms -> (B, L, out_dim): log-mel, two strided
    1-D convolutions (k 5 then 3, stride 2, ReLU), mean and std pooling
    over frames (the stand-in for OpenSmile's functionals) and a linear
    head (``mmdfn_tpu/frontends/audio.py:LogMelFrontend``)."""

    def __init__(self, out_dim: int = 300, n_mels: int = 64,
                 n_fft: int = 400, hop: int = 160, sample_rate: int = 16000,
                 channels: int = 128):
        super().__init__()
        self.n_mels, self.n_fft, self.hop = n_mels, n_fft, hop
        self.sample_rate = sample_rate
        self.conv1 = nn.Conv1d(n_mels, channels, 5, stride=2)
        self.conv2 = nn.Conv1d(channels, channels, 3, stride=2)
        self.proj = nn.Linear(2 * channels, out_dim)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        reset_conv(self.conv1, generator)
        reset_conv(self.conv2, generator)
        reset_linear(self.proj, generator)

    def forward(self, wav: Tensor) -> Tensor:
        B, L, S = wav.shape
        mel = log_mel_spectrogram(
            wav.reshape(B * L, S), sample_rate=self.sample_rate,
            n_fft=self.n_fft, hop=self.hop, n_mels=self.n_mels)
        h = mel.transpose(1, 2)                            # (BL, n_mels, F)
        for conv in (self.conv1, self.conv2):
            k, s = conv.kernel_size[0], conv.stride[0]
            h = torch.relu(conv(same_pad(h, k, s)))
        mean = h.mean(dim=-1)
        std = torch.sqrt(torch.clamp(h.var(dim=-1, correction=0), min=1e-8))
        out = self.proj(torch.cat([mean, std], dim=-1))
        return out.reshape(B, L, -1)
