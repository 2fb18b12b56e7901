"""Philox4x32-10 in torch integer ops: the counter-based generator whose
bits decide the GCNII stack's in-layer dropout (Salmon et al., "Parallel
random numbers: as easy as 1, 2, 3", SC 2011).

Key: the step's 64-bit seed (two 32-bit words, low first).  Counter:
(dialogue, layer, node, channel).  The bits of an element are word 0 of
the output; an element is kept where its bits lie below the keep
threshold ``min(int((1 - rate) 2^32), 2^32 - 1)``.  Words are uint32
values held in int64 tensors; the 32 x 32 -> 64-bit product is the int64
product, which wraps modulo 2^64 and so keeps all 64 bits.
"""

from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def threshold(rate: float) -> int:
    """The uint32 keep threshold of a dropout rate."""
    return min(int((1.0 - float(rate)) * (1 << 32)), _MASK32)


def _mulhilo(m: int, c: torch.Tensor):
    p = c * m
    return (p >> 32) & _MASK32, p & _MASK32


def bits(seed: int, n_layers: int, B: int, N: int, H: int,
         device) -> torch.Tensor:
    """(n_layers, B, N, H) int64: word 0 of Philox4x32-10 at the counter
    (b, layer, node, channel) under the key ``seed``."""
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)
    c0 = ar(B)[None, :, None, None]
    c1 = ar(n_layers)[:, None, None, None]
    c2 = ar(N)[None, None, :, None]
    c3 = ar(H)[None, None, None, :]
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & _MASK32
        k1 = (k1 + _W1) & _MASK32
    return c0.expand(n_layers, B, N, H)
