"""Philox4x32-10 in torch integer ops: the plain version of the dropout bits
that ``csrc/philox.cuh`` draws inside the GCNII kernels, bit for bit.

Key = the 64-bit step seed, counter = (b, layer, node, channel), bits = word
0 of the output; keep <=> ``bits < threshold(rate)``, kept values scaled by
``1 / (1 - rate)``.  Words are uint32 values held in int64 tensors; the
32 x 32 -> 64-bit product that Philox needs is split into two 48-bit
products, which int64 holds exactly.  Like the TPU kernel's hardware PRNG,
this does not reproduce ``jax.random``'s bits.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

_MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def threshold(rate: float) -> int:
    """``min(int((1 - rate) * 2^32), 2^32 - 1)``, as
    ``mmdfn_tpu/ops/pallas_gcnii_train.py:_stack_fwd`` computes it."""
    return min(int((1.0 - rate) * (1 << 32)), _MASK32)


def _mulhilo(m: int, c: Tensor):
    """(hi, lo) words of the 64-bit product of the constant m and c."""
    p_lo = c * (m & 0xFFFF)                 # < 2^48
    p_hi = c * (m >> 16)                    # < 2^48
    s = p_lo + ((p_hi & 0xFFFF) << 16)      # < 2^49
    return (p_hi >> 16) + (s >> 32), s & _MASK32


def philox4x32(c0: Tensor, c1: Tensor, c2: Tensor, c3: Tensor,
               k0, k1):
    """The four output words of Philox4x32-10 (broadcasting int64 inputs
    holding uint32 values)."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & _MASK32
        k1 = (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def dropout_bits(seed: Tensor, B: int, layer: int, N: int, H: int) -> Tensor:
    """(B, N, H) int64 bits of layer ``layer`` for the step seed ``seed``
    (an int64 tensor of one element, on the device of the result)."""
    dev = seed.device
    seed = seed.reshape(()).to(torch.int64)
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=dev)
    c0 = ar(B)[:, None, None]
    c1 = torch.full((1, 1, 1), layer, dtype=torch.int64, device=dev)
    c2 = ar(N)[None, :, None]
    c3 = ar(H)[None, None, :]
    return philox4x32(c0, c1, c2, c3, k0, k1)[0].expand(B, N, H)


def keep_mask(seed: Tensor, rate: float, B: int, layer: int, N: int,
              H: int) -> Tensor:
    """(B, N, H) bool: the elements that layer ``layer``'s dropout keeps."""
    return dropout_bits(seed, B, layer, N, H) < threshold(rate)
