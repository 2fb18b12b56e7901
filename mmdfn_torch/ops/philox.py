"""Philox4x32-10 in torch integer ops: the plain version of the dropout bits
that ``csrc/philox.cuh`` draws inside the GCNII kernels, bit for bit.

Key = the 64-bit step seed, counter = (b, layer, node, channel), bits = word
0 of the output; keep <=> ``bits < threshold(rate)``, kept values scaled by
``1 / (1 - rate)``.  Words are uint32 values held in int64 tensors; the
32 x 32 -> 64-bit product that Philox needs is the int64 product, which
wraps modulo 2^64 and so keeps all 64 bits.  Like the TPU kernel's hardware
PRNG, this does not reproduce ``jax.random``'s bits.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Union

import torch

from mmdfn_torch.ops import _mode

Tensor = torch.Tensor

# the CPU's recent dropout bits, by (seed, B, layer, N, H): the plain
# backward draws each layer's bits again from the forward's seed; at most
# _CACHE_BYTES of them are kept (a 64-layer stack's at the CPU tests' sizes)
_CACHE: "OrderedDict[tuple, Tensor]" = OrderedDict()
_CACHE_BYTES = 64 << 20

_MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def threshold(rate: float) -> int:
    """``min(int((1 - rate) * 2^32), 2^32 - 1)``, as
    ``mmdfn_tpu/ops/pallas_gcnii_train.py:_stack_fwd`` computes it."""
    return min(int((1.0 - rate) * (1 << 32)), _MASK32)


def _mulhilo(m: int, c: Tensor):
    """(hi, lo) words of the 64-bit product of the constant m and c: the
    int64 product holds its bits (past 2^63 as a negative number, whose
    arithmetic shift keeps the high word's bits under the mask)."""
    p = c * m
    return (p >> 32) & _MASK32, p & _MASK32


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
    (an int64 tensor of one element, on the device of the result).  On the
    CPU the bits last drawn are kept (``_CACHE``) and handed out again."""
    if seed.device.type != "cpu" or _mode.is_batched(seed):
        return _draw(seed, B, layer, N, H)
    key = (int(seed.reshape(())), B, layer, N, H)
    bits = _CACHE.get(key)
    if bits is None:
        bits = _CACHE[key] = _draw(seed, B, layer, N, H)
        held = sum(b.numel() * b.element_size() for b in _CACHE.values())
        while held > _CACHE_BYTES and len(_CACHE) > 1:
            old = _CACHE.popitem(last=False)[1]
            held -= old.numel() * old.element_size()
    else:
        _CACHE.move_to_end(key)
    return bits


def _draw(seed: Tensor, B: int, layer: int, N: int, H: int) -> Tensor:
    dev = seed.device
    seed = seed.reshape(()).to(torch.int64)
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=dev)
    c0 = ar(B)[:, None, None]
    c1 = torch.full((1, 1, 1), layer, dtype=torch.int64, device=dev)
    c2 = ar(N)[None, :, None]
    c3 = ar(H)[None, None, :]
    return philox4x32(c0, c1, c2, c3, k0, k1)[0].expand(B, N, H).contiguous()


def keep_mask(seed: Tensor, rate: Union[float, Tensor], B: int, layer: int,
              N: int, H: int) -> Tensor:
    """(B, N, H) bool: the elements that layer ``layer``'s dropout keeps.

    ``rate`` is a Python rate, or a threshold tensor: int32 holding the
    bit pattern of the uint32 threshold (``nn/drop_override.py``'s
    ``DropRate.thresh``), 0-d or broadcasting against (B, N, H), as kernels
    B and D read one per configuration from memory."""
    bits = dropout_bits(seed, B, layer, N, H)
    if isinstance(rate, Tensor):
        return bits < (rate.to(torch.int64) & _MASK32)
    return bits < threshold(rate)
