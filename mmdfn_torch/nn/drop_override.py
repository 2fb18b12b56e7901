"""A dropout rate per configuration (``mmdfn_tpu/nn/drop_override.py``).

Both reference grids vary ``--dropout`` (``script/run_train_ie.sh``: dp
{0.2, 0.4}).  The grouped sweep (``train/vmap_sweep.py``) maps one
training step over the K stacked configurations with ``torch.func.vmap``,
so a rate fixed when a module is built cannot differ between them.  The
rate is data (a keep threshold), so it rides the config axis instead:

* :class:`DropRate`: the rate of each configuration as (K,) tensors,
  with the keep probability, the Philox keep threshold of kernels B and D
  and the keep scale computed on the host in float64, so that the draws
  and the scaling are bit for bit a static-rate run's;
* :func:`override`: installs ``{tag: DropRate}`` for the duration of a
  forward; every dropout site built with that ``rate_tag`` reads its
  configuration's rate from it (under ``vmap``, each configuration sees
  its own entry of the (K,) tensors), and a site without a tag, or a tag
  with no override, keeps the rate it was built with;
* :func:`resolve`: a site's ``(keep, inv_keep, override)``.

A rate-0 configuration under an override still draws (the mask keeps
everything: a draw is always below keep = 1), and is scaled by exactly
1.0, so its output equals its static run's.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

Tensor = torch.Tensor


class DropRate(NamedTuple):
    """The rate of each configuration, (K,) tensors (0-d under ``vmap``).

    ``thresh`` is int32 holding the bit pattern of the uint32 keep
    threshold ``min(int((1 - rate) 2^32), 2^32 - 1)`` that kernels B and D
    compare Philox's bits with; ``inv_keep`` is exactly 1.0 at rate 0,
    which the kernels take as "keep everything, draw nothing"."""

    rate: Tensor        # f32, the drop probability (for reports)
    keep: Tensor        # f32, 1 - rate rounded once from float64: equal to
                        #      a static site's Python-float keep once torch
                        #      casts it to f32 (an f32 1 - f32(rate) is
                        #      1 ulp off: 1 - f32(0.2) != f32(0.8))
    thresh: Tensor      # int32, the uint32 keep threshold's bit pattern
    inv_keep: Tensor    # f32, 1 / (1 - rate)


def _thresh_int(rate: float) -> int:
    # the static path's formula (ops/philox.py:threshold)
    return min(int((1.0 - float(rate)) * (1 << 32)), (1 << 32) - 1)


def make_drop_rate(rates: Union[float, Sequence[float]],
                   device=None) -> DropRate:
    """The host-side constructor: one rate (0-d tensors) or a (K,) stack,
    each in [0, 1); on ``device`` (default the CPU)."""
    arr = np.atleast_1d(np.asarray(rates, np.float64))
    if np.any(arr < 0.0) or np.any(arr >= 1.0):
        raise ValueError(f"dropout rates must be in [0, 1); got {arr}")
    thresh = np.asarray([_thresh_int(r) for r in arr], np.uint64)
    thresh_i32 = thresh.astype(np.uint32).view(np.int32)
    keep = (1.0 - arr).astype(np.float32)
    inv_keep = (1.0 / (1.0 - arr)).astype(np.float32)
    pick = (lambda a: a[0]) if np.ndim(rates) == 0 else (lambda a: a)
    put = lambda a: torch.as_tensor(np.array(pick(a)), device=device)
    return DropRate(rate=put(arr.astype(np.float32)), keep=put(keep),
                    thresh=put(thresh_i32), inv_keep=put(inv_keep))


_STACK: list = []


@contextlib.contextmanager
def override(rates: dict) -> Iterator[None]:
    """Install ``{tag: DropRate}`` for the duration of a forward; nests,
    the innermost entry of a tag winning."""
    _STACK.append(dict(rates))
    try:
        yield
    finally:
        _STACK.pop()


def get(tag: Optional[str]) -> Optional[DropRate]:
    """The innermost override for ``tag`` (None when absent or untagged)."""
    if tag is None:
        return None
    for frame in reversed(_STACK):
        if tag in frame:
            return frame[tag]
    return None


def resolve(tag: Optional[str], static_rate: float):
    """``(keep, inv_keep, override_or_None)`` of a dropout site: the
    override's tensors, or Python floats from the site's own rate."""
    ov = get(tag)
    if ov is not None:
        return ov.keep, ov.inv_keep, ov
    k = 1.0 - static_rate
    return k, (1.0 / k if k > 0.0 else 1.0), None
