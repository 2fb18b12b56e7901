"""The reference's batches: which dialogues a training step holds and how
they are padded, worked out from the dialogues themselves.

An epoch's order is ``numpy.random.default_rng((seed, epoch))``'s shuffle
of the dialogue indices (the test split keeps its order); consecutive
runs of ``batch_size`` form the batches; each is padded along time to the
smallest bucket that holds its longest dialogue and along the batch to
``batch_size`` rows of zeros.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def order(n: int, seed: int, epoch: int, shuffle: bool = True) -> np.ndarray:
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng((seed, epoch)).shuffle(idx)
    return idx


def bucket(max_len: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if max_len <= b:
            return int(b)
    return int(max_len)


def schedule(lens: Sequence[int], batch_size: int, buckets: Sequence[int],
             seed: int, epoch: int, shuffle: bool = True):
    """[(indices, bucket)] of one epoch's batches."""
    idx = order(len(lens), seed, epoch, shuffle)
    out = []
    for s in range(0, len(idx), batch_size):
        chunk = idx[s:s + batch_size]
        out.append((chunk, bucket(max(lens[i] for i in chunk), buckets)))
    return out


def collate(dialogues, chunk, batch_size: int, L: int,
            n_speakers: int) -> Dict[str, np.ndarray]:
    B = batch_size
    dims = {m: getattr(dialogues[chunk[0]], m).shape[1]
            for m in ("text", "audio", "visual")}
    out = {m: np.zeros((B, L, d), np.float32) for m, d in dims.items()}
    out["qmask"] = np.zeros((B, L, n_speakers), np.float32)
    out["umask"] = np.zeros((B, L), np.float32)
    out["label"] = np.zeros((B, L), np.int64)
    for r, i in enumerate(chunk):
        d = dialogues[i]
        n = len(d.label)
        for m in dims:
            out[m][r, :n] = getattr(d, m)
        out["qmask"][r, :n] = d.qmask
        out["umask"][r, :n] = 1.0
        out["label"][r, :n] = d.label
    return out


def to_device(batch: Dict[str, np.ndarray], device):
    import torch

    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
