"""Length-bucketed, statically padded batches (``mmdfn_tpu/data/batching.py``
``Batch``, ``collate`` and ``BucketBatcher``), numpy only.

Streaming pads each dialogue prefix up to the next bucket length; training
pads each batch's longest dialogue up to the next bucket and the batch axis
to ``batch_size`` (short batches carry all-zero ``umask`` rows that every
consumer masks out), so an epoch runs a handful of distinct shapes.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Iterator, List, Sequence

import numpy as np

SERVE_BUCKETS = (8, 16, 32, 64, 128, 200)
DEFAULT_BUCKETS = (16, 24, 32, 48, 64, 96, 128, 160, 200)


def bucket_length(max_len: int, buckets: Sequence[int] = SERVE_BUCKETS) -> int:
    """The smallest bucket >= ``max_len`` (``max_len`` itself past the last)."""
    for b in buckets:
        if max_len <= b:
            return b
    return int(max_len)


@dataclass
class Batch:
    """One statically shaped batch of dialogues, batch-first (B, L, ...)."""

    text: np.ndarray    # (B, L, D_text) float32
    visual: np.ndarray  # (B, L, D_visual)
    audio: np.ndarray   # (B, L, D_audio)
    qmask: np.ndarray   # (B, L, n_speakers)
    umask: np.ndarray   # (B, L) float32: 1 = real utterance
    label: np.ndarray   # (B, L) int64 (0 at pads; mask before use)
    vids: List[str] = dataclasses.field(default_factory=list)

    @property
    def n_valid(self) -> int:
        return int(self.umask.sum())


def _pack(arrs: List[np.ndarray], B: int, L: int, D: int) -> np.ndarray:
    out = np.zeros((B, L, D), dtype=np.float32)
    for i, a in enumerate(arrs):
        out[i, : a.shape[0]] = a
    return out


def collate(dialogues: Sequence, batch_size: int, bucket: int,
            n_speakers: int) -> Batch:
    """Pad a list of dialogues into one static (batch_size, bucket) Batch."""
    if not 0 < len(dialogues) <= batch_size:
        raise ValueError(f"{len(dialogues)} dialogues for a batch of "
                         f"{batch_size}")
    d0 = dialogues[0]
    B, L = batch_size, bucket
    umask = np.zeros((B, L), dtype=np.float32)
    label = np.zeros((B, L), dtype=np.int64)
    for i, d in enumerate(dialogues):
        umask[i, :len(d)] = 1.0
        label[i, :len(d)] = d.label
    return Batch(
        text=_pack([d.text for d in dialogues], B, L, d0.text.shape[1]),
        visual=_pack([d.visual for d in dialogues], B, L, d0.visual.shape[1]),
        audio=_pack([d.audio for d in dialogues], B, L, d0.audio.shape[1]),
        qmask=_pack([d.qmask for d in dialogues], B, L, n_speakers),
        umask=umask, label=label, vids=[d.vid for d in dialogues])


class BucketBatcher:
    """Epoch iterator over bucketed static batches.

    Train epochs shuffle dialogue order with a numpy ``Generator`` seeded
    from (seed, epoch), so runs are reproducible; eval keeps dataset order.
    """

    def __init__(self, dialogues: Sequence, batch_size: int, n_speakers: int,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 shuffle: bool = False, seed: int = 2021):
        self.dialogues = list(dialogues)
        self.batch_size = batch_size
        self.n_speakers = n_speakers
        self.buckets = tuple(buckets)
        self.shuffle = shuffle
        self.seed = seed

    def epoch(self, epoch_idx: int = 0) -> Iterator[Batch]:
        order = np.arange(len(self.dialogues))
        if self.shuffle:
            np.random.default_rng((self.seed, epoch_idx)).shuffle(order)
        for s in range(0, len(order), self.batch_size):
            chunk = [self.dialogues[i] for i in order[s:s + self.batch_size]]
            L = bucket_length(max(len(d) for d in chunk), self.buckets)
            yield collate(chunk, self.batch_size, L, self.n_speakers)
