"""Length-bucketed, statically padded batches (``mmdfn_tpu/data/batching.py``
``Batch``, ``collate``, ``BucketBatcher`` and their token-id versions),
in numpy.

Streaming pads each dialogue prefix up to the next bucket length; training
pads each batch's longest dialogue up to the next bucket and the batch axis
to ``batch_size`` (short batches carry all-zero ``umask`` rows that every
consumer masks out), so an epoch runs a handful of distinct shapes.

Under a ``torch.profiler`` each batch a batcher collates is a
``data.collate`` span of step (epoch, i), and its valid utterances and its
batch_size x bucket slots add to the counters ``data.utterances`` and
``data.slots`` (``runtime/profiling.py``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence

import numpy as np

from mmdfn_torch.runtime.profiling import annotate, count

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


@dataclass
class TokenBatch:
    """One statically shaped batch of token-id dialogues (DailyDialogue)."""

    tokens: np.ndarray  # (B, L, W) int32, 0 at pads
    qmask: np.ndarray   # (B, L, n_speakers)
    umask: np.ndarray   # (B, L) float32: 1 = real utterance
    label: np.ndarray   # (B, L) int64 (0 at pads)
    vids: List[str] = dataclasses.field(default_factory=list)

    @property
    def n_valid(self) -> int:
        return int(self.umask.sum())


def collate_tokens(dialogues: Sequence, batch_size: int, bucket: int,
                   n_speakers: int = 2,
                   max_words: Optional[int] = None) -> TokenBatch:
    """Pad token dialogues into one static (batch_size, bucket, W) batch:
    W is ``max_words`` (each utterance's words cut or zero-padded to it),
    else the widest utterance's."""
    if not 0 < len(dialogues) <= batch_size:
        raise ValueError(f"{len(dialogues)} dialogues for a batch of "
                         f"{batch_size}")
    W = max_words or max(d.tokens.shape[1] for d in dialogues)
    B, L = batch_size, bucket
    tokens = np.zeros((B, L, W), dtype=np.int32)
    umask = np.zeros((B, L), dtype=np.float32)
    label = np.zeros((B, L), dtype=np.int64)
    for i, d in enumerate(dialogues):
        n, w = d.tokens.shape
        tokens[i, :n, :min(w, W)] = d.tokens[:, :W]
        umask[i, :n] = 1.0
        label[i, :n] = d.label
    return TokenBatch(tokens=tokens,
                      qmask=_pack([d.qmask for d in dialogues], B, L,
                                  n_speakers),
                      umask=umask, label=label,
                      vids=[d.vid for d in dialogues])


class BucketBatcher:
    """Epoch iterator over bucketed static batches.

    Train epochs shuffle dialogue order with a numpy ``Generator`` seeded
    from (seed, epoch), so runs are reproducible; eval keeps dataset order.
    ``sort_by_length`` then orders the dialogues by length (stably, so ties
    keep the shuffled order), which cuts the padding of each batch.
    """

    def __init__(self, dialogues: Sequence, batch_size: int, n_speakers: int,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 shuffle: bool = False, seed: int = 2021,
                 sort_by_length: bool = False):
        self.dialogues = list(dialogues)
        self.batch_size = batch_size
        self.n_speakers = n_speakers
        self.buckets = tuple(buckets)
        self.shuffle = shuffle
        self.seed = seed
        self.sort_by_length = sort_by_length

    def epoch(self, epoch_idx: int = 0) -> Iterator[Batch]:
        order = np.arange(len(self.dialogues))
        if self.shuffle:
            np.random.default_rng((self.seed, epoch_idx)).shuffle(order)
        if self.sort_by_length:
            order = order[np.argsort([len(self.dialogues[i]) for i in order],
                                     kind="stable")]
        for i, s in enumerate(range(0, len(order), self.batch_size)):
            chunk = [self.dialogues[j] for j in order[s:s + self.batch_size]]
            L = bucket_length(max(len(d) for d in chunk), self.buckets)
            with annotate("data.collate", step=(epoch_idx, i)):
                batch = self._collate(chunk, L)
            # the padding: valid utterances against the batch's slots
            count("data.utterances", sum(len(d) for d in chunk))
            count("data.slots", self.batch_size * L)
            yield batch

    def num_batches(self) -> int:
        return -(-len(self.dialogues) // self.batch_size)

    def _collate(self, chunk, L):
        return collate(chunk, self.batch_size, L, self.n_speakers)


class TokenBucketBatcher(BucketBatcher):
    """:class:`BucketBatcher` over :class:`TokenDialogue` samples; the word
    axis is ``max_words`` in every batch of the epoch."""

    def __init__(self, dialogues: Sequence, batch_size: int, max_words: int,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 shuffle: bool = False, seed: int = 2021,
                 sort_by_length: bool = False, n_speakers: int = 2):
        super().__init__(dialogues, batch_size, n_speakers, buckets,
                         shuffle, seed, sort_by_length)
        self.max_words = max_words

    def _collate(self, chunk, L):
        return collate_tokens(chunk, self.batch_size, L, self.n_speakers,
                              max_words=self.max_words)


def make_epoch_batches(dialogues: Sequence, batch_size: int, n_speakers: int,
                       epoch: int = 0, shuffle: bool = False,
                       seed: int = 2021,
                       buckets: Sequence[int] = DEFAULT_BUCKETS
                       ) -> List[Batch]:
    """One epoch's batches as a list (``mmdfn_tpu``'s helper of the same
    name)."""
    return list(BucketBatcher(dialogues, batch_size, n_speakers, buckets,
                              shuffle, seed).epoch(epoch))
