"""IEMOCAP, MELD and DailyDialogue pickles -> numpy dialogues (the serve
and training paths' subset of ``mmdfn_tpu/data/datasets.py``).

IEMOCAP's pickle is the reference's 9-tuple of dicts keyed by dialogue id
(``dataloader.py:12-14``); speakers are 'M'/'F', one-hot as [1,0]/[0,1].
MELD's is a 10-tuple whose speakers are already 9-way one-hots
(``dataloader.py:40-52``).  DailyDialogue's is a 7-tuple of token ids
with its own train/test/valid id lists (``dataloader.py:71-101``);
speaker "0" is [1,0], any other [0,1].
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass
from typing import List

import numpy as np

FEAT2DIM = {
    "IS10": 1582,
    "3DCNN": 512,
    "textCNN": 100,
    "bert": 768,
    "denseface": 342,
    "MELD_text": 600,
    "MELD_audio": 300,
}


@dataclass
class Dialogue:
    """One conversation: per-utterance features, speaker one-hots, labels."""

    vid: str
    text: np.ndarray     # (len, D_text) float32
    visual: np.ndarray   # (len, D_visual)
    audio: np.ndarray    # (len, D_audio)
    qmask: np.ndarray    # (len, n_speakers) one-hot float32
    label: np.ndarray    # (len,) int32

    def __len__(self) -> int:
        return self.text.shape[0]


def _as2d(x) -> np.ndarray:
    a = np.asarray(x, dtype=np.float32)
    if a.ndim == 1:
        a = a[:, None]
    return a


class IEMOCAPDataset:
    """IEMOCAP 6-way trimodal ERC (reference ``dataloader.py:9-34``)."""

    def __init__(self, path: str, train: bool = True):
        with open(path, "rb") as f:
            (self.videoIDs, self.videoSpeakers, self.videoLabels,
             self.videoText, self.videoAudio, self.videoVisual,
             self.videoSentence, self.trainVid,
             self.testVid) = pickle.load(f, encoding="latin1")
        self.keys = list(self.trainVid if train else self.testVid)

    def __len__(self) -> int:
        return len(self.keys)

    def __getitem__(self, index: int) -> Dialogue:
        vid = self.keys[index]
        qmask = np.array([[1.0, 0.0] if s == "M" else [0.0, 1.0]
                          for s in self.videoSpeakers[vid]], dtype=np.float32)
        return Dialogue(
            vid=vid,
            text=_as2d(self.videoText[vid]),
            visual=_as2d(self.videoVisual[vid]),
            audio=_as2d(self.videoAudio[vid]),
            qmask=qmask,
            label=np.asarray(self.videoLabels[vid], dtype=np.int32),
        )

    def dialogues(self) -> List[Dialogue]:
        return [self[i] for i in range(len(self))]


class MELDDataset:
    """MELD 7-way trimodal ERC (reference ``dataloader.py:37-68``).

    The pickle carries a 10th field (unused, ``dataloader.py:42``); qmask is
    already a 9-way one-hot matrix per utterance (``dataloader.py:52``).
    """

    n_speakers = 9
    n_classes = 7
    target_names = ["neu", "sur", "fea", "sad", "joy", "dis", "ang"]

    def __init__(self, path: str, train: bool = True):
        with open(path, "rb") as f:
            (self.videoIDs, self.videoSpeakers, self.videoLabels,
             self.videoText, self.videoAudio, self.videoVisual,
             self.videoSentence, self.trainVid, self.testVid,
             self._extra) = pickle.load(f, encoding="latin1")
        self.keys = list(self.trainVid if train else self.testVid)

    def __len__(self) -> int:
        return len(self.keys)

    def __getitem__(self, index: int) -> Dialogue:
        vid = self.keys[index]
        return Dialogue(
            vid=str(vid),
            text=_as2d(self.videoText[vid]),
            visual=_as2d(self.videoVisual[vid]),
            audio=_as2d(self.videoAudio[vid]),
            qmask=np.asarray(self.videoSpeakers[vid], dtype=np.float32),
            label=np.asarray(self.videoLabels[vid], dtype=np.int32),
        )

    def return_labels(self) -> List[int]:
        """Every utterance's label, dialogue by dialogue."""
        out: List[int] = []
        for key in self.keys:
            out += list(self.videoLabels[key])
        return out

    def dialogues(self) -> List[Dialogue]:
        return [self[i] for i in range(len(self))]


@dataclass
class TokenDialogue:
    """One DailyDialogue conversation: token ids for the trainable
    TextCNN, speaker one-hots, labels."""

    vid: str
    tokens: np.ndarray   # (len, max_words) int32 token ids
    qmask: np.ndarray    # (len, 2)
    label: np.ndarray    # (len,) int32

    def __len__(self) -> int:
        return self.tokens.shape[0]


class DailyDialogueDataset:
    """DailyDialogue 7-way ERC on token ids (reference
    ``dataloader.py:71-101``); ``split`` is 'train', 'valid' or 'test'."""

    n_speakers = 2
    n_classes = 7

    def __init__(self, split: str, path: str):
        with open(path, "rb") as f:
            (self.Speakers, self.Features, self.ActLabels, self.EmotionLabels,
             self.trainId, self.testId, self.validId) = pickle.load(f)
        ids = {"train": self.trainId, "test": self.testId,
               "valid": self.validId}
        if split not in ids:
            raise ValueError(f"unknown split {split!r}")
        self.keys = list(ids[split])

    def __len__(self) -> int:
        return len(self.keys)

    def __getitem__(self, index: int) -> TokenDialogue:
        conv = self.keys[index]
        qmask = np.array([[1.0, 0.0] if s == "0" else [0.0, 1.0]
                          for s in self.Speakers[conv]], dtype=np.float32)
        return TokenDialogue(
            vid=str(conv),
            tokens=np.asarray(self.Features[conv], dtype=np.int32),
            qmask=qmask,
            label=np.asarray(self.EmotionLabels[conv], dtype=np.int32),
        )

    def dialogues(self) -> List[TokenDialogue]:
        return [self[i] for i in range(len(self))]


def train_valid_split(n: int, valid_rate: float):
    """(train, valid) index lists: the first ``valid_rate`` fraction is
    validation (reference ``get_train_valid_sampler``,
    ``run_train_erc.py:29-33``)."""
    split = int(valid_rate * n)
    idx = list(range(n))
    return idx[split:], idx[:split]
