"""IEMOCAP feature pickles -> numpy dialogues (the serve and training
paths' subset of ``mmdfn_tpu/data/datasets.py``).

The pickle is the reference's 9-tuple of dicts keyed by dialogue id
(``dataloader.py:12-14``); speakers are 'M'/'F', one-hot as [1,0]/[0,1].
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


def train_valid_split(n: int, valid_rate: float):
    """(train, valid) index lists: the first ``valid_rate`` fraction is
    validation (reference ``get_train_valid_sampler``,
    ``run_train_erc.py:29-33``)."""
    split = int(valid_rate * n)
    idx = list(range(n))
    return idx[split:], idx[:split]
