"""Synthetic IEMOCAP, MELD and DailyDialogue pickles in the reference
formats.

The same seed writes the same pickle as
``mmdfn_tpu.data.synthetic.make_synthetic_iemocap_pickle``,
``make_separable_iemocap_pickle``, ``make_synthetic_meld_pickle`` and
``make_synthetic_daily_pickle`` (the draws are made in the same order from
the same numpy generator).
"""

from __future__ import annotations

import pickle
from typing import Tuple

import numpy as np

from mmdfn_torch.data.datasets import FEAT2DIM


def _dialogue_lengths(rng, n, lo, hi):
    return [int(rng.integers(lo, hi + 1)) for _ in range(n)]


def make_synthetic_iemocap_pickle(
    path: str,
    n_train: int = 8,
    n_test: int = 4,
    min_len: int = 4,
    max_len: int = 24,
    n_classes: int = 6,
    seed: int = 0,
) -> Tuple[list, list]:
    """Write a 9-tuple IEMOCAP-format pickle of random dialogues."""
    rng = np.random.default_rng(seed)
    D_t, D_a, D_v = FEAT2DIM["textCNN"], FEAT2DIM["IS10"], FEAT2DIM["denseface"]
    videoIDs, videoSpeakers, videoLabels = {}, {}, {}
    videoText, videoAudio, videoVisual, videoSentence = {}, {}, {}, {}
    train_vids, test_vids = [], []
    lengths = _dialogue_lengths(rng, n_train + n_test, min_len, max_len)
    for i, L in enumerate(lengths):
        vid = f"Ses0{i}"
        videoIDs[vid] = [f"{vid}_utt{j}" for j in range(L)]
        videoSpeakers[vid] = [("M" if rng.random() < 0.5 else "F")
                              for _ in range(L)]
        videoLabels[vid] = [int(rng.integers(0, n_classes)) for _ in range(L)]
        videoText[vid] = rng.standard_normal((L, D_t)).astype(np.float32)
        videoAudio[vid] = rng.standard_normal((L, D_a)).astype(np.float32)
        videoVisual[vid] = rng.standard_normal((L, D_v)).astype(np.float32)
        videoSentence[vid] = [f"utterance {j}" for j in range(L)]
        (train_vids if i < n_train else test_vids).append(vid)
    payload = (videoIDs, videoSpeakers, videoLabels, videoText, videoAudio,
               videoVisual, videoSentence, train_vids, test_vids)
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    return train_vids, test_vids


def make_separable_iemocap_pickle(
    path: str,
    n_train: int = 24,
    n_test: int = 8,
    min_len: int = 4,
    max_len: int = 16,
    n_classes: int = 6,
    seed: int = 0,
    noise: float = 0.25,
    speaker_shift: float = 1.0,
) -> Tuple[list, list]:
    """Write a 9-tuple IEMOCAP-format pickle whose labels can be learned:
    each utterance's features in each modality are its class's prototype
    (a random unit direction) plus its speaker's shift and noise,

    ``feat_m[t] = proto_m[y_t] + speaker_shift * spk_m[s_t] + noise * eps``,

    so at the default ``noise`` a model that trains correctly reaches about
    100 weighted F1 on both splits, and one that does not stays near
    chance (about 17)."""
    rng = np.random.default_rng(seed)
    dims = (("t", FEAT2DIM["textCNN"]), ("a", FEAT2DIM["IS10"]),
            ("v", FEAT2DIM["denseface"]))

    def protos(n, D):
        p = rng.standard_normal((n, D))
        return (p / np.linalg.norm(p, axis=1, keepdims=True)).astype(
            np.float32)

    proto = {m: protos(n_classes, D) for m, D in dims}
    spk_shift = {m: protos(2, D) * speaker_shift for m, D in dims}
    videoIDs, videoSpeakers, videoLabels = {}, {}, {}
    videoText, videoAudio, videoVisual, videoSentence = {}, {}, {}, {}
    train_vids, test_vids = [], []
    lengths = _dialogue_lengths(rng, n_train + n_test, min_len, max_len)
    for i, L in enumerate(lengths):
        vid = f"Ses0{i}"
        spk_idx = rng.integers(0, 2, size=L)
        labels = rng.integers(0, n_classes, size=L)
        videoIDs[vid] = [f"{vid}_utt{j}" for j in range(L)]
        videoSpeakers[vid] = ["MF"[s] for s in spk_idx]
        videoLabels[vid] = [int(y) for y in labels]
        feats = {}
        for m, D in dims:
            eps = rng.standard_normal((L, D)).astype(np.float32)
            feats[m] = (proto[m][labels] + spk_shift[m][spk_idx]
                        + noise * eps).astype(np.float32)
        videoText[vid], videoAudio[vid], videoVisual[vid] = (
            feats["t"], feats["a"], feats["v"])
        videoSentence[vid] = [f"utterance {j}" for j in range(L)]
        (train_vids if i < n_train else test_vids).append(vid)
    payload = (videoIDs, videoSpeakers, videoLabels, videoText, videoAudio,
               videoVisual, videoSentence, train_vids, test_vids)
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    return train_vids, test_vids


def make_synthetic_meld_pickle(
    path: str,
    n_train: int = 8,
    n_test: int = 4,
    min_len: int = 3,
    max_len: int = 16,
    n_classes: int = 7,
    n_speakers: int = 9,
    seed: int = 0,
) -> Tuple[list, list]:
    """Write a 10-tuple MELD-format pickle of random dialogues (qmask
    already one-hot, integer dialogue ids)."""
    rng = np.random.default_rng(seed)
    D_t, D_a, D_v = (FEAT2DIM["MELD_text"], FEAT2DIM["MELD_audio"],
                     FEAT2DIM["denseface"])
    videoIDs, videoSpeakers, videoLabels = {}, {}, {}
    videoText, videoAudio, videoVisual, videoSentence = {}, {}, {}, {}
    train_vids, test_vids = [], []
    lengths = _dialogue_lengths(rng, n_train + n_test, min_len, max_len)
    for i, L in enumerate(lengths):
        vid = i
        videoIDs[vid] = [f"dia{i}_utt{j}" for j in range(L)]
        spk = np.zeros((L, n_speakers), dtype=np.float32)
        spk[np.arange(L), rng.integers(0, n_speakers, size=L)] = 1.0
        videoSpeakers[vid] = spk
        videoLabels[vid] = [int(rng.integers(0, n_classes)) for _ in range(L)]
        videoText[vid] = rng.standard_normal((L, D_t)).astype(np.float32)
        videoAudio[vid] = rng.standard_normal((L, D_a)).astype(np.float32)
        videoVisual[vid] = rng.standard_normal((L, D_v)).astype(np.float32)
        videoSentence[vid] = [f"utterance {j}" for j in range(L)]
        (train_vids if i < n_train else test_vids).append(vid)
    payload = (videoIDs, videoSpeakers, videoLabels, videoText, videoAudio,
               videoVisual, videoSentence, train_vids, test_vids, None)
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    return train_vids, test_vids


def make_synthetic_daily_pickle(
    path: str,
    n_per_split: Tuple[int, int, int] = (6, 2, 2),
    min_len: int = 3,
    max_len: int = 12,
    max_words: int = 20,
    vocab_size: int = 200,
    n_classes: int = 7,
    seed: int = 0,
):
    """Write a 7-tuple DailyDialogue-format pickle of random token ids
    (1 ... vocab_size - 1; 0 is the pad); returns the (train, valid, test)
    id lists."""
    rng = np.random.default_rng(seed)
    Speakers, Features, ActLabels, EmotionLabels = {}, {}, {}, {}
    ids = [[], [], []]
    n_total = sum(n_per_split)
    for i, L in enumerate(_dialogue_lengths(rng, n_total, min_len, max_len)):
        conv = f"conv{i}"
        Speakers[conv] = [str(int(rng.integers(0, 2))) for _ in range(L)]
        Features[conv] = rng.integers(1, vocab_size,
                                      size=(L, max_words)).astype(np.int64)
        ActLabels[conv] = [int(rng.integers(0, 4)) for _ in range(L)]
        EmotionLabels[conv] = [int(rng.integers(0, n_classes))
                               for _ in range(L)]
        split = (0 if i < n_per_split[0]
                 else 1 if i < n_per_split[0] + n_per_split[1] else 2)
        ids[split].append(conv)
    payload = (Speakers, Features, ActLabels, EmotionLabels, ids[0], ids[1],
               ids[2])
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    return tuple(ids)
