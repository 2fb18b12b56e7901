"""The general generator of a cell's dialogues and starting weights.

A configuration file (``configs/<name>.json``) states its dataset's split
(``data``: dialogues in train and test, the law of their lengths, speakers
a dialogue has); a traffic file (``traffic/<name>.json``) states how they
are fed.  From ``--seed`` this module draws the features (standard
normal), the labels, each utterance's speaker and the model's starting
weights.  The lengths are not drawn: each split's lengths are the law's
quantiles at evenly spaced levels, in a fixed order, so every seed trains
the same shapes in the same order and only the values differ.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist
from typing import Dict

import numpy as np


@dataclass
class Dialogue:
    """One conversation, with the fields the program's batcher reads."""

    vid: str
    text: np.ndarray     # (len, D_text) float32
    visual: np.ndarray   # (len, D_visual)
    audio: np.ndarray    # (len, D_audio)
    qmask: np.ndarray    # (len, n_speakers) one-hot float32
    label: np.ndarray    # (len,) int32

    def __len__(self) -> int:
        return self.text.shape[0]


def lengths(law: dict, n: int) -> np.ndarray:
    """``n`` dialogue lengths: the law's quantiles at (i + 1/2) / n, placed
    in a fixed shuffled order (a generator of its own, seed 0).

    ``{"law": "uniform", "lo": a, "hi": b}``: integers a..b equally often;
    ``{"law": "lognormal", "median": m, "sigma": s, "lo": a, "hi": b}``:
    ``round(m exp(s z))`` clipped to [a, b]."""
    q = (np.arange(n) + 0.5) / n
    if law["law"] == "uniform":
        lo, hi = int(law["lo"]), int(law["hi"])
        out = lo + np.floor(q * (hi - lo + 1)).astype(np.int64)
    elif law["law"] == "lognormal":
        z = np.asarray([NormalDist().inv_cdf(float(x)) for x in q])
        out = np.rint(law["median"] * np.exp(law["sigma"] * z))
        out = np.clip(out, law["lo"], law["hi"]).astype(np.int64)
    else:
        raise ValueError(f"unknown length law {law['law']!r}")
    return out[np.random.default_rng(0).permutation(n)]


def dialogues(data: dict, dims: Dict[str, int], n_speakers: int,
              n_classes: int, seed: int):
    """(train, test): lists of :class:`Dialogue`, every feature drawn in
    one call per modality and split."""
    rng = np.random.default_rng(seed)
    out = []
    for split in ("train", "test"):
        lens = lengths(data["lengths"], int(data[f"n_{split}"]))
        total = int(lens.sum())
        feats = {m: rng.standard_normal((total, dims[m]), dtype=np.float32)
                 for m in ("text", "audio", "visual")}
        labels = rng.integers(0, n_classes, total).astype(np.int32)
        per = int(data["speakers_per_dialogue"])
        who = rng.integers(0, per, total)
        cast = [rng.choice(n_speakers, per, replace=False) for _ in lens]
        eye = np.eye(n_speakers, dtype=np.float32)
        ends = np.cumsum(lens)
        rows = []
        for d, (n, e) in enumerate(zip(lens, ends)):
            s = slice(e - n, e)
            rows.append(Dialogue(
                vid=f"{split}{d}", text=feats["text"][s],
                audio=feats["audio"][s], visual=feats["visual"][s],
                qmask=eye[cast[d][who[s]]], label=labels[s]))
        out.append(rows)
    return out[0], out[1]


def weights(shapes: Dict[str, tuple], seed: int, device):
    """The starting weights, U(-b, b) per parameter (torch's default
    bounds), drawn on ``device`` from ``seed`` in one call and cut into
    the parameters."""
    import torch

    hidden = {}
    for n, s in shapes.items():
        if n.split(".")[-1].startswith("weight_hh"):
            hidden[n.rsplit(".", 1)[0]] = s[1]
    bounds = {}
    for n, s in shapes.items():
        owner, leaf = n.rsplit(".", 1)
        if ".convs." in n:
            bounds[n] = 1.0 / math.sqrt(s[1])
        elif owner in hidden:
            bounds[n] = 1.0 / math.sqrt(hidden[owner])
        else:                   # a linear layer: 1/sqrt(fan in)
            bounds[n] = 1.0 / math.sqrt(shapes[f"{owner}.weight"][1])
    total = sum(int(np.prod(s)) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for n, s in shapes.items():
        size = int(np.prod(s))
        out[n] = (flat[at:at + size] * bounds[n]).reshape(s)
        at += size
    return out
