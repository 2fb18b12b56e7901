"""The generator: the stated length laws, the same shapes for every seed,
the same inputs for the same seed; the weights' draw."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import data
from portbench.reference import batches as rb

CONFIGS = Path(__file__).resolve().parent.parent / "configs"


def _conf(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_meld_lengths_mean_and_cap():
    d = _conf("meld_gdf64")["data"]
    train = data.lengths(d["lengths"], d["n_train"])
    test = data.lengths(d["lengths"], d["n_test"])
    # MELD: 9989 training utterances over 1039 dialogues, at most 33
    assert abs(train.mean() - 9989 / 1039) < 0.05
    assert abs(test.mean() - 9989 / 1039) < 0.05
    assert train.max() == 33 and train.min() >= 1
    assert (train == 33).sum() >= 5


def test_iemocap_lengths_mean_and_range():
    d = _conf("iemocap_gdf16")["data"]
    train = data.lengths(d["lengths"], d["n_train"])
    assert train.mean() == pytest.approx(50.0, abs=0.5)
    assert train.min() == 20 and train.max() == 80


def test_every_seed_the_same_shapes_the_same_seed_the_same_inputs():
    conf = _conf("meld_gdf64")
    dims = {"text": 600, "audio": 300, "visual": 342}
    small = dict(conf["data"], n_train=40, n_test=8)
    a = data.dialogues(small, dims, 9, 7, 2 ** 31 + 11)
    b = data.dialogues(small, dims, 9, 7, 2 ** 31 + 11)
    c = data.dialogues(small, dims, 9, 7, 5)
    assert [len(x) for x in a[0]] == [len(x) for x in c[0]]
    assert all(np.array_equal(x.audio, y.audio) for x, y in zip(a[0], b[0]))
    assert not np.array_equal(a[0][0].audio, c[0][0].audio)
    assert all(x.qmask.sum(1).min() == 1 for x in a[0])


def test_schedule_buckets():
    lens = [5, 30, 12, 33, 7]
    got = rb.schedule(lens, 2, (16, 24, 32, 48), 0, 0, shuffle=False)
    assert [L for _, L in got] == [32, 48, 16]


def test_weights_bounds_and_seed():
    shapes = {"lin.weight": (4, 100), "lin.bias": (4,),
              "g.convs.0.weight": (200, 100), "rnn.weight_hh_l0": (12, 4),
              "rnn.bias_ih_l0": (12,)}
    w = data.weights(shapes, 7, "cpu")
    assert w["lin.bias"].abs().max() <= 0.1
    assert w["rnn.bias_ih_l0"].abs().max() <= 0.5
    assert w["g.convs.0.weight"].abs().max() <= 0.1
    assert torch.equal(w["lin.weight"], data.weights(shapes, 7,
                                                     "cpu")["lin.weight"])
