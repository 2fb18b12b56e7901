"""The port's data code and adjacency against the JAX package's."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmdfn_tpu.data import batching as jbatching
from mmdfn_tpu.data import datasets as jdatasets
from mmdfn_tpu.data.synthetic import (
    make_synthetic_iemocap_pickle as j_make_pickle)
from mmdfn_tpu.graph.adjacency import mm_big_adjacency as j_mm_big_adjacency

from mmdfn_torch.config import DATASET_INFO
from mmdfn_torch.data import batching, datasets
from mmdfn_torch.data.synthetic import make_synthetic_iemocap_pickle
from mmdfn_torch.graph.adjacency import mm_big_adjacency


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # small tensors: with several test workers on a few cores, one torch
    # thread per core makes every op wait for the others (a test of 0.7 s
    # alone took 120 s beside five other workers)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_same_seed_gives_the_same_pickle(tmp_path):
    ours, theirs = tmp_path / "port.pkl", tmp_path / "jax.pkl"
    kw = dict(n_train=3, n_test=2, min_len=2, max_len=9, seed=5)
    assert make_synthetic_iemocap_pickle(str(ours), **kw) == \
        j_make_pickle(str(theirs), **kw)
    assert ours.read_bytes() == theirs.read_bytes()
    a = datasets.IEMOCAPDataset(str(ours), train=False).dialogues()
    b = jdatasets.IEMOCAPDataset(str(ours), train=False).dialogues()
    assert [d.vid for d in a] == [d.vid for d in b]
    for x, y in zip(a, b):
        for f in ("text", "audio", "visual", "qmask", "label"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))


def test_constants_and_buckets_match_the_jax_package():
    from mmdfn_tpu import config as jconfig

    assert datasets.FEAT2DIM == jdatasets.FEAT2DIM
    for name in ("IEMOCAP", "MELD"):
        for k, v in DATASET_INFO[name].items():
            assert jconfig.DATASET_INFO[name][k] == v, (name, k)
    buckets = (8, 16, 32, 64, 128, 200)
    for n in (1, 8, 9, 64, 65, 200, 201):
        assert batching.bucket_length(n, buckets) == \
            jbatching.bucket_length(n, buckets)


@pytest.mark.parametrize("modal_weight", [1.0, 0.5])
def test_mm_big_adjacency_matches_jax(modal_weight):
    rng = np.random.default_rng(3)
    B, L = 2, 7
    umask = (np.arange(L)[None] < np.array([[7], [4]])).astype(np.float32)
    feats = [(rng.standard_normal((B, L, 8)) * umask[..., None]).astype(
        np.float32) for _ in range(3)]
    feats[1][0, 2] = feats[2][0, 2] = 0.0        # a zero-norm valid row
    want = j_mm_big_adjacency([jnp.asarray(f) for f in feats],
                              jnp.asarray(umask), modal_weight=modal_weight)
    got = mm_big_adjacency([torch.from_numpy(f) for f in feats],
                           torch.from_numpy(umask), modal_weight=modal_weight)
    # f32 cosines on both sides (TF32 off on the card, HIGHEST in JAX)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    pads = np.tile(umask, (1, 3)) == 0
    for b in range(B):
        assert (got.numpy()[b][pads[b]] == 0).all()
        assert (got.numpy()[b][:, pads[b]] == 0).all()
