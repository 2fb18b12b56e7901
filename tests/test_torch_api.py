"""The rest of the JAX package's public names in the port, each against
its namesake (``MultiHeadAttention``: ``tests/test_torch_attention.py``):
``masked_mse_loss``, ``window_relation_adjacency`` and ``cross_mask``,
``LSTMCellStep``, ``mask_from_lengths`` and ``pair_mask``,
``make_epoch_batches`` and ``BucketBatcher.num_batches``, the profiling
module's ``annotate``, ``grad_histograms`` and ``JsonlWriter``; and the
native packer against the numpy packer, byte for byte."""

import json
import shutil
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmdfn_tpu.data.batching import make_epoch_batches as j_make_epoch_batches
from mmdfn_tpu.data.datasets import IEMOCAPDataset as JIEMOCAPDataset
from mmdfn_tpu.graph.adjacency import mm_wo_speaker_adjacency as j_mm_wo
from mmdfn_tpu.graph.adjacency import \
    window_relation_adjacency as j_window_relation_adjacency
from mmdfn_tpu.losses import masked_mse_loss as j_masked_mse_loss
from mmdfn_tpu.nn.rnn import LSTMCellStep as JLSTMCellStep
from mmdfn_tpu.runtime import profiling as jprof
from mmdfn_tpu.utils import masking as jmasking

from mmdfn_torch.data import _native, batching
from mmdfn_torch.data.datasets import IEMOCAPDataset
from mmdfn_torch.data.synthetic import make_synthetic_iemocap_pickle
from mmdfn_torch.graph.adjacency import (WINDOW, cross_mask,
                                         window_relation_adjacency)
from mmdfn_torch.losses import masked_mse_loss
from mmdfn_torch.nn.rnn import LSTMCellStep
from mmdfn_torch.runtime import profiling
from mmdfn_torch.utils import masking

# XLA's CPU backend at its lowest optimisation level: the same operations,
# compiled in about two thirds of the time
fast_jit = partial(jax.jit, compiler_options=dict(
    xla_backend_optimization_level=0, xla_llvm_disable_expensive_passes=True))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # small tensors: with several test workers on a few cores, one torch
    # thread per core makes every op wait for the others
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(a):
    return torch.from_numpy(np.array(a))


def test_masked_mse_loss_matches_jax():
    """``tests/test_losses.py``'s inputs, and an all-masked case (the
    denominator's floor of 1)."""
    rng = np.random.default_rng(0)
    pred = rng.standard_normal(40).astype(np.float32)
    target = rng.standard_normal(40).astype(np.float32)
    mask = (rng.random(40) < 0.6).astype(np.float32)
    for m in (mask, np.zeros_like(mask)):
        want = j_masked_mse_loss(jnp.asarray(pred), jnp.asarray(target),
                                 jnp.asarray(m))
        got = masked_mse_loss(T(pred), T(target), T(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_window_relation_adjacency_and_cross_mask_match_jax():
    """``tests/test_adjacency.py``'s window graph (a dialogue of 9 in 12
    slots, w = 2) and one of two dialogues at the default window; and
    each ``mm_wo_speaker_adjacency`` scheme's cross-modal blocks, whose
    support is ``cross_mask``'s (every similarity of these features is
    nonzero)."""
    rng = np.random.default_rng(0)
    for lengths, L, w in (([9], 12, 2), ([24, 13], 24, 10)):
        umask = (np.arange(L)[None] < np.array(lengths)[:, None]).astype(
            np.float32)
        x = (rng.standard_normal((len(lengths), L, 4))
             * umask[..., None]).astype(np.float32)
        want = fast_jit(partial(j_window_relation_adjacency, window=w))(
            x, umask)
        got = window_relation_adjacency(T(x), T(umask), window=w)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    L = 2 * WINDOW + 4
    umask = np.ones((1, L), np.float32)
    feats = [rng.standard_normal((1, L, 6)).astype(np.float32)
             for _ in range(3)]
    for scheme in ("single", "window", "fc"):
        adj = np.asarray(fast_jit(partial(j_mm_wo, scheme=scheme))(
            feats, umask))[0]
        for a in range(3):
            for b in range(3):
                if a != b:
                    block = adj[a * L:(a + 1) * L, b * L:(b + 1) * L]
                    np.testing.assert_array_equal(
                        block != 0, cross_mask(scheme, L, a, b).numpy())


def test_lstm_cell_step_matches_jax():
    """One step from a carried (h, c) on JAX's weights: the output and the
    new carry; the port's fresh weights drawn U(-1/sqrt(H), .)."""
    rng = np.random.default_rng(0)
    H = 6
    x, h, c = (rng.standard_normal((3, H)).astype(np.float32)
               for _ in range(3))
    jm = JLSTMCellStep(hidden_size=H)
    p = jax.tree_util.tree_map(np.asarray, fast_jit(jm.init)(
        jax.random.PRNGKey(0), x, (h, c))["params"])
    want, (wh, wc) = fast_jit(jm.apply)({"params": p}, x, (h, c))
    pm = LSTMCellStep(H)
    assert all(float(t.detach().abs().max()) <= H ** -0.5
               for t in pm.parameters())
    pm.load_state_dict({k: T(v) for k, v in p.items()})
    with torch.no_grad():
        got, (gh, gc) = pm(T(x), (T(h), T(c)))
    assert got is gh
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), atol=1e-6)


def test_mask_helpers_match_jax():
    lengths = np.array([5, 0, 3])
    got = masking.mask_from_lengths(T(lengths), 6)
    want = np.asarray(jmasking.mask_from_lengths(jnp.asarray(lengths), 6))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(masking.pair_mask(got).numpy(),
                                  np.asarray(jmasking.pair_mask(want)))


def test_epoch_batches_match_jax(tmp_path):
    """Both epochs' batches, shuffled, equal JAX's array for array, and
    ``num_batches`` counts them."""
    path = str(tmp_path / "iem.pkl")
    make_synthetic_iemocap_pickle(path, n_train=7, n_test=2, min_len=3,
                                  max_len=12, seed=1)
    dias = IEMOCAPDataset(path, True).dialogues()
    jdias = JIEMOCAPDataset(path, True).dialogues()
    for epoch in (0, 1):
        got = batching.make_epoch_batches(dias, 3, 2, epoch=epoch,
                                          shuffle=True, seed=5,
                                          buckets=(8, 12))
        want = j_make_epoch_batches(jdias, 3, 2, epoch=epoch, shuffle=True,
                                    seed=5, buckets=(8, 12))
        assert len(got) == len(want) == batching.BucketBatcher(
            dias, 3, 2).num_batches() == 3
        for a, b in zip(got, want):
            assert a.vids == b.vids
            for k in ("text", "visual", "audio", "qmask", "umask", "label"):
                np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


def test_profiling_host_helpers_match_jax(tmp_path):
    """``grad_histograms`` equal to JAX's on the same gradients (numpy's
    histogram both ways), ``JsonlWriter`` writing JAX's lines, and
    ``annotate`` naming a region of a torch.profiler trace."""
    grads = {"layer.kernel": np.arange(12.0, dtype=np.float32).reshape(3, 4),
             "layer.bias": np.zeros(4, np.float32)}
    got = profiling.grad_histograms({k: T(v) for k, v in grads.items()},
                                    bins=8)
    want = jprof.grad_histograms({k: jnp.asarray(v)
                                  for k, v in grads.items()}, bins=8)
    assert len(got) == len(want) == 2
    for name in grads:
        for a, b in zip(got[name], want[f"['{name}']"]):
            np.testing.assert_array_equal(a, b)
    rows = [dict(step=1, loss=0.5), dict(step=2, loss=np.float32(0.25))]
    for writer, path in ((profiling.JsonlWriter, tmp_path / "p" / "a.jsonl"),
                         (jprof.JsonlWriter, tmp_path / "j" / "a.jsonl")):
        w = writer(str(path))
        for r in rows:
            w.write(r)
        w.close()
    assert (tmp_path / "p" / "a.jsonl").read_text() == \
        (tmp_path / "j" / "a.jsonl").read_text()
    assert json.loads((tmp_path / "p" / "a.jsonl").read_text().splitlines()[1]
                      )["loss"] == 0.25
    with torch.profiler.profile() as prof:
        with profiling.annotate("gcnii_region"):
            torch.ones(3).sum()
    assert "gcnii_region" in {e.key for e in prof.key_averages()}


@pytest.mark.skipif(shutil.which("g++") is None,
                    reason="no g++ to build the native packer")
def test_native_packer_gives_the_numpy_packers_bytes():
    """``pack_f32`` and ``pack_masks_labels`` against ``batching._pack``
    and ``collate``'s mask and labels: a part-filled batch with an empty
    dialogue, and one large enough to split over threads; too long a
    dialogue or too many dialogues raise."""
    rng = np.random.default_rng(0)
    assert _native.available()
    for lengths, B, L, D in (([3, 0, 5], 4, 6, 7),
                             (list(rng.integers(1, 41, 32)), 32, 48, 1582)):
        arrs = [rng.standard_normal((n, D)).astype(np.float32)
                for n in lengths]
        assert _native.pack_f32(arrs, B, L, D).tobytes() == \
            batching._pack(arrs, B, L, D).tobytes()
        labels = [rng.integers(0, 6, n).astype(np.int32) for n in lengths]
        umask, label = _native.pack_masks_labels(labels, B, L)
        want_u = np.zeros((B, L), np.float32)
        want_l = np.zeros((B, L), np.int64)
        for i, lab in enumerate(labels):
            want_u[i, :len(lab)] = 1.0
            want_l[i, :len(lab)] = lab
        assert umask.tobytes() == want_u.tobytes()
        assert label.tobytes() == want_l.tobytes()
    with pytest.raises(ValueError, match="exceeds bucket"):
        _native.pack_f32([np.zeros((7, 2), np.float32)], 1, 6, 2)
    with pytest.raises(ValueError, match="exceed batch"):
        _native.pack_masks_labels([np.zeros(2, np.int32)] * 3, 2, 6)
