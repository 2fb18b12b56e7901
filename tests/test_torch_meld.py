"""MELD through the port against the JAX package: the synthetic pickle, the
dataset and batcher, the model's log-probs on bridged weights at 2 and at
MELD's published 64 layers, three ``Trainer`` steps; and the training CLI's
``--dataset MELD``, ``--test_label`` and the server on its checkpoint."""

import io
import json
from functools import partial

import numpy as np
import pytest
import torch

import jax
import optax

from mmdfn_tpu.config import ExperimentConfig as JConfig
from mmdfn_tpu.data.batching import BucketBatcher as JBucketBatcher
from mmdfn_tpu.data.datasets import MELDDataset as JMELDDataset
from mmdfn_tpu.data.synthetic import (
    make_synthetic_meld_pickle as j_make_meld_pickle)
from mmdfn_tpu.models.dialogue_gnn import DialogueGNN as JDialogueGNN
from mmdfn_tpu.tools.import_torch_checkpoint import state_dict_to_params
from mmdfn_tpu.train import Trainer as JTrainer
from mmdfn_tpu.train.trainer import prepare_inputs as j_prepare_inputs

from mmdfn_torch.config import ExperimentConfig
from mmdfn_torch.data.batching import BucketBatcher
from mmdfn_torch.data.datasets import MELDDataset
from mmdfn_torch.data.synthetic import make_synthetic_meld_pickle
from mmdfn_torch.models import DialogueGNN
from mmdfn_torch.runtime import checkpoint as ckpt_lib
from mmdfn_torch.train import Trainer
from mmdfn_torch.train.trainer import prepare_inputs
from mmdfn_torch.weights import params_from_jax


# XLA's CPU backend at its lowest optimisation level: the same operations,
# compiled in about two thirds of the time
fast_jit = partial(jax.jit, compiler_options=dict(
    xla_backend_optimization_level=0, xla_llvm_disable_expensive_passes=True))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # small tensors: with several test workers on a few cores, one torch
    # thread per core makes every op wait for the others (a test of 0.7 s
    # alone took 120 s beside five other workers)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the MELD grid's fixed settings (mmdfn_tpu/cli/sweep.py:40-44)
MELD = dict(dataset="MELD", graph_type="GDF", reason_flag=True,
            speaker_weights="0.5-0.5-1.5", class_weight=False)


@pytest.fixture(scope="module")
def meld_pickle(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("meld") / "meld.pkl")
    make_synthetic_meld_pickle(path, n_train=7, n_test=3, min_len=3,
                               max_len=12, seed=4)
    return path


def test_synthetic_meld_pickle_matches_jax(tmp_path):
    ours, theirs = tmp_path / "port.pkl", tmp_path / "jax.pkl"
    kw = dict(n_train=3, n_test=2, min_len=2, max_len=9, seed=5)
    assert make_synthetic_meld_pickle(str(ours), **kw) == \
        j_make_meld_pickle(str(theirs), **kw)
    assert ours.read_bytes() == theirs.read_bytes()


def test_meld_dataset_and_batcher_match_jax(meld_pickle):
    for train in (True, False):
        ds, jds = MELDDataset(meld_pickle, train), JMELDDataset(meld_pickle,
                                                                train)
        assert ds.return_labels() == jds.return_labels()
        a, b = ds.dialogues(), jds.dialogues()
        assert [d.vid for d in a] == [d.vid for d in b]
        for x, y in zip(a, b):
            assert x.qmask.shape[1] == 9
            for f in ("text", "audio", "visual", "qmask", "label"):
                np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
    dias = MELDDataset(meld_pickle, train=True).dialogues()
    jdias = JMELDDataset(meld_pickle, train=True).dialogues()
    for epoch, sort in ((0, False), (1, True)):
        got = list(BucketBatcher(dias, 3, 9, (8, 12), shuffle=True, seed=5,
                                 sort_by_length=sort).epoch(epoch))
        want = list(JBucketBatcher(jdias, 3, 9, (8, 12), shuffle=True,
                                   seed=5, sort_by_length=sort).epoch(epoch))
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            assert a.vids == b.vids
            for k in ("text", "visual", "audio", "qmask", "umask", "label"):
                np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


def _batch(rng, lengths, L):
    B = len(lengths)
    umask = (np.arange(L)[None] < np.asarray(lengths)[:, None]).astype(
        np.float32)
    feats = [(rng.standard_normal((B, L, D)) * umask[..., None]).astype(
        np.float32) for D in (600, 300, 342)]
    qmask = np.eye(9, dtype=np.float32)[rng.integers(0, 9, (B, L))]
    return feats, qmask * umask[..., None], umask


@pytest.mark.parametrize("nl,lengths,L", [(2, [16, 11, 5, 9], 16),
                                          (64, [6, 4], 6)])
def test_meld_logprobs_match_jax(nl, lengths, L):
    """The MELD model (9 speakers, 7 classes, text 600 / audio 300 / visual
    342) on the JAX model's weights, bridged by name: at 2 layers and at
    MELD's published 64."""
    jcfg = JConfig(**MELD, Deep_GCN_nlayers=nl)
    jm = JDialogueGNN.from_config(jcfg)
    rng = np.random.default_rng(nl)
    (text, audio, visual), qmask, umask = _batch(rng, lengths, L)
    # the JAX tree's shapes, filled from the seed (running flax's init op by
    # op would take longer than the rest of the test)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(3), text, qmask, umask, audio, visual,
        deterministic=True))["params"]
    params = jax.tree_util.tree_map(lambda s: rng.uniform(
        -1.0, 1.0, s.shape).astype(np.float32) / np.sqrt(s.shape[0]),
        shapes)
    fwd = fast_jit(lambda p, *a: jm.apply({"params": p}, *a,
                                         deterministic=True))
    want = np.asarray(fwd(params, text, qmask, umask, audio, visual))
    pm = DialogueGNN.from_config(ExperimentConfig(**MELD,
                                                  Deep_GCN_nlayers=nl))
    pm.load_state_dict(params_from_jax(params))
    T = torch.from_numpy
    with torch.inference_mode():
        got = pm(T(text), T(qmask), T(umask), T(audio), T(visual)).numpy()
    assert got.shape == (len(lengths), L, 7)
    valid = umask > 0
    # f32 on both sides; summation order through the encoders and nl layers
    np.testing.assert_allclose(got[valid], want[valid], atol=1e-4)


def test_three_meld_trainer_steps_match_the_jax_trainer(meld_pickle):
    """MELD (no class weights, focal loss, Adam with coupled L2) at dropout
    0, 2 GCNII layers, B = 2, L <= 12, from the port's seeded weights
    bridged into the JAX tree: the first step's gradients and three steps'
    losses, against the JAX ``Trainer``'s model, loss and optimiser."""
    kw = dict(MELD, Deep_GCN_nlayers=2, dropout=0.0, batch_size=2,
              buckets=(12,), lr=5e-4)
    tr = Trainer(ExperimentConfig(**kw), device="cpu")
    jtr = JTrainer(JConfig(**kw))
    shapes = jax.eval_shape(lambda: jtr._init_variables(
        jax.random.PRNGKey(0), jtr._example_inputs()))["params"]
    template = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes)
    params = state_dict_to_params(
        {k: v.numpy() for k, v in tr.model.state_dict().items()}, template)
    state = (params, fast_jit(jtr.tx.init)(params))

    @fast_jit
    def jstep(state, inputs, key):
        p, opt = state
        loss, grads = jax.value_and_grad(lambda q: jtr._loss(
            jtr._apply_model(q, inputs, False, {"dropout": key}),
            inputs["label"], inputs["umask"]))(p)
        updates, opt = jtr.tx.update(grads, opt, p)
        return (optax.apply_updates(p, updates), opt), loss, grads

    dias = MELDDataset(meld_pickle, train=True).dialogues()
    batches = list(BucketBatcher(dias, 2, 9, (12,)).epoch(0))[:3]
    key = jax.random.PRNGKey(0)
    jlosses, losses = [], []
    for i, b in enumerate(batches):
        state, jloss, jg = jstep(state, j_prepare_inputs(jtr.cfg, b),
                                 jax.random.fold_in(key, i))
        jlosses.append(float(jloss))
        loss, _ = tr.train_step(prepare_inputs(b, tr.device), seed=i)
        losses.append(float(loss))
        if i == 0:
            jgrads = jg
            grads = {k: p.grad.numpy().copy()
                     for k, p in tr.model.named_parameters()}
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    got = dict(jax.tree_util.tree_leaves_with_path(
        state_dict_to_params(grads, template)))
    want = jax.tree_util.tree_leaves_with_path(jgrads)
    assert len(got) == len(want)
    for path, w in want:
        w = np.asarray(w)
        scale = max(np.abs(w).max(), 1e-12)
        err = np.abs(got[path] - w).max()
        assert err <= 1e-4 * scale, (jax.tree_util.keystr(path), err, scale)


def test_meld_cli_trains_evaluates_and_serves(meld_pickle, tmp_path,
                                              monkeypatch, capsys):
    """One epoch of ``--dataset MELD`` on the CPU; ``--test_label`` on its
    directory writes the labels, predictions and activations, and its
    F-score is ``Trainer.evaluate``'s on the restored weights; the server
    answers from the same directory; a directory without a checkpoint
    exits 1."""
    from mmdfn_torch.cli import run_train_erc, serve

    ckpt, out = str(tmp_path / "ckpt"), tmp_path / "out"
    flags = ["--dataset", "MELD", "--data_dir", meld_pickle,
             "--Deep_GCN_nlayers", "2", "--reason_flag", "--speaker_weights",
             "0.5-0.5-1.5", "--batch-size", "4", "--buckets", "12"]
    assert run_train_erc.main([*flags, "--no_cuda", "--epochs", "1",
                               "--save_model_dir", ckpt]) == 0
    assert "epoch: 0, train_loss: " in capsys.readouterr().out
    assert run_train_erc.main([*flags, "--device", "cpu", "--test_label",
                               "--load_model", ckpt,
                               "--save_model_dir", str(out)]) == 0
    printed = capsys.readouterr().out
    fscore = float(printed.split("test_fscore:")[1].split()[0])
    labels = np.load(out / "test_label.npy")
    preds = np.load(out / "test_pred.npy")
    test = MELDDataset(meld_pickle, train=False).dialogues()
    assert len(labels) == len(preds) == sum(len(d) for d in test)
    cfg = ExperimentConfig(**ckpt_lib.read_meta(ckpt)["config"])
    tr = Trainer(cfg, device="cpu")
    ckpt_lib.restore_checkpoint(ckpt, tr.model)
    m = tr.evaluate(test)
    assert m.fscore == fscore
    np.testing.assert_array_equal(m.preds, preds)
    acts = np.load(out / "test_activations.npz")
    for name in ("linear_l", "lstm_l", "rnn_parties", "graph_model",
                 "smax_fc", "model"):
        assert name in acts.files, name
    assert acts["model"].shape[-1] == 7

    d = test[0]
    lines = [json.dumps({"text": d.text[t].tolist(),
                         "audio": d.audio[t].tolist(),
                         "visual": d.visual[t].tolist(),
                         "speaker": int(d.qmask[t].argmax())})
             for t in range(2)]
    monkeypatch.setattr("sys.stdin", io.StringIO("\n".join(lines) + "\n"))
    assert serve.main(["--load_model", ckpt, "--device", "cpu",
                       "--buckets", "4"]) == 0
    resp = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert resp[0]["ready"] and len(resp) == 3
    assert all(len(r["log_probs"]) == 7 for r in resp[1:])

    assert run_train_erc.main([*flags, "--device", "cpu", "--test_label",
                               "--save_model_dir", str(tmp_path / "none")]
                              ) == 1
    assert "no checkpoint found" in capsys.readouterr().err
