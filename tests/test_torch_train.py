"""The port's training slice against the JAX package: focal loss, metrics,
the bucket batcher, three ``Trainer`` steps of the flagship at dropout 0
from bridged weights; and the port's ``fit`` with its checkpoints and CLI."""

import json
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from mmdfn_tpu.config import ExperimentConfig as JConfig
from mmdfn_tpu.data.batching import BucketBatcher as JBucketBatcher
from mmdfn_tpu.data.datasets import IEMOCAPDataset as JIEMOCAPDataset
from mmdfn_tpu.losses import focal_loss as j_focal_loss
from mmdfn_tpu.losses import masked_nll_loss as j_masked_nll_loss
from mmdfn_tpu.tools.import_torch_checkpoint import state_dict_to_params
from mmdfn_tpu.train import Trainer as JTrainer
from mmdfn_tpu.train import metrics as JM
from mmdfn_tpu.train.trainer import prepare_inputs as j_prepare_inputs

from mmdfn_torch.config import ExperimentConfig
from mmdfn_torch.data.batching import BucketBatcher
from mmdfn_torch.data.datasets import IEMOCAPDataset
from mmdfn_torch.data.synthetic import make_synthetic_iemocap_pickle
from mmdfn_torch.losses import focal_loss, masked_nll_loss
from mmdfn_torch.runtime import checkpoint as ckpt_lib
from mmdfn_torch.train import Trainer
from mmdfn_torch.train import metrics as M
from mmdfn_torch.train.trainer import prepare_inputs


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


def _logp(rng, shape):
    z = rng.standard_normal(shape).astype(np.float32)
    return z - np.log(np.exp(z).sum(-1, keepdims=True))


@pytest.mark.parametrize("weighted", [False, True])
def test_losses_match_jax(weighted):
    rng = np.random.default_rng(0)
    logp = _logp(rng, (3, 7, 6))
    label = rng.integers(0, 6, (3, 7))
    mask = (rng.random((3, 7)) > 0.3).astype(np.float32)
    w = (np.asarray(JConfig(class_weight=True).class_weights_or_none())
         if weighted else None)
    T = torch.from_numpy
    lp = T(logp).requires_grad_()
    got = focal_loss(lp, T(label), T(mask), gamma=0.5,
                     alpha=None if w is None else T(w))
    jf = lambda x: j_focal_loss(x, jnp.asarray(label), jnp.asarray(mask),
                                gamma=0.5, alpha=w)
    want, jgrad = fast_jit(jax.value_and_grad(jf))(jnp.asarray(logp))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    got.backward()       # pt is detached on both sides
    np.testing.assert_allclose(lp.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-5, atol=1e-7)
    got = masked_nll_loss(T(logp), T(label), T(mask),
                          weight=None if w is None else T(w))
    want = j_masked_nll_loss(jnp.asarray(logp), jnp.asarray(label),
                             jnp.asarray(mask), weight=w)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_metrics_match_jax():
    rng = np.random.default_rng(1)
    labels = rng.integers(0, 6, 200)
    preds = np.where(rng.random(200) < 0.6, labels, rng.integers(0, 6, 200))
    preds[preds == 2] = 3                    # a class never predicted
    names = JConfig().info["target_names"]
    assert M.accuracy(labels, preds) == JM.accuracy(labels, preds)
    assert M.f1_score(labels, preds, 6) == JM.f1_score(labels, preds, 6)
    assert M.classification_report(labels, preds, names) == \
        JM.classification_report(labels, preds, names)
    assert M.per_class_accuracy(labels, preds, names) == \
        JM.per_class_accuracy(labels, preds, names)
    assert M.reference_rounding(0.123456) == JM.reference_rounding(0.123456)


@pytest.fixture(scope="module")
def pickle_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("iem") / "iem.pkl")
    make_synthetic_iemocap_pickle(path, n_train=7, n_test=3, min_len=3,
                                  max_len=12, seed=4)
    return path


def test_bucket_batcher_matches_jax(pickle_path):
    dias = IEMOCAPDataset(pickle_path, train=True).dialogues()
    jdias = JIEMOCAPDataset(pickle_path, train=True).dialogues()
    for epoch in (0, 1):
        got = list(BucketBatcher(dias, 3, 2, (8, 12), shuffle=True,
                                 seed=5).epoch(epoch))
        want = list(JBucketBatcher(jdias, 3, 2, (8, 12), shuffle=True,
                                   seed=5).epoch(epoch))
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            assert a.vids == b.vids
            for k in ("text", "visual", "audio", "qmask", "umask", "label"):
                np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


NL = 2


def test_three_trainer_steps_match_the_jax_trainer(pickle_path):
    """The flagship (IEMOCAP GDF + reason, class weights, focal loss, Adam
    with coupled L2) at dropout 0, 2 GCNII layers, B = 2, L <= 12, parity
    defaults, from the port's seeded weights bridged into the JAX tree: the
    first step's gradients and three steps' losses.  The JAX side is the
    JAX ``Trainer``'s own model apply, loss and optimiser in one jitted
    step, which also returns the gradients (``Trainer._train_step`` does
    not)."""
    kw = dict(dataset="IEMOCAP", graph_type="GDF", reason_flag=True,
              Deep_GCN_nlayers=NL, dropout=0.0, batch_size=2,
              class_weight=True, buckets=(12,))
    cfg = ExperimentConfig(**kw)
    tr = Trainer(cfg, device="cpu")
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

    dias = IEMOCAPDataset(pickle_path, train=True).dialogues()
    batches = list(BucketBatcher(dias, 2, 2, (12,)).epoch(0))[:3]
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
    # the losses: f32 through the whole model on both sides
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


def test_fit_writes_and_restores_best(pickle_path, tmp_path):
    cfg = ExperimentConfig(graph_type="GDF", reason_flag=True,
                           Deep_GCN_nlayers=NL, epochs=2, batch_size=4,
                           buckets=(8, 12), lr=3e-3, dropout=0.2)
    dias = IEMOCAPDataset(pickle_path, train=True).dialogues()
    test = IEMOCAPDataset(pickle_path, train=False).dialogues()
    tr = Trainer(cfg, device="cpu")
    log = tmp_path / "train.jsonl"
    res = tr.fit(dias, test, verbose=False, save_dir=str(tmp_path),
                 log_path=str(log))
    rows = [json.loads(l) for l in log.read_text().splitlines()]
    assert [r["epoch"] for r in rows] == [0, 1]
    assert all(np.isfinite(r["train_loss"]) for r in rows)
    assert ckpt_lib.has_checkpoint(str(tmp_path), "best")
    assert ckpt_lib.has_checkpoint(str(tmp_path), "last")
    # the selected weights, restored into a fresh model, score as recorded
    fresh = Trainer(cfg, device="cpu")
    _, meta = ckpt_lib.restore_checkpoint(str(tmp_path), fresh.model)
    assert meta["epoch"] == res.best_epoch
    for k, v in res.state_dict.items():
        assert torch.equal(fresh.model.state_dict()[k], v)
    assert fresh.evaluate(test).fscore == res.best_test_fscore
    # resume: the run already finished its epochs, so it trains no more
    again = Trainer(cfg, device="cpu").fit(
        dias, test, verbose=False, save_dir=str(tmp_path), resume=True)
    assert [(r["epoch"], r["train_loss"], r["test_fscore"])
            for r in again.history] == [
        (r["epoch"], r["train_loss"], r["test_fscore"]) for r in res.history]
    assert again.best_epoch == res.best_epoch


def test_training_cli_runs_on_the_cpu(pickle_path, tmp_path, capsys):
    from mmdfn_torch.cli import run_train_erc

    assert run_train_erc.main([
        "--device", "cpu", "--epochs", "1", "--data_dir", pickle_path,
        "--Deep_GCN_nlayers", "1", "--reason_flag", "--batch-size", "4",
        "--buckets", "12", "--save_model_dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "epoch: 0, train_loss: " in out and "Final Test performance" in out
    # DailyDialogue trains (tests/test_torch_daily.py): it reaches the data
    with pytest.raises(FileNotFoundError, match="none.pkl"):
        run_train_erc.main(["--device", "cpu", "--dataset", "DailyDialogue",
                            "--data_dir", str(tmp_path / "none.pkl")])
    # one stream of three modalities: the JAX package has no such input
    with pytest.raises(ValueError, match="one modality"):
        run_train_erc.main(["--device", "cpu", "--data_dir", pickle_path,
                            "--graph_type", "relation", "--no_multi_modal"])


def _utterances(pickle_path, n):
    d = IEMOCAPDataset(pickle_path, train=False).dialogues()[0]
    return [(d.text[t], d.audio[t], d.visual[t], int(d.qmask[t].argmax()))
            for t in range(n)]


def test_serve_cli_serves_the_trainers_checkpoint(pickle_path, tmp_path,
                                                  monkeypatch, capsys):
    """One epoch of the training CLI writes its directory; the server and
    the latency bench load it as their --load_model, answer with the
    trained weights and report the checkpoint's epoch."""
    import io

    from mmdfn_torch.cli import run_train_erc, serve
    from mmdfn_torch.models import DialogueGNN
    from mmdfn_torch.serve import StreamingSession, latency_bench
    from mmdfn_torch.weights import load_served

    save = str(tmp_path / "ckpts")
    assert run_train_erc.main([
        "--device", "cpu", "--epochs", "1", "--data_dir", pickle_path,
        "--Deep_GCN_nlayers", "1", "--reason_flag", "--batch-size", "4",
        "--buckets", "12", "--save_model_dir", save]) == 0
    capsys.readouterr()
    meta = ckpt_lib.read_meta(save)
    utts = _utterances(pickle_path, 2)
    lines = [json.dumps({"text": x.tolist(), "audio": a.tolist(),
                         "visual": v.tolist(), "speaker": s})
             for x, a, v, s in utts]
    monkeypatch.setattr("sys.stdin", io.StringIO("\n".join(lines) + "\n"))
    assert serve.main(["--load_model", save, "--device", "cpu",
                       "--buckets", "4"]) == 0
    out = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert out[0]["ready"] and out[0]["ckpt_epoch"] == meta["epoch"] == 0
    assert len(out) == 3

    # the restored model's own forward, from the same directory
    cfg = ExperimentConfig(**meta["config"])
    model, _ = ckpt_lib.restore_checkpoint(save, DialogueGNN.from_config(cfg))
    session = StreamingSession(model, cfg, buckets=(4,), device="cpu")
    for (x, a, v, s), got in zip(utts, out[1:]):
        pred, logp = session.append(x, a, v, s)
        assert got["pred"] == pred
        # the server rounds log-probs to 4 decimals
        np.testing.assert_allclose(got["log_probs"], logp, atol=5e-5 + 1e-6)
    cfg2, served, epoch = load_served(save)
    assert cfg2.Deep_GCN_nlayers == 1 and epoch == 0
    for k, v in model.state_dict().items():
        assert torch.equal(served.state_dict()[k], v)
    stats = latency_bench.run(n_dialogues=1, min_len=3, max_len=4,
                              buckets=(8,), load_model=save, device="cpu")
    assert stats["ckpt_epoch"] == 0 and stats["model"].startswith(
        "MM-DFN GDF 1L")


@pytest.mark.parametrize("what", ["no checkpoint", "no config"])
def test_serve_cli_refuses_a_directory_it_cannot_serve(tmp_path, what,
                                                       capsys):
    from mmdfn_torch.cli import serve
    from mmdfn_torch.models import DialogueGNN

    if what == "no config":
        model = DialogueGNN.from_config(ExperimentConfig(Deep_GCN_nlayers=1))
        ckpt_lib.save_checkpoint(str(tmp_path), model, meta={"epoch": 3})
    assert serve.main(["--load_model", str(tmp_path), "--device",
                       "cpu"]) == 1
    err = capsys.readouterr().err
    assert ("no checkpoint" if what == "no checkpoint" else "no config") \
        in err
