"""DailyDialogue in the port against the JAX package: the TextCNN blocks,
``DialogueGCNDailyModel`` on each base, the synthetic pickle, the token
data path, three ``DailyTrainer`` steps, a whole fit, the training CLI
with ``--test_label``, and the pretrained embedding table."""

import filecmp
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from mmdfn_tpu.config import ExperimentConfig as JConfig
from mmdfn_tpu.data import batching as jbatching
from mmdfn_tpu.data import synthetic as jsynthetic
from mmdfn_tpu.data.datasets import DailyDialogueDataset as JDataset
from mmdfn_tpu.models import daily as jdaily
from mmdfn_tpu.train import TrainState
from mmdfn_tpu.train.daily_trainer import DailyTrainer as JDailyTrainer

from mmdfn_torch.cli import run_train_erc
from mmdfn_torch.config import ExperimentConfig
from mmdfn_torch.data.batching import TokenBucketBatcher, collate_tokens
from mmdfn_torch.data.datasets import DailyDialogueDataset
from mmdfn_torch.data.synthetic import make_synthetic_daily_pickle
from mmdfn_torch.models import from_config
from mmdfn_torch.models.daily import (CNNFeatureExtractor,
                                      DialogueGCNDailyModel, TextCNN)
from mmdfn_torch.runtime import checkpoint as ckpt_lib
from mmdfn_torch.train import DailyTrainer
from mmdfn_torch.weights import params_from_jax


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


def _uniform(rng, shapes, bound=0.3):
    return jax.tree_util.tree_map(lambda s: rng.uniform(
        -bound, bound, s.shape).astype(s.dtype), shapes)


def _init_shapes(module, *args):
    return jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                              *args))["params"]


def _jax_params(jtr, rng, bound=0.1):
    """Uniform weights from ``rng`` shaped as the JAX trainer's model
    (no JAX initialisation to compile)."""
    return _uniform(rng, jax.eval_shape(lambda: jtr._init_variables(
        jax.random.PRNGKey(0), jtr._example_inputs()))["params"], bound)


def _strip(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items()
            if k.startswith(prefix)}


def _token_inputs(rng, lengths, L, W, vocab, pad_words=3):
    """Token ids (0 in the last ``pad_words`` slots of every utterance and
    at pad rows), speaker one-hots and the utterance mask."""
    B = len(lengths)
    umask = (np.arange(L)[None] < np.asarray(lengths)[:, None]).astype(
        np.float32)
    tokens = rng.integers(1, vocab, (B, L, W)).astype(np.int32)
    tokens[..., W - pad_words:] = 0
    tokens *= umask[..., None].astype(np.int32)
    qmask = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (B, L))] \
        * umask[..., None]
    return tokens, qmask, umask


def test_text_cnn_matches_jax():
    """The frame-sequence TextCNN (API surface: no model calls it), on
    ``tests/test_daily.py``'s shapes: output and the input's gradient."""
    rng = np.random.default_rng(1)
    B, L, D, C, E = 3, 9, 6, 4, 5
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    jm = jdaily.TextCNN(input_dim=D, emb_size=E, out_channels=C, dropout=0.0)
    p = _uniform(rng, _init_shapes(jm, x))
    model = TextCNN(D, E, C, dropout=0.0)
    sd = {"embd.weight": torch.from_numpy(np.asarray(p["embd"]["kernel"]).T),
          "embd.bias": torch.from_numpy(np.asarray(p["embd"]["bias"]))}
    for i, K in enumerate((3, 4, 5)):
        conv = p[f"conv_k{K}"]
        sd[f"convs.{i}.weight"] = torch.from_numpy(
            np.transpose(conv["kernel"], (2, 1, 0)).copy())
        sd[f"convs.{i}.bias"] = torch.from_numpy(conv["bias"])
    model.load_state_dict(sd)
    R = rng.standard_normal((B, E)).astype(np.float32)
    jf = lambda u: jm.apply({"params": p}, u)
    want, jgrad = map(np.asarray, fast_jit(lambda u: (jf(u), jax.grad(
        lambda v: jnp.sum(jf(v) * R))(u)))(x))
    t = torch.from_numpy(x).requires_grad_()
    got = model(t)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    (got * torch.from_numpy(R)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), jgrad, atol=1e-5)


def test_cnn_feature_extractor_matches_jax():
    """The token frontend with holes in the utterance mask and zero-padded
    word slots (identical all-zero windows, whose max ties): the features,
    and the gradient of every parameter, the table's padding row 0
    included."""
    rng = np.random.default_rng(2)
    B, L, W, V, E, Fn, O = 2, 5, 12, 30, 8, 5, 6
    tokens, _, umask = _token_inputs(rng, [5, 3], L, W, V, pad_words=6)
    umask[0, 1] = 0.0                                   # a hole
    jm = jdaily.CNNFeatureExtractor(vocab_size=V, embedding_dim=E,
                                    output_size=O, filters=Fn, dropout=0.0)
    p = _uniform(rng, _init_shapes(jm, tokens, umask))
    model = CNNFeatureExtractor(V, E, O, Fn, dropout=0.0)
    model.load_state_dict(_strip(params_from_jax(
        {"cnn_feat_extractor": p}), "cnn_feat_extractor."))
    R = rng.standard_normal((B, L, O)).astype(np.float32)
    jf = jax.jit(lambda q: jm.apply({"params": q}, tokens, umask))
    want = np.asarray(jf(p))
    jgrad = params_from_jax({"cnn_feat_extractor": fast_jit(jax.grad(
        lambda q: jnp.sum(jf(q) * R)))(p)})
    got = model(torch.from_numpy(tokens), torch.from_numpy(umask))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    (got * torch.from_numpy(R)).sum().backward()
    grads = {f"cnn_feat_extractor.{n}": q.grad
             for n, q in model.named_parameters()}
    assert grads.keys() == jgrad.keys()
    for k, g in jgrad.items():
        np.testing.assert_allclose(grads[k].numpy(), g.numpy(), atol=1e-5,
                                   err_msg=k)
    assert float(grads["cnn_feat_extractor.embedding.weight"][0].abs()
                 .max()) > 0


# tests/test_daily.py's small model
SMALL = dict(D_m=24, D_g=8, D_p=6, D_e=8, D_h=8, D_a=8, graph_hidden_size=8,
             n_speakers=2, max_seq_len=20, window_past=3, window_future=3,
             vocab_size=200, embedding_dim=16, cnn_output_size=24,
             cnn_filters=10, n_classes=7, dropout=0.2, dropout_rec=0.2,
             context_attention="general")


@pytest.mark.parametrize("base", ["LSTM", "GRU", "None", "DialogRNN"])
def test_daily_model_matches_jax(base):
    """Log-probs of each base on bridged weights; the submodules carry
    the reference's ``state_dict`` names."""
    rng = np.random.default_rng(len(base))
    args = _token_inputs(rng, [12, 7, 4], 12, 10, 200)
    jm = jdaily.DialogueGCNDailyModel(base_model=base, **SMALL)
    params = _uniform(rng, _init_shapes(jm, *args), 0.2)
    model = DialogueGCNDailyModel(base, **SMALL).eval()
    model.load_state_dict(params_from_jax(params))
    names = {k.split(".")[0] for k in model.state_dict()}
    encoder = {"LSTM": {"lstm"}, "GRU": {"gru"}, "None": {"base_linear"},
               "DialogRNN": {"dialog_rnn_f", "dialog_rnn_r"}}[base]
    assert names == {"cnn_feat_extractor", "att_model", "graph_net",
                     *encoder}
    want = np.asarray(fast_jit(lambda q: jm.apply({"params": q}, *args))(
        params))
    with torch.inference_mode():
        got = model(*map(torch.from_numpy, args)).numpy()
    valid = args[2] > 0
    np.testing.assert_allclose(got[valid], want[valid], atol=1e-4)


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_daily_pickle_is_jaxs_byte_for_byte(seed, tmp_path):
    kw = dict(n_per_split=(5, 2, 3), min_len=2, max_len=9, max_words=7,
              vocab_size=50, seed=seed)
    ours, theirs = str(tmp_path / "ours.pkl"), str(tmp_path / "theirs.pkl")
    assert make_synthetic_daily_pickle(ours, **kw) == \
        jsynthetic.make_synthetic_daily_pickle(theirs, **kw)
    assert filecmp.cmp(ours, theirs, shallow=False)


@pytest.fixture(scope="module")
def pickle_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("daily") / "daily.pkl")
    make_synthetic_daily_pickle(path, n_per_split=(6, 3, 4), min_len=3,
                                max_len=10, max_words=12, vocab_size=80,
                                seed=3)
    return path


def _same_batch(a, b):
    for name in ("tokens", "qmask", "umask", "label"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)
    assert a.vids == b.vids


def test_token_data_path_matches_jax(pickle_path):
    """Each split's dialogues, ``collate_tokens`` (the word axis cut and
    padded) and two shuffled epochs of ``TokenBucketBatcher``, plain and
    sorted by length."""
    for split in ("train", "valid", "test"):
        ours = DailyDialogueDataset(split, pickle_path).dialogues()
        theirs = JDataset(split, pickle_path).dialogues()
        assert [d.vid for d in ours] == [d.vid for d in theirs]
        for a, b in zip(ours, theirs):
            for name in ("tokens", "qmask", "label"):
                np.testing.assert_array_equal(getattr(a, name),
                                              getattr(b, name))
            assert a.tokens.dtype == np.int32
    with pytest.raises(ValueError, match="split"):
        DailyDialogueDataset("dev", pickle_path)
    dias = DailyDialogueDataset("train", pickle_path).dialogues()
    jdias = JDataset("train", pickle_path).dialogues()
    for W in (None, 8, 15):
        _same_batch(collate_tokens(dias[:3], 4, 10, max_words=W),
                    jbatching.collate_tokens(jdias[:3], 4, 10, max_words=W))
    for sort in (False, True):
        ours = TokenBucketBatcher(dias, 4, 14, (8, 12), shuffle=True,
                                  seed=5, sort_by_length=sort)
        theirs = jbatching.TokenBucketBatcher(
            jdias, 4, 14, (8, 12), shuffle=True, seed=5, sort_by_length=sort)
        for e in (0, 1):
            got, want = list(ours.epoch(e)), list(theirs.epoch(e))
            assert len(got) == len(want) == 2
            for a, b in zip(got, want):
                _same_batch(a, b)
                assert a.tokens.shape[2] == 14


def _config(**kw):
    """A DailyDialogue config at the small word-level widths; the batcher's
    ``max_words`` (14) exceeds the pickle's 12, so zero slots exist."""
    base = dict(dataset="DailyDialogue", batch_size=2, buckets=(12,),
                vocab_size=80, max_words=14, embedding_dim=16, cnn_filters=8,
                cnn_output_size=24, windowp=3, windowf=3)
    return {**base, **kw}


@pytest.mark.parametrize("base", ["LSTM", "GRU"])
def test_three_daily_trainer_steps_match_jax(base, pickle_path):
    """Three ``DailyTrainer`` steps (focal loss, Adam with L2) at dropout
    0, the TextCNN's included (its 0.5 is fixed: set to 0 on the port's
    model, JAX's step run deterministic): the losses and the first
    step's gradients, the table's included."""
    kw = _config(base_model=base, dropout=0.0, rec_dropout=0.0)
    jtr = JDailyTrainer(JConfig(**kw))
    params = _jax_params(jtr, np.random.default_rng(len(base)))
    model = from_config(ExperimentConfig(**kw))
    model.cnn_feat_extractor.dropout = 0.0
    model.load_state_dict(params_from_jax(params))
    tr = DailyTrainer(ExperimentConfig(**kw), device="cpu", model=model)
    state = (params, fast_jit(jtr.tx.init)(params))

    @fast_jit
    def jstep(state, inputs):
        p, opt = state
        loss, grads = jax.value_and_grad(lambda q: jtr._loss(
            jtr._apply_model(q, inputs, True), inputs["label"],
            inputs["umask"]))(p)
        updates, opt = jtr.tx.update(grads, opt, p)
        return (optax.apply_updates(p, updates), opt), loss, grads

    dias = DailyDialogueDataset("train", pickle_path).dialogues()
    batches = list(tr._batcher(dias, shuffle=True).epoch(0))
    assert len(batches) == 3
    jlosses, losses = [], []
    for i, b in enumerate(batches):
        state, jloss, jg = jstep(state, jtr._prepare(b))
        jlosses.append(float(jloss))
        loss, _ = tr.train_step(tr._prepare(b), seed=i)
        losses.append(float(loss))
        if i == 0:
            want = params_from_jax(jg)
            grads = {k: p.grad.clone() for k, p in
                     tr.model.named_parameters()}
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert want.keys() == grads.keys()
    for k, w in want.items():
        scale = max(float(w.abs().max()), 1e-12)
        assert float((grads[k] - w).abs().max()) <= 1e-4 * scale, k


def test_daily_fit_restores_and_evaluates(pickle_path, tmp_path):
    """Two epochs of ``fit`` with checkpoints: the restored ``best``
    weights evaluate to the selected epoch's test metrics; a resumed run
    picks up after epoch 1; ``evaluate`` on JAX's initial weights gives
    JAX's metrics; a plain ``Trainer`` refuses the config."""
    kw = _config(base_model="GRU", batch_size=4, epochs=2)
    cfg = ExperimentConfig(**kw)
    ds = lambda s: DailyDialogueDataset(s, pickle_path).dialogues()
    save = str(tmp_path / "ckpt")
    res = DailyTrainer(cfg, device="cpu").fit(
        ds("train"), ds("test"), ds("valid"), verbose=False, save_dir=save)
    assert [r["epoch"] for r in res.history] == [0, 1]
    assert all(np.isfinite(r["train_loss"]) for r in res.history)
    tr = DailyTrainer(cfg, device="cpu")
    _, meta = ckpt_lib.restore_checkpoint(save, tr.model)
    assert meta["epoch"] == res.best_epoch
    m = tr.evaluate(ds("test"))
    assert (m.acc, m.fscore) == (res.best_test_acc, res.best_test_fscore)
    again = DailyTrainer(ExperimentConfig(**{**kw, "epochs": 3}),
                         device="cpu").fit(
        ds("train"), ds("test"), ds("valid"), verbose=False, save_dir=save,
        resume=True)
    assert [r["epoch"] for r in again.history] == [0, 1, 2]
    assert again.history[:2] == res.history

    jtr = JDailyTrainer(JConfig(**kw))
    params = _jax_params(jtr, np.random.default_rng(4), 0.3)
    jstate = TrainState(params=params,
                        opt_state=fast_jit(jtr.tx.init)(params),
                        step=jnp.zeros((), jnp.int32))
    tr.model.load_state_dict(params_from_jax(params))
    m = tr.evaluate(ds("test"))
    jm = jtr.evaluate(jstate, JDataset("test", pickle_path).dialogues())
    assert (m.acc, m.fscore) == (jm.acc, jm.fscore)
    np.testing.assert_array_equal(m.preds, jm.preds)
    assert abs(m.loss - jm.loss) <= 1e-4
    from mmdfn_torch.train import Trainer
    with pytest.raises(ValueError, match="DailyTrainer"):
        Trainer(cfg, device="cpu")


def test_daily_cli_trains_and_tests_on_the_cpu(pickle_path, tmp_path,
                                               capsys):
    """``--dataset DailyDialogue`` through the training CLI with the word
    flags, then ``--test_label`` on its directory: the saved predictions
    are ``DailyTrainer.evaluate``'s of the saved weights."""
    save, out = str(tmp_path / "ckpt"), str(tmp_path / "out")
    flags = ["--device", "cpu", "--dataset", "DailyDialogue", "--data_dir",
             pickle_path, "--base_model", "GRU", "--vocab_size", "80",
             "--max_words", "14", "--embedding_dim", "16", "--cnn_filters",
             "8", "--cnn_output_size", "24", "--windowp", "3", "--windowf",
             "3", "--batch-size", "4", "--buckets", "12"]
    assert run_train_erc.main([*flags, "--epochs", "1",
                               "--save_model_dir", save]) == 0
    assert "epoch: 0, train_loss: " in capsys.readouterr().out
    assert run_train_erc.main([*flags, "--test_label", "--load_model", save,
                               "--save_model_dir", out]) == 0
    assert "test_fscore:" in capsys.readouterr().out
    cfg = run_train_erc.config_from_args(run_train_erc.build_parser()
                                         .parse_args(flags))
    assert (cfg.vocab_size, cfg.max_words, cfg.embedding_dim,
            cfg.cnn_filters, cfg.cnn_output_size) == (80, 14, 16, 8, 24)
    tr = DailyTrainer(cfg, device="cpu")
    ckpt_lib.restore_checkpoint(save, tr.model)
    m = tr.evaluate(DailyDialogueDataset("test", pickle_path).dialogues())
    np.testing.assert_array_equal(np.load(f"{out}/test_pred.npy"), m.preds)
    np.testing.assert_array_equal(np.load(f"{out}/test_label.npy"), m.labels)
    acts = np.load(f"{out}/test_activations.npz")
    assert "cnn_feat_extractor" in acts and "gru" in acts


def test_pretrained_embeddings_frozen_and_trainable(pickle_path):
    """A frozen pretrained table takes no step (Adam and its L2 leave it
    bit-equal) while ``fc`` moves; unfrozen it moves; a table of another
    shape is refused."""
    cfg = ExperimentConfig(**_config(base_model="None", batch_size=4))
    dias = DailyDialogueDataset("train", pickle_path).dialogues()
    vectors = np.random.default_rng(0).standard_normal(
        (cfg.vocab_size, cfg.embedding_dim)).astype(np.float32)
    for freeze in (True, False):
        tr = DailyTrainer(cfg, device="cpu")
        tr.init_pretrained_embeddings(vectors, freeze=freeze)
        cnn = tr.model.cnn_feat_extractor
        assert np.array_equal(cnn.embedding.weight.detach().numpy(), vectors)
        fc = cnn.fc.weight.detach().clone()
        tr.train_step(tr._prepare(next(tr._batcher(dias).epoch())), seed=0)
        table = cnn.embedding.weight.detach().numpy()
        assert np.array_equal(table, vectors) == freeze
        assert not torch.equal(cnn.fc.weight, fc)
    with pytest.raises(ValueError, match="vocab_size, embedding_dim"):
        tr.init_pretrained_embeddings(vectors[:, :8])


def test_daily_is_refused_where_the_jax_package_has_no_path():
    """Neither package serves a DailyDialogue model nor imports one from a
    reference checkpoint: both refuse the config by name."""
    from mmdfn_torch.serve import StreamingSession
    from mmdfn_torch.tools.import_torch_checkpoint import import_state_dict

    cfg = ExperimentConfig(**_config(base_model="None"))
    with pytest.raises(ValueError, match="token ids"):
        StreamingSession(from_config(cfg), cfg, device="cpu")
    with pytest.raises(ValueError, match="DailyDialogue"):
        import_state_dict({}, cfg)
