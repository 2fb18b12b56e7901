"""The non-graph baselines of the port against the JAX package: the
DialogueRNN recurrence with each context attention, with and without the
listener state; the mask-gated bi-LSTM; the GRU, LSTM and DialogRNN
models; three ``Trainer`` steps of a baseline; the masked NLL loss and the
epoch loss weighted by each batch's utterances; the training CLI,
``--test_label`` and the server on a baseline; and the importer on
reference-keyed baseline checkpoints."""

import io
import json
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from mmdfn_tpu.config import ExperimentConfig as JConfig
from mmdfn_tpu.models.baselines import DialogueRNN as JDialogueRNN
from mmdfn_tpu.nn.rnn import BiRNN as JBiRNN
from mmdfn_tpu.tools.import_torch_checkpoint import state_dict_to_params
from mmdfn_tpu.train import Trainer as JTrainer
from mmdfn_tpu.train import TrainState
from mmdfn_tpu.train.trainer import prepare_inputs as j_prepare_inputs

from mmdfn_torch.cli import run_train_erc, serve
from mmdfn_torch.config import ExperimentConfig
from mmdfn_torch.data.batching import BucketBatcher
from mmdfn_torch.data.datasets import IEMOCAPDataset
from mmdfn_torch.data.synthetic import make_synthetic_iemocap_pickle
from mmdfn_torch.losses import focal_loss, masked_nll_loss
from mmdfn_torch.models import GRUModel, LSTMModel, DialogRNNModel
from mmdfn_torch.models.baselines import DialogueRNN
from mmdfn_torch.nn.rnn import BiRNN
from mmdfn_torch.serve import StreamingSession
from mmdfn_torch.tools.import_torch_checkpoint import import_state_dict
from mmdfn_torch.train import Trainer
from mmdfn_torch.train.trainer import prepare_inputs
from mmdfn_torch.weights import build_model, load_served, params_from_jax


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # small tensors: with several test workers on a few cores, one torch
    # thread per core makes every op wait for the others
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# XLA's CPU backend at its lowest optimisation level: the same operations,
# compiled in about two thirds of the time
fast_jit = partial(jax.jit, compiler_options=dict(
    xla_backend_optimization_level=0, xla_llvm_disable_expensive_passes=True))


def _value_and_grad(jf, x, R):
    """``jf(x)`` and the gradient of ``sum(jf(x) R)`` in one compile."""
    return map(np.asarray, fast_jit(lambda u: (jf(u), jax.grad(
        lambda v: jnp.sum(jf(v) * R))(u)))(x))


def _uniform(rng, shapes, bound=0.3):
    return jax.tree_util.tree_map(lambda s: rng.uniform(
        -bound, bound, s.shape).astype(s.dtype), shapes)


def _strip(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("listener", [False, True])
@pytest.mark.parametrize("attention", ["simple", "general", "general2",
                                       "concat"])
def test_dialogue_rnn_matches_jax(attention, listener):
    """The party-state recurrence over dialogues with pads (all-zero
    speaker rows, party 0 by argmax) and three parties: the emotion
    states and their gradient against the input."""
    rng = np.random.default_rng(7)
    B, L, P, D_m, D_g, D_p, D_e, D_a = 3, 7, 3, 6, 5, 4, 3, 4
    lengths = np.array([7, 4, 1])
    umask = (np.arange(L)[None] < lengths[:, None]).astype(np.float32)
    U = rng.standard_normal((B, L, D_m)).astype(np.float32)
    qmask = np.eye(P, dtype=np.float32)[rng.integers(0, P, (B, L))] \
        * umask[..., None]
    jm = JDialogueRNN(D_m, D_g, D_p, D_e, listener, attention, D_a, 0.0)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), U,
                                            qmask))["params"]
    params = _uniform(rng, shapes)
    model = DialogueRNN(D_m, D_g, D_p, D_e, listener, attention, D_a, 0.0)
    model.load_state_dict(_strip(params_from_jax({"dialog_rnn_f": params}),
                                 "dialog_rnn_f."))
    R = rng.standard_normal((B, L, D_e)).astype(np.float32)
    jf = lambda u: jm.apply({"params": params}, u, qmask)[0]
    want, jgrad = _value_and_grad(jf, U, R)
    x = torch.from_numpy(U).requires_grad_()
    got = model(x, torch.from_numpy(qmask))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    (got * torch.from_numpy(R)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), jgrad,
                               atol=1e-5 * max(1.0, np.abs(jgrad).max()))


def test_bilstm_matches_jax_with_holes_in_the_mask():
    """Two bidirectional LSTM layers (gates i, f, g, o) over a mask with
    holes, where h and c hold: the outputs and the input's gradient."""
    rng = np.random.default_rng(9)
    B, L, D, H = 3, 9, 7, 5
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    mask = (rng.random((B, L)) > 0.35).astype(np.float32)
    mask[2] = 0.0
    jm = JBiRNN(H, num_layers=2, bidirectional=True, cell="lstm")
    params = _uniform(rng, jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), x, mask))["params"])
    model = BiRNN(D, H, cell="lstm")
    model.load_state_dict(_strip(params_from_jax({"lstm": params}),
                                 "lstm."))
    R = rng.standard_normal((B, L, 2 * H)).astype(np.float32)
    jf = lambda u: jm.apply({"params": params}, u, mask)
    want, jgrad = _value_and_grad(jf, x, R)
    t = torch.from_numpy(x).requires_grad_()
    got = model(t, torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    assert not got[2].detach().any()       # no valid frame: the zero state
    (got * torch.from_numpy(R)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), jgrad, atol=1e-5)


# base_model -> config fields (IEMOCAP text, D_e = D_h = 100, D_g = D_p =
# 150, the JAX Trainer's baseline construction)
BASELINES = {"GRU": dict(base_model="GRU"),
             "LSTM": dict(base_model="LSTM"),
             "DialogRNN": dict(base_model="DialogRNN"),
             "DialogRNN-listener-simple": dict(
                 base_model="DialogRNN", active_listener=True,
                 attention="simple")}
CLASSES = {"GRU": GRUModel, "LSTM": LSTMModel, "DialogRNN": DialogRNNModel}


def _jax_template(jtr, args):
    shapes = jax.eval_shape(lambda: jtr.model.init(
        jax.random.PRNGKey(0), *args, deterministic=True))["params"]
    return shapes, jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes)


def _text_batch(rng, lengths, L, D=100, P=2):
    umask = (np.arange(L)[None] < np.asarray(lengths)[:, None]).astype(
        np.float32)
    text = (rng.standard_normal((len(lengths), L, D))
            * umask[..., None]).astype(np.float32)
    qmask = np.eye(P, dtype=np.float32)[rng.integers(
        0, P, (len(lengths), L))] * umask[..., None]
    return text, qmask, umask


@pytest.mark.parametrize("case", sorted(BASELINES))
def test_baseline_models_match_jax(case):
    """Each baseline as the trainers build it: log-probs on bridged
    weights, and the weight bridge's round trip through the JAX package's
    importer."""
    kw = dict(graph_model=False, **BASELINES[case])
    cfg = ExperimentConfig(**kw)
    jtr = JTrainer(JConfig(**kw))
    rng = np.random.default_rng(len(case))
    args = _text_batch(rng, [8, 5], 8)
    shapes, template = _jax_template(jtr, args)
    params = _uniform(rng, shapes, 0.1)
    model = build_model(cfg).eval()
    assert type(model) is CLASSES[cfg.base_model]
    model.load_state_dict(params_from_jax(params))
    back = state_dict_to_params(
        {k: v.numpy() for k, v in model.state_dict().items()}, template)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                                 jax.tree_util.tree_leaves_with_path(params)):
        np.testing.assert_array_equal(a, b, jax.tree_util.keystr(path))
    want = np.asarray(fast_jit(lambda p, *a: jtr.model.apply(
        {"params": p}, *a, deterministic=True))(params, *args))
    with torch.inference_mode():
        got = model(*map(torch.from_numpy, args)).numpy()
    valid = args[2] > 0
    np.testing.assert_allclose(got[valid], want[valid], atol=1e-4)


@pytest.fixture(scope="module")
def pickle_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("iem") / "iem.pkl")
    make_synthetic_iemocap_pickle(path, n_train=7, n_test=5, min_len=3,
                                  max_len=12, seed=9)
    return path


def _bridged(kw, seed=2):
    tr = Trainer(ExperimentConfig(**kw), device="cpu")
    jtr = JTrainer(JConfig(**kw))
    # init_state's parameters, in one compile
    params = fast_jit(jtr._init_variables)(jax.random.PRNGKey(seed),
                                           jtr._example_inputs())["params"]
    tr.model.load_state_dict(params_from_jax(params))
    return tr, jtr, params


def test_three_trainer_steps_of_the_lstm_baseline_match_jax(pickle_path):
    """The LSTM baseline at dropout 0 with class weights (the weighted
    masked NLL, as the JAX trainer takes for every non-graph model) and
    Adam: three steps' losses and the first step's gradients."""
    kw = dict(graph_model=False, base_model="LSTM", dropout=0.0,
              batch_size=2, class_weight=True, buckets=(12,))
    tr, jtr, params = _bridged(kw)
    assert jtr.loss_kind == "nll"
    state = (params, fast_jit(jtr.tx.init)(params))

    @fast_jit
    def jstep(state, inputs):
        p, opt = state
        loss, grads = jax.value_and_grad(lambda q: jtr._loss(
            jtr._apply_model(q, inputs, True), inputs["label"],
            inputs["umask"]))(p)
        updates, opt = jtr.tx.update(grads, opt, p)
        return (optax.apply_updates(p, updates), opt), loss, grads

    dias = IEMOCAPDataset(pickle_path, train=True).dialogues()
    batches = list(BucketBatcher(dias, 2, 2, (12,)).epoch(0))[:3]
    jlosses, losses = [], []
    for i, b in enumerate(batches):
        state, jloss, jg = jstep(state, j_prepare_inputs(jtr.cfg, b))
        jlosses.append(float(jloss))
        loss, _ = tr.train_step(prepare_inputs(b, tr.device), seed=i)
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


def test_baselines_take_the_masked_nll_loss(pickle_path):
    """With the default ``loss='FocalLoss'`` a baseline still trains on
    the masked NLL (``mmdfn_tpu/train/trainer.py:131-132``); a graph
    model takes the focal loss."""
    kw = dict(graph_model=False, base_model="GRU", class_weight=True,
              gamma=2.0, buckets=(12,))
    tr = Trainer(ExperimentConfig(**kw), device="cpu")
    b = next(iter(BucketBatcher(
        IEMOCAPDataset(pickle_path, train=True).dialogues(), 3, 2,
        (12,)).epoch(0)))
    inputs = prepare_inputs(b, tr.device)
    loss, _ = tr.eval_step(inputs)
    with torch.no_grad():
        logp = tr._forward(inputs)
    args = (logp, inputs["label"], inputs["umask"])
    assert float(loss) == float(masked_nll_loss(*args, weight=tr.alpha))
    assert float(loss) != float(focal_loss(*args, gamma=2.0, alpha=tr.alpha))
    graph = Trainer(ExperimentConfig(**{**kw, "graph_model": True,
                                        "base_model": "LSTM",
                                        "Deep_GCN_nlayers": 1}),
                    device="cpu")
    logp = torch.log_softmax(torch.randn(*b.label.shape, 6), dim=-1)
    args = (logp, inputs["label"], inputs["umask"])
    assert float(graph._loss(*args)) == float(focal_loss(
        *args, gamma=2.0, alpha=graph.alpha))


def test_epoch_loss_weights_each_batch_by_its_utterances(pickle_path):
    """A baseline's epoch loss is the batch losses weighted by their valid
    utterances (``mmdfn_tpu/train/trainer.py:381-385``), as the JAX
    trainer's ``run_epoch`` gives on the same weights and batches; a graph
    model's stays the plain mean."""
    kw = dict(graph_model=False, base_model="GRU", batch_size=3,
              buckets=(12,))
    tr, jtr, params = _bridged(kw, seed=6)
    dias = IEMOCAPDataset(pickle_path, train=False).dialogues()
    batches = list(BucketBatcher(dias, 3, 2, (12,)).epoch(0))
    sizes = [float(b.umask.sum()) for b in batches]
    assert len(batches) == 2 and sizes[0] != sizes[1]
    got = tr.run_epoch(batches)
    state = TrainState(params=params,                    # init_state's
                       opt_state=fast_jit(jtr.tx.init)(params),
                       step=jnp.zeros((), jnp.int32))
    _, want = jtr.run_epoch(state, batches)
    assert abs(got.loss - want.loss) <= 1e-4
    per = [float(tr.eval_step(prepare_inputs(b, tr.device))[0])
           for b in batches]
    weighted = sum(l * n for l, n in zip(per, sizes)) / sum(sizes)
    assert got.loss == round(weighted, 4)
    assert round(weighted, 4) != round(sum(per) / len(per), 4)


def test_baseline_trains_tests_and_serves_through_the_cli(
        pickle_path, tmp_path, monkeypatch, capsys):
    """``--no_graph_model`` with the DialogRNN baseline (listener state,
    general attention, ``--rec_dropout``) through the training CLI for one
    epoch; ``--test_label`` on its directory; and the server answering
    from it as the restored model does."""
    save, out = str(tmp_path / "ckpts"), str(tmp_path / "out")
    flags = ["--device", "cpu", "--data_dir", pickle_path,
             "--no_graph_model", "--base_model", "DialogRNN",
             "--active_listener", "--attention", "general",
             "--rec_dropout", "0.2", "--batch-size", "4", "--buckets", "12"]
    assert run_train_erc.main([*flags, "--epochs", "1",
                               "--save_model_dir", save]) == 0
    assert "epoch: 0, train_loss: " in capsys.readouterr().out
    assert run_train_erc.main([*flags, "--test_label", "--load_model", save,
                               "--save_model_dir", out]) == 0
    assert "test_fscore:" in capsys.readouterr().out
    assert len(np.load(f"{out}/test_pred.npy")) == len(
        np.load(f"{out}/test_label.npy")) > 0
    acts = np.load(f"{out}/test_activations.npz")
    assert "dialog_rnn_f" in acts and "matchatt/1" in acts
    d = IEMOCAPDataset(pickle_path, train=False).dialogues()[0]
    utts = [(d.text[t], d.audio[t], d.visual[t], int(d.qmask[t].argmax()))
            for t in range(3)]
    monkeypatch.setattr("sys.stdin", io.StringIO("\n".join(
        json.dumps({"text": x.tolist(), "audio": a.tolist(),
                    "visual": v.tolist(), "speaker": s})
        for x, a, v, s in utts) + "\n"))
    assert serve.main(["--load_model", save, "--device", "cpu",
                       "--buckets", "4"]) == 0
    resp = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert resp[0]["ready"] and len(resp) == 4
    cfg, model, _ = load_served(save)
    assert isinstance(model, DialogRNNModel) and cfg.rec_dropout == 0.2
    session = StreamingSession(model, cfg, buckets=(4,), device="cpu")
    for (x, a, v, s), got in zip(utts, resp[1:]):
        _, logp = session.append(x, a, v, s)
        np.testing.assert_allclose(got["log_probs"], logp, atol=5e-5 + 1e-6)


@pytest.mark.parametrize("case", sorted(BASELINES))
def test_baselines_import_as_jax_does(case):
    """A reference-keyed state_dict of each baseline loads strictly into
    the port and, through the JAX importer on the same dict, gives the
    same log-probs; a DialogRNN of an attention the JAX importer does not
    map is refused."""
    kw = dict(graph_model=False, **BASELINES[case])
    cfg = ExperimentConfig(seed=3, **kw)
    source = build_model(cfg)
    jtr = JTrainer(JConfig(**kw))
    rng = np.random.default_rng(11)
    args = _text_batch(rng, [6, 3], 6)
    _, template = _jax_template(jtr, args)
    sd = {k: v.numpy().copy() for k, v in source.state_dict().items()}
    model = import_state_dict(sd, cfg).eval()
    for k, v in source.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    params = state_dict_to_params(sd, template)
    want = np.asarray(fast_jit(lambda p, *a: jtr.model.apply(
        {"params": p}, *a, deterministic=True))(params, *args))
    with torch.inference_mode():
        got = model(*map(torch.from_numpy, args)).numpy()
    valid = args[2] > 0
    np.testing.assert_allclose(got[valid], want[valid], atol=1e-4)
    with pytest.raises(KeyError, match="smax_fc.weight"):
        import_state_dict({k: v for k, v in sd.items()
                           if k != "smax_fc.weight"}, cfg)
    if cfg.base_model == "DialogRNN":
        with pytest.raises(ValueError, match="general2"):
            import_state_dict(sd, ExperimentConfig(**{
                **kw, "attention": "general2"}))
