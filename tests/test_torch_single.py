"""The single-stream path of the port against the JAX package: every
single-stream graph head on every base the JAX package pairs it with, the
early-fusion input (``mm_fusion_mthd='concat'``), ``MatchingAttention``'s
four score types, ``SimpleAttention`` and ``flip_valid``; three ``Trainer``
steps of early-fusion DeepGCN; the training CLI with ``--no_multi_modal``;
the server on a single-stream model; and the importer on a single-stream
relation checkpoint."""

import dataclasses
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
from mmdfn_tpu.models.dialogue_gnn import DialogueGNN as JDialogueGNN
from mmdfn_tpu.nn.attention import MatchingAttention as JMatchingAttention
from mmdfn_tpu.nn.attention import SimpleAttention as JSimpleAttention
from mmdfn_tpu.tools.import_torch_checkpoint import state_dict_to_params
from mmdfn_tpu.train import Trainer as JTrainer
from mmdfn_tpu.train.trainer import prepare_inputs as j_prepare_inputs
from mmdfn_tpu.utils.masking import flip_valid as j_flip_valid

from mmdfn_torch.cli import run_train_erc, serve
from mmdfn_torch.config import ExperimentConfig
from mmdfn_torch.data.batching import BucketBatcher
from mmdfn_torch.data.datasets import IEMOCAPDataset
from mmdfn_torch.data.synthetic import make_synthetic_iemocap_pickle
from mmdfn_torch.nn.attention import MatchingAttention, SimpleAttention
from mmdfn_torch.runtime import checkpoint as ckpt_lib
from mmdfn_torch.serve import StreamingSession
from mmdfn_torch.tools.import_torch_checkpoint import import_state_dict
from mmdfn_torch.train import Trainer
from mmdfn_torch.train.trainer import model_text, prepare_inputs
from mmdfn_torch.utils.masking import flip_valid
from mmdfn_torch.weights import build_model, load_served, params_from_jax


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # small tensors: with several test workers on a few cores, one torch
    # thread per core makes every op wait for the others
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


NL = 2
# XLA's CPU backend at its lowest optimisation level: the same operations,
# compiled in about two thirds of the time
fast_jit = partial(jax.jit, compiler_options=dict(
    xla_backend_optimization_level=0, xla_llvm_disable_expensive_passes=True))


def _batch(rng, D_m, lengths, L, P=2):
    B = len(lengths)
    umask = (np.arange(L)[None] < np.asarray(lengths)[:, None]).astype(
        np.float32)
    x = (rng.standard_normal((B, L, D_m)) * umask[..., None]).astype(
        np.float32)
    qmask = np.eye(P, dtype=np.float32)[rng.integers(0, P, (B, L))]
    return x, qmask * umask[..., None], umask


def _jax_params(rng, jm, args):
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), *args, deterministic=True))["params"]
    return jax.tree_util.tree_map(
        lambda s: rng.uniform(-0.1, 0.1, s.shape).astype(s.dtype), shapes)


# every single-stream head on every base (the JAX package pairs them all,
# tests/test_dialogue_gnn.py:94-110), one stream of the text; then early
# fusion (a,v,l and a,l concatenated: linear_ to 250 and 150), another
# modality alone, and the head's options
HEADS = {"relation": dict(graph_type="relation"),
         "relation-no_nodal": dict(graph_type="relation",
                                   nodal_attention=False),
         "DeepGCN": dict(graph_type="DeepGCN"),
         "GCN3": dict(graph_type="GCN3"),
         "None": dict(graph_type="None")}
CASES = {f"{h}-{b}": dict(multi_modal=False, modals="l", base_model=b, **kw)
         for h, kw in HEADS.items()
         for b in ("LSTM", "GRU", "DialogRNN", "None")}
CASES.update({
    "early-DeepGCN-reason": dict(graph_type="DeepGCN", reason_flag=True,
                                 mm_fusion_mthd="concat"),
    "early-al-relation-use_gcn": dict(graph_type="relation", modals="al",
                                      use_gcn=True, mm_fusion_mthd="concat"),
    "early-vl-GCN3-no_residue": dict(graph_type="GCN3", modals="vl",
                                     use_residue=False,
                                     mm_fusion_mthd="concat"),
    "audio-DeepGCN-no_crn-lamda": dict(graph_type="DeepGCN", modals="a",
                                       multi_modal=False,
                                       use_crn_speaker=False, lamda=0.3,
                                       alpha=0.4),
    "DialogRNN-listener-simple-relation": dict(
        graph_type="relation", base_model="DialogRNN", multi_modal=False,
        modals="l", active_listener=True, attention="simple"),
})


@pytest.mark.parametrize("case", sorted(CASES))
def test_single_stream_logprobs_match_jax(case):
    kw = dict(Deep_GCN_nlayers=NL, **CASES[case])
    cfg = ExperimentConfig(**kw)
    jm = JDialogueGNN.from_config(JConfig(**kw))
    assert not jm.multi_modal and not cfg.multi_modal_path
    rng = np.random.default_rng(len(case))
    args = _batch(rng, cfg.D_m, [8, 5], 8)
    params = _jax_params(rng, jm, args)
    model = build_model(cfg).eval()
    sd = params_from_jax(params)
    assert sd.keys() == model.state_dict().keys()
    model.load_state_dict(sd)
    want = np.asarray(fast_jit(lambda p, *a: jm.apply(
        {"params": p}, *a, deterministic=True))(params, *args))
    with torch.inference_mode():
        got = model(*map(torch.from_numpy, args)).numpy()
    valid = args[2] > 0
    # f32 on both sides; summation order only
    np.testing.assert_allclose(got[valid], want[valid], atol=1e-4)


@pytest.mark.parametrize("kw,error,match", [
    (dict(graph_type="GDF", mm_fusion_mthd="concat"), ValueError,
     "no single stream"),
    (dict(graph_type="GF2", multi_modal=False, modals="l"), ValueError,
     "no single stream"),
    (dict(graph_type="DeepGCN", base_model="DialogRNN"),
     NotImplementedError, "single-stream only"),
    (dict(graph_type="None", base_model="GRU"), ValueError,
     "feeds one stream"),
    (dict(graph_type="relation", multi_modal=False), ValueError,
     "one modality"),
    (dict(graph_type="None", mm_fusion_mthd="concat", modals="l"),
     ValueError, "'concat' with modals 'l'")],
    ids=["GDF-concat", "GF2-single", "DialogRNN-multimodal",
         "GRU-multimodal", "single-avl", "concat-l"])
def test_combinations_without_a_single_stream_are_refused(kw, error, match):
    """What the JAX package cannot run either (GF, GDF and GF2 read the
    modality dict; a multimodal DialogRNN or GRU base leaves it empty; one
    stream reads one modality) is refused by name."""
    with pytest.raises(error, match=match):
        build_model(ExperimentConfig(Deep_GCN_nlayers=NL, **kw))


@pytest.mark.parametrize("att_type", ["dot", "general", "general2",
                                      "concat"])
def test_matching_attention_matches_jax(att_type):
    """Every candidate at once over a masked memory, and one candidate."""
    rng = np.random.default_rng(3)
    B, L, T, D = 3, 7, 5, 6
    M = rng.standard_normal((B, L, D)).astype(np.float32)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    mask = (np.arange(L)[None] < np.array([[7], [4], [1]])).astype(
        np.float32)
    jatt = JMatchingAttention(D, D, alpha_dim=4, att_type=att_type)
    shapes = jax.eval_shape(lambda: jatt.init(jax.random.PRNGKey(0), M, x,
                                              mask))
    params = jax.tree_util.tree_map(lambda s: rng.uniform(
        -0.5, 0.5, s.shape).astype(s.dtype), shapes)
    att = MatchingAttention(D, D, 4, att_type)
    p = params.get("params", {})
    with torch.no_grad():
        for name in ("transform", "vector_prod"):
            if name in p:
                getattr(att, name).weight.copy_(torch.from_numpy(
                    np.asarray(p[name]["kernel"]).T))
                if "bias" in p[name]:
                    getattr(att, name).bias.copy_(torch.from_numpy(
                        np.asarray(p[name]["bias"])))
    for cand in (x, x[:, 0]):
        want = fast_jit(jatt.apply)(params, M, cand, mask)
        got = att(torch.from_numpy(M), torch.from_numpy(cand),
                  torch.from_numpy(mask))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                       atol=1e-5)


def test_simple_attention_and_flip_valid_match_jax():
    rng = np.random.default_rng(5)
    B, L, D = 3, 6, 4
    M = rng.standard_normal((B, L, D)).astype(np.float32)
    mask = (np.arange(L)[None] < np.array([[6], [3], [0]])).astype(
        np.float32)
    jatt = JSimpleAttention()
    params = fast_jit(jatt.init)(jax.random.PRNGKey(1), M)
    att = SimpleAttention(D)
    with torch.no_grad():
        att.scalar.weight.copy_(torch.from_numpy(
            np.asarray(params["params"]["scalar"]["kernel"]).T))
    for m in (None, mask):
        want = fast_jit(jatt.apply)(params, M, m)
        got = att(torch.from_numpy(M),
                  None if m is None else torch.from_numpy(m))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                       atol=1e-6)
    # flip_valid on floats of three ranks and on integers: pads stay put
    for x in (M, M[..., 0], rng.standard_normal((B, L, 2, 3)).astype(
            np.float32), rng.integers(0, 9, (B, L))):
        want = np.asarray(fast_jit(j_flip_valid)(jnp.asarray(x),
                                                 jnp.asarray(mask)))
        got = flip_valid(torch.from_numpy(x), torch.from_numpy(mask))
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[2].numpy(), x[2])


@pytest.fixture(scope="module")
def pickle_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("iem") / "iem.pkl")
    make_synthetic_iemocap_pickle(path, n_train=7, n_test=3, min_len=3,
                                  max_len=12, seed=8)
    return path


def test_three_trainer_steps_of_early_fusion_deepgcn_match_jax(pickle_path):
    """Early-fusion DeepGCN (a,v,l concatenated, 2024 wide; the LSTM base
    with the CRN; the reason-LSTM) at dropout 0, class weights, focal loss,
    Adam: the JAX ``Trainer``'s weights bridged into the port, three steps'
    losses and the first step's gradients.  The JAX importer has no
    single-stream GCNII family, so the gradients are compared through the
    bridge on the JAX side."""
    kw = dict(dataset="IEMOCAP", graph_type="DeepGCN", reason_flag=True,
              mm_fusion_mthd="concat", Deep_GCN_nlayers=NL, dropout=0.0,
              batch_size=2, class_weight=True, buckets=(12,))
    tr = Trainer(ExperimentConfig(**kw), device="cpu")
    jtr = JTrainer(JConfig(**kw))
    assert jtr.loss_kind == "focal"
    # init_state's parameters, in one compile
    params = fast_jit(jtr._init_variables)(jax.random.PRNGKey(4),
                                           jtr._example_inputs())["params"]
    tr.model.load_state_dict(params_from_jax(params))
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
    jlosses, losses = [], []
    for i, b in enumerate(batches):
        jin = j_prepare_inputs(jtr.cfg, b)
        inputs = prepare_inputs(b, tr.device)
        assert model_text(tr.cfg, inputs).shape[-1] == 2024
        np.testing.assert_array_equal(model_text(tr.cfg, inputs).numpy(),
                                      np.asarray(jin["text"]))
        state, jloss, jg = jstep(state, jin, jax.random.PRNGKey(i))
        jlosses.append(float(jloss))
        loss, _ = tr.train_step(inputs, seed=i)
        losses.append(float(loss))
        if i == 0:
            want = params_from_jax(jg)
            grads = {k: p.grad.clone() for k, p in
                     tr.model.named_parameters()}
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert want.keys() == grads.keys()
    for k, w in want.items():
        scale = max(float(w.abs().max()), 1e-12)
        err = float((grads[k] - w).abs().max())
        assert err <= 1e-4 * scale, (k, err, scale)


def test_single_stream_trains_and_serves_through_the_cli(
        pickle_path, tmp_path, monkeypatch, capsys):
    """One epoch of ``--no_multi_modal --modals l`` (relation on the GRU
    base) through the training CLI; the server answers from its directory
    as the restored model does, and refuses an early-fusion model by
    name."""
    save = str(tmp_path / "ckpts")
    assert run_train_erc.main([
        "--device", "cpu", "--epochs", "1", "--data_dir", pickle_path,
        "--no_multi_modal", "--modals", "l", "--base_model", "GRU",
        "--graph_type", "relation", "--batch-size", "4", "--buckets", "12",
        "--save_model_dir", save]) == 0
    assert "epoch: 0, train_loss: " in capsys.readouterr().out
    d = IEMOCAPDataset(pickle_path, train=False).dialogues()[0]
    utts = [(d.text[t], d.audio[t], d.visual[t], int(d.qmask[t].argmax()))
            for t in range(3)]
    monkeypatch.setattr("sys.stdin", io.StringIO("\n".join(
        json.dumps({"text": x.tolist(), "audio": a.tolist(),
                    "visual": v.tolist(), "speaker": s})
        for x, a, v, s in utts) + "\n"))
    assert serve.main(["--load_model", save, "--device", "cpu",
                       "--buckets", "4"]) == 0
    out = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert out[0]["ready"] and len(out) == 4
    cfg, model, _ = load_served(save)
    assert cfg.base_model == "GRU" and not cfg.multi_modal
    session = StreamingSession(model, cfg, buckets=(4,), device="cpu")
    for (x, a, v, s), got in zip(utts, out[1:]):
        _, logp = session.append(x, a, v, s)
        np.testing.assert_allclose(got["log_probs"], logp, atol=5e-5 + 1e-6)

    early = ExperimentConfig(graph_type="DeepGCN", mm_fusion_mthd="concat",
                             Deep_GCN_nlayers=NL)
    ckpt_lib.save_checkpoint(str(tmp_path / "early"), build_model(early),
                             meta={"epoch": 0,
                                   "config": dataclasses.asdict(early)})
    assert serve.main(["--load_model", str(tmp_path / "early"), "--device",
                       "cpu"]) == 1
    assert "concatenation of modals a,v,l" in capsys.readouterr().err


@pytest.mark.parametrize("kw", [
    dict(multi_modal=False, modals="l"),
    dict(mm_fusion_mthd="concat", nodal_attention=False, use_gcn=True)],
    ids=["text", "early-no_nodal-use_gcn"])
def test_single_stream_relation_imports_as_jax_does(kw):
    """A reference-keyed single-stream relation state_dict (the family the
    JAX importer calls ``relation_single``) with its dead keys loads
    strictly into the port and, through the JAX importer on the same
    dict, gives the same log-probs; the single-stream families the JAX
    importer lacks are refused."""
    from mmdfn_tpu.tools.import_torch_checkpoint import (_dead_prefixes,
                                                         _detect_family)

    rng = np.random.default_rng(6)
    kw = dict(graph_type="relation", **kw)
    cfg = ExperimentConfig(seed=5, **kw)
    source = build_model(cfg)
    jm = JDialogueGNN.from_config(JConfig(**kw))
    args = _batch(rng, cfg.D_m, [6, 4], 6)
    template = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype),
        jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args,
                                       deterministic=True))["params"])
    assert _detect_family(template) == "relation_single"
    sd = {k: v.numpy().copy() for k, v in source.state_dict().items()}
    for prefix in _dead_prefixes("relation_single", template):
        sd[prefix + "weight"] = rng.standard_normal((3, 5)).astype(
            np.float32)
    model = import_state_dict(sd, cfg).eval()
    for k, v in source.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    params = state_dict_to_params(sd, template)
    want = np.asarray(fast_jit(lambda p, *a: jm.apply(
        {"params": p}, *a, deterministic=True))(params, *args))
    with torch.inference_mode():
        got = model(*map(torch.from_numpy, args)).numpy()
    valid = args[2] > 0
    np.testing.assert_allclose(got[valid], want[valid], atol=1e-4)
    for other in (dict(graph_type="DeepGCN"), dict(base_model="GRU"),
                  dict(edge_attn_type="attn2")):
        with pytest.raises(ValueError, match="single-stream"):
            import_state_dict(sd, ExperimentConfig(**{**kw, **other}))
