"""The port's reference-checkpoint importer: a reference-keyed GDF
state_dict, dead keys included, loads strictly into the port's model and
gives the forward that the JAX package's importer gives on the same dict;
stray and missing keys are refused by name; the CLI writes a directory the
server and ``--test_label`` read."""

import io
import json
from functools import partial

import numpy as np
import pytest
import torch

import jax

from mmdfn_tpu.config import ExperimentConfig as JConfig
from mmdfn_tpu.models.dialogue_gnn import DialogueGNN as JDialogueGNN
from mmdfn_tpu.tools.import_torch_checkpoint import state_dict_to_params

from mmdfn_torch.config import ExperimentConfig
from mmdfn_torch.runtime import checkpoint as ckpt_lib
from mmdfn_torch.tools.import_torch_checkpoint import (
    GDF_DEAD, REASON_LSTM, import_reference_checkpoint, import_state_dict,
    main)
from mmdfn_torch.weights import build_model


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


NL = 2
SW = {"IEMOCAP": "3-0-1", "MELD": "0.5-0.5-1.5"}
DIMS = {"IEMOCAP": (100, 1582, 342, 2), "MELD": (600, 300, 342, 9)}


def _cfg(dataset, **kw):
    return dict(dataset=dataset, graph_type="GDF", reason_flag=True,
                Deep_GCN_nlayers=NL, speaker_weights=SW[dataset], **kw)


def _reference_sd(model, rng):
    """The model's weights under the reference's keys, plus a tensor under
    every prefix the reference allocates on the GDF path and never runs."""
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    for prefix in GDF_DEAD:
        sd[prefix + "weight"] = rng.standard_normal((3, 5)).astype(
            np.float32)
    return sd


def _inputs(rng, dataset, lengths, L):
    D_t, D_a, D_v, P = DIMS[dataset]
    B = len(lengths)
    umask = (np.arange(L)[None] < np.asarray(lengths)[:, None]).astype(
        np.float32)
    feats = [(rng.standard_normal((B, L, D)) * umask[..., None]).astype(
        np.float32) for D in (D_t, D_a, D_v)]
    qmask = np.eye(P, dtype=np.float32)[rng.integers(0, P, (B, L))]
    return feats, qmask * umask[..., None], umask


@pytest.mark.parametrize("dataset", ["IEMOCAP", "MELD"])
def test_reference_state_dict_imports_strictly_and_as_jax_does(dataset):
    rng = np.random.default_rng(1)
    cfg = ExperimentConfig(**_cfg(dataset, seed=5))
    source = build_model(cfg)
    sd = _reference_sd(source, rng)
    model = import_state_dict(sd, cfg)
    for k, v in source.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k

    # the JAX package's importer on the same dict, dead keys and all
    jm = JDialogueGNN.from_config(JConfig(**_cfg(dataset)))
    (text, audio, visual), qmask, umask = _inputs(rng, dataset, [8, 5], 8)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), text, qmask, umask, audio, visual,
        deterministic=True))["params"]
    template = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes)
    params = state_dict_to_params(sd, template)
    want = np.asarray(fast_jit(lambda p, *a: jm.apply(
        {"params": p}, *a, deterministic=True))(
            params, text, qmask, umask, audio, visual))
    T = torch.from_numpy
    with torch.inference_mode():
        got = model(T(text), T(qmask), T(umask), T(audio), T(visual)).numpy()
    valid = umask > 0
    np.testing.assert_allclose(got[valid], want[valid], atol=1e-4)

    stray = dict(sd, **{"graph_model.graph_net.fcs.1.weight":
                        np.zeros((4, 4), np.float32)})
    with pytest.raises(KeyError, match=r"graph_model\.graph_net\.fcs\.1"):
        import_state_dict(stray, cfg)
    missing = {k: v for k, v in sd.items()
               if k != "rnn_parties.bias_hh_l1_reverse"}
    with pytest.raises(KeyError, match="rnn_parties.bias_hh_l1_reverse"):
        import_state_dict(missing, cfg)
    wrong = dict(sd, **{"smax_fc.bias": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="smax_fc.bias"):
        import_state_dict(wrong, cfg)


def test_reason_lstm_is_dead_without_the_reason_flag():
    """GF allocates the reason-LSTM in the reference and never runs it: its
    keys are dropped, as the JAX importer drops them."""
    cfg = ExperimentConfig(**dict(_cfg("MELD"), graph_type="GF"))
    with_lstm = build_model(ExperimentConfig(**_cfg("MELD")))
    sd = {k: v for k, v in with_lstm.state_dict().items()}
    assert any(k.startswith(REASON_LSTM) for k in sd)
    model = import_state_dict(sd, cfg)
    assert not any(k.startswith(REASON_LSTM) for k in model.state_dict())
    # another family's model has no place for the GDF stack's keys
    for family in ("GF2", "relation", "DeepGCN"):
        with pytest.raises(KeyError, match="graph_model.graph_net"):
            import_state_dict(sd, ExperimentConfig(
                **dict(_cfg("MELD"), graph_type=family)))


def test_import_cli_writes_a_directory_the_port_serves(tmp_path, monkeypatch,
                                                       capsys):
    """A whole-module pickle of a MELD model through the importer's CLI; the
    server loads the directory it wrote and answers with its weights."""
    from mmdfn_torch.cli import serve

    cfg = ExperimentConfig(**_cfg("MELD", seed=9))
    source = build_model(cfg)
    pkl = str(tmp_path / "reference_model.pkl")
    torch.save(source, pkl)
    out = str(tmp_path / "imported")
    assert main(["--load_model", pkl, "--out", out, "--dataset", "MELD",
                 "--Deep_GCN_nlayers", str(NL), "--speaker_weights",
                 SW["MELD"]]) == 0
    assert json.loads(capsys.readouterr().out)["imported"] == pkl
    meta = ckpt_lib.read_meta(out)
    assert meta["config"]["Deep_GCN_nlayers"] == NL
    model = import_reference_checkpoint(pkl, cfg)
    for k, v in source.state_dict().items():
        assert torch.equal(model.state_dict()[k], v)

    rng = np.random.default_rng(2)
    utt = {"text": rng.standard_normal(600).tolist(),
           "audio": rng.standard_normal(300).tolist(),
           "visual": rng.standard_normal(342).tolist(), "speaker": 8}
    monkeypatch.setattr("sys.stdin", io.StringIO(json.dumps(utt) + "\n"))
    assert serve.main(["--load_model", out, "--device", "cpu",
                       "--buckets", "4"]) == 0
    resp = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert resp[0]["ready"] and len(resp[1]["log_probs"]) == 7
    # a GDF checkpoint given as a baseline's: its keys have no place
    with pytest.raises(KeyError, match="LSTM baseline model has no place"):
        main(["--load_model", pkl, "--out", out, "--no_graph_model"])


@pytest.mark.parametrize("kw", [
    dict(graph_type="GF2"), dict(graph_type="DeepGCN"),
    dict(graph_type="GCN3", mm_fusion_mthd="gated"),
    dict(graph_type="relation", use_gcn=True, av_using_lstm=True),
    dict(graph_type="None", mm_fusion_mthd="mfn")],
    ids=["GF2", "DeepGCN", "GCN3-gated", "relation-use_gcn-av_lstm",
         "None-mfn"])
def test_every_family_imports_strictly_with_its_dead_keys(kw):
    """A reference-keyed state_dict of each family, with a tensor under
    every prefix that the JAX package's importer counts dead for it, loads
    strictly into the port's model; the JAX importer takes the same dict,
    so the two drop the same keys."""
    from mmdfn_tpu.tools.import_torch_checkpoint import (_dead_prefixes,
                                                         _detect_family)

    rng = np.random.default_rng(4)
    jcfg = JConfig(dataset="IEMOCAP", Deep_GCN_nlayers=NL, **kw)
    cfg = ExperimentConfig(dataset="IEMOCAP", Deep_GCN_nlayers=NL, seed=3,
                           **kw)
    source = build_model(cfg)
    jm = JDialogueGNN.from_config(jcfg)
    (text, audio, visual), qmask, umask = _inputs(rng, "IEMOCAP", [6, 4], 6)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), text, qmask, umask, audio, visual,
        deterministic=True))["params"]
    template = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes)
    dead = _dead_prefixes(_detect_family(template), template)
    assert dead
    sd = {k: v.numpy().copy() for k, v in source.state_dict().items()}
    for prefix in dead:
        sd[prefix + "weight"] = rng.standard_normal((3, 5)).astype(
            np.float32)
    model = import_state_dict(sd, cfg)
    for k, v in source.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    state_dict_to_params(sd, template)      # no stray key on its side
    with pytest.raises(KeyError, match="smax_fc.weight"):
        import_state_dict({k: v for k, v in sd.items()
                           if k != "smax_fc.weight"}, cfg)
