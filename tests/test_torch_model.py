"""The port's serve path as a whole against the JAX package: the flagship
model's log-probs on bridged weights, the weight bridge round trip, and
streaming prefix-exactness; plus the port's checkpoint, CLI and bench."""

import io
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmdfn_tpu.config import ExperimentConfig as JConfig
from mmdfn_tpu.models.dialogue_gnn import DialogueGNN as JDialogueGNN
from mmdfn_tpu.tools.import_torch_checkpoint import state_dict_to_params

from mmdfn_torch.config import ExperimentConfig
from mmdfn_torch.data.batching import bucket_length
from mmdfn_torch.models import DialogueGNN
from mmdfn_torch.serve import StreamingSession
from mmdfn_torch.weights import (build_model, load_model, params_from_jax,
                                 save_model)


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
BUCKETS = (8,)


def _batch(rng, B, L, lengths):
    umask = (np.arange(L)[None] < np.asarray(lengths)[:, None]).astype(
        np.float32)
    feats = [(rng.standard_normal((B, L, D)) * umask[..., None]).astype(
        np.float32) for D in (100, 1582, 342)]
    qmask = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (B, L))]
    return feats, qmask * umask[..., None], umask


@pytest.fixture(scope="module")
def models():
    """The JAX flagship (IEMOCAP GDF + reason, 2 layers) and the port on
    its weights, plus one jitted JAX forward shared by the tests."""
    jcfg = JConfig(dataset="IEMOCAP", graph_type="GDF", reason_flag=True,
                   Deep_GCN_nlayers=NL)
    jm = JDialogueGNN.from_config(jcfg)
    rng = np.random.default_rng(0)
    (text, audio, visual), qmask, umask = _batch(rng, 2, 8, [8, 5])
    params = jm.init(jax.random.PRNGKey(7), text, qmask, umask, audio,
                     visual, deterministic=True)["params"]
    params = jax.tree_util.tree_map(np.array, params)
    cfg = ExperimentConfig(dataset="IEMOCAP", graph_type="GDF",
                           reason_flag=True, Deep_GCN_nlayers=NL)
    pm = DialogueGNN.from_config(cfg)
    pm.load_state_dict(params_from_jax(params))
    pm.eval()
    fwd = jax.jit(lambda p, *a: jm.apply({"params": p}, *a,
                                         deterministic=True))
    return cfg, params, pm, fwd


def _port(pm, text, qmask, umask, audio, visual):
    T = torch.from_numpy
    with torch.inference_mode():
        return pm(T(text), T(qmask), T(umask), T(audio), T(visual)).numpy()


def test_dialogue_gnn_logprobs_match_jax(models):
    cfg, params, pm, fwd = models
    rng = np.random.default_rng(1)
    (text, audio, visual), qmask, umask = _batch(rng, 2, 8, [8, 5])
    want = np.asarray(fwd(params, text, qmask, umask, audio, visual))
    got = _port(pm, text, qmask, umask, audio, visual)
    valid = umask > 0
    # encoders, adjacency cosines and the GCNII stack all in f32 on both
    # sides; the error is summation order through ~10 chained products
    np.testing.assert_allclose(got[valid], want[valid], atol=1e-4)


def test_weight_bridge_round_trips(models):
    cfg, params, pm, fwd = models
    back = state_dict_to_params(
        {k: v.numpy() for k, v in pm.state_dict().items()}, params)
    flat_a = jax.tree_util.tree_leaves_with_path(back)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(params))
    assert len(flat_a) == len(flat_b)
    for path, v in flat_a:
        np.testing.assert_array_equal(v, flat_b[path])


def test_streaming_matches_offline_prefix(models):
    """Prediction at step t == the port's and the JAX offline forward on
    the length-(t+1) prefix padded to the same bucket."""
    cfg, params, pm, fwd = models
    rng = np.random.default_rng(2)
    (text, audio, visual), qmask, _ = _batch(rng, 1, 7, [7])
    session = StreamingSession(pm, cfg, buckets=BUCKETS, device="cpu")
    for t in range(7):
        spk = int(np.argmax(qmask[0, t]))
        pred, logp = session.append(text[0, t], audio[0, t], visual[0, t], spk)
        L = bucket_length(t + 1, BUCKETS)
        um = (np.arange(L) <= t).astype(np.float32)[None]
        pre = [np.pad(a[:, :t + 1], ((0, 0), (0, L - t - 1), (0, 0)))
               for a in (text, qmask, audio, visual)]
        offline = _port(pm, pre[0], pre[1], um, pre[2], pre[3])[0, t]
        np.testing.assert_allclose(logp, offline, atol=1e-6)
        jax_offline = np.asarray(fwd(params, pre[0], pre[1], um, pre[2],
                                     pre[3]))[0, t]
        np.testing.assert_allclose(logp, jax_offline, atol=1e-4)
        assert pred == int(np.argmax(offline))


def test_streaming_checks_input_and_resets(models):
    cfg, params, pm, fwd = models
    session = StreamingSession(pm, cfg, buckets=(2,), device="cpu")
    z = [np.zeros(d, np.float32) for d in (100, 1582, 342)]
    with pytest.raises(ValueError):
        session.append(*z, 2)                       # speaker out of range
    with pytest.raises(ValueError):
        session.append(z[0][:5], z[1], z[2], 0)     # wrong feature width
    session.append(*z, 0)
    session.append(*z, 1)
    with pytest.raises(ValueError):
        session.append(*z, 0)                       # past the largest bucket
    session.reset()
    assert session.t == 0
    pred, logp = session.append(*z, 0)
    assert 0 <= pred < 6 and logp.shape == (6,)


def test_port_checkpoint_round_trips(tmp_path, models):
    cfg, params, pm, fwd = models
    path = str(tmp_path / "model.pt")
    save_model(path, cfg, pm)
    cfg2, sd = load_model(path)
    assert cfg2 == cfg
    m2 = build_model(cfg2, sd)
    for k, v in pm.state_dict().items():
        assert torch.equal(v, m2.state_dict()[k])
    fresh = [build_model(cfg).state_dict() for _ in range(2)]
    for k in fresh[0]:                              # same seed, same weights
        assert torch.equal(fresh[0][k], fresh[1][k])


def test_serve_cli_answers_jsonl(tmp_path, monkeypatch, capsys, models):
    from mmdfn_torch.cli import serve

    cfg, params, pm, fwd = models
    path = str(tmp_path / "model.pt")
    save_model(path, cfg, pm)
    utt = {"text": [0.1] * 100, "audio": [0.0] * 1582,
           "visual": [0.2] * 342, "speaker": 1}
    lines = [json.dumps(utt), "not json", json.dumps({"reset": True}),
             json.dumps(utt)]
    monkeypatch.setattr("sys.stdin", io.StringIO("\n".join(lines) + "\n"))
    assert serve.main(["--load_model", path, "--device", "cpu",
                       "--buckets", "4"]) == 0
    out = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert out[0]["ready"] and out[0]["device"] == "cpu"
    assert out[1]["label"] in cfg.info["target_names"]
    assert "error" in out[2] and out[3] == {"reset": True}
    assert out[4]["log_probs"] == out[1]["log_probs"]


def test_latency_bench_on_cpu():
    from mmdfn_torch.serve import latency_bench

    cfg = ExperimentConfig(graph_type="GDF", reason_flag=True,
                           Deep_GCN_nlayers=NL)
    stats = latency_bench.run(cfg=cfg, n_dialogues=2, min_len=3, max_len=5,
                              buckets=(8,), seed=1, device="cpu")
    assert stats["n"] > 0 and stats["p99_ms"] >= stats["p50_ms"] > 0
    assert stats["platform"] == "cpu" and "device_ms_by_bucket" not in stats
