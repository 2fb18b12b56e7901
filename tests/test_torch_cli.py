"""The port's command-line surface against the JAX package's: the training
CLI's flags and defaults, the values that select a family the port lacks,
and the sequential sweep (its grids, and a resumed run that trains each
combination once)."""

import json

import pytest
import torch

from mmdfn_tpu.cli import run_train_erc as j_run_train_erc
from mmdfn_tpu.cli import sweep as j_sweep

from mmdfn_torch.cli import run_train_erc, sweep
from mmdfn_torch.data.synthetic import make_synthetic_iemocap_pickle
from mmdfn_torch.runtime import checkpoint as ckpt_lib


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # small tensors: with several test workers on a few cores, one torch
    # thread per core makes every op wait for the others (a test of 0.7 s
    # alone took 120 s beside five other workers)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _options(parser):
    return {opt: a for a in parser._actions for opt in a.option_strings}


def test_parser_takes_every_jax_flag_with_its_default():
    """Every option string of the JAX parser but the XLA/TPU knobs, with
    the same destination and default; the port adds ``--device`` only."""
    want, got = (_options(j_run_train_erc.build_parser()),
                 _options(run_train_erc.build_parser()))
    left_out = set(run_train_erc.JAX_ONLY_FLAGS)
    assert left_out <= set(want)
    assert set(got) == (set(want) - left_out) | {"--device"}
    for opt, action in got.items():
        if opt in want:
            assert action.dest == want[opt].dest, opt
            assert action.default == want[opt].default, opt
            assert action.type == want[opt].type, opt


def test_flags_unread_on_the_gdf_path_leave_the_config_as_it_was():
    """The other families' settings and DialogRNN's reach the config under
    their JAX names and leave the GDF model as it was; the topic flag is
    not a field."""
    import dataclasses

    from mmdfn_torch.weights import build_model

    parse = lambda argv: run_train_erc.config_from_args(
        run_train_erc.build_parser().parse_args(argv))
    base = parse(["--dataset", "MELD", "--Deep_GCN_nlayers", "2"])
    assert base.dataset == "MELD" and base.Deep_GCN_nlayers == 2
    other = parse([
        "--dataset", "MELD", "--Deep_GCN_nlayers", "2", "--use_gcn",
        "--graph_construct", "full", "--no_nodal_attention", "--use_topic",
        "--active_listener", "--attention", "simple", "--rec_dropout", "0.3",
        "--windowp", "3", "--windowf", "4", "--multiheads", "2",
        "--edge_attn_type", "attn3", "--multi_modal", "--tensorboard",
        "--no_cuda"])
    family = {"use_gcn": True, "graph_construct": "full",
              "nodal_attention": False, "windowp": 3, "windowf": 4,
              "edge_attn_type": "attn3", "active_listener": True,
              "attention": "simple", "rec_dropout": 0.3}
    assert other == dataclasses.replace(base, **family)
    a, b = build_model(base).state_dict(), build_model(other).state_dict()
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert parse(["--sort_batches_by_length"]).sort_batches_by_length


# the values that select another family than the flagship's: DailyDialogue
# builds its token model and stops at the missing pickle; what the JAX
# package cannot run either (GF, GDF and GF2 on one stream, a multimodal
# GRU or DialogRNN base, one stream of three modalities) is refused by
# name; the non-graph baselines and early fusion on 'None' build their
# model and stop at the missing pickle
@pytest.mark.parametrize("argv,error,match", [
    (["--dataset", "DailyDialogue"], FileNotFoundError, "none.pkl"),
    (["--no_graph_model"], FileNotFoundError, "none.pkl"),
    (["--no_multi_modal"], ValueError, "no single stream"),
    (["--mm_fusion_mthd", "concat"], ValueError, "no single stream"),
    (["--base_model", "GRU"], ValueError, "feeds one stream"),
    (["--no_multi_modal", "--graph_type", "relation"], ValueError,
     "one modality"),
    (["--mm_fusion_mthd", "concat", "--graph_type", "GF2"], ValueError,
     "no single stream"),
    (["--base_model", "DialogRNN"], NotImplementedError,
     "single-stream only"),
    (["--no_multi_modal", "--mm_fusion_mthd", "gated"], ValueError,
     "no single stream"),
    (["--base_model", "GRU", "--graph_type", "DeepGCN"], ValueError,
     "feeds one stream"),
    (["--mm_fusion_mthd", "concat", "--graph_type", "None"],
     FileNotFoundError, "none.pkl")],
    ids=[f"argv{i}" for i in range(11)])
def test_family_selecting_values_name_the_later_slice(argv, error, match,
                                                      tmp_path):
    with pytest.raises(error, match=match):
        run_train_erc.main(["--device", "cpu", "--data_dir",
                            str(tmp_path / "none.pkl"), *argv])


@pytest.mark.parametrize("dataset", ["IEMOCAP", "MELD"])
def test_sweep_grids_match_the_jax_package(dataset):
    want = list(j_sweep.combos(dataset))
    got = list(sweep.combos(dataset))
    assert got == want and len(got) == {"IEMOCAP": 32, "MELD": 48}[dataset]
    assert [sweep.combo_tag(c) for c in got] == \
        [j_sweep.combo_tag(c) for c in want]


def test_sequential_sweep_trains_each_combination_once(tmp_path, capsys):
    """``--limit 2 --epochs 1`` twice: the first run trains both
    combinations and writes a ``final`` checkpoint each (the summary row
    as its meta); the second skips both and adds no row.  Then ``--vmap
    --n_data_devices 2`` trains them as one group over two CPU ranks."""
    pkl = str(tmp_path / "iem.pkl")
    make_synthetic_iemocap_pickle(pkl, n_train=4, n_test=2, min_len=3,
                                  max_len=8, seed=2)
    out = tmp_path / "sweep"
    argv = ["--dataset", "IEMOCAP", "--data_dir", pkl, "--limit", "2",
            "--epochs", "1", "--batch-size", "4", "--device", "cpu",
            "--out_dir", str(out)]
    assert sweep.main(argv) == 0
    first = capsys.readouterr().out
    assert first.count(": training") == 2 and "BEST:" in first
    rows = [json.loads(l) for l in
            (out / "summary.jsonl").read_text().splitlines()]
    tags = [sweep.combo_tag(c) for c in list(sweep.combos("IEMOCAP"))[:2]]
    assert [r["tag"] for r in rows] == tags
    for r in rows:
        meta = ckpt_lib.read_meta(str(out / r["tag"]), "final")
        assert meta == r
    assert sweep.main(argv) == 0
    second = capsys.readouterr().out
    assert second.count("already complete, skipping") == 2
    assert ": training" not in second
    assert len((out / "summary.jsonl").read_text().splitlines()) == 2
    # --vmap trains (tests/test_torch_learning.py); over two CPU ranks the
    # group (one combination each) writes its checkpoint and the summary
    assert sweep.main([*argv, "--vmap", "--n_data_devices", "2"]) == 0
    rows = [json.loads(l) for l in
            (out / "summary.jsonl").read_text().splitlines()]
    assert [r["tag"] for r in rows] == tags
    final = ckpt_lib.read_meta(str(out / "group_Deep_GCN_nlayers16"),
                               "final")
    assert [r["best_test_fscore"] for r in rows] == \
        final["best_test_fscore"]


@pytest.mark.parametrize("graph_type", ["GF2", "relation"])
def test_one_epoch_of_a_family_trains_and_serves(graph_type, tmp_path,
                                                 monkeypatch, capsys):
    """One epoch of the training CLI with another family than GDF; the
    server rebuilds the family from the directory's config and answers
    with the weights the restored model answers with."""
    import io

    import numpy as np

    from mmdfn_torch.cli import serve
    from mmdfn_torch.config import ExperimentConfig
    from mmdfn_torch.data.datasets import IEMOCAPDataset
    from mmdfn_torch.models import DialogueGNN
    from mmdfn_torch.serve import StreamingSession

    pkl, save = str(tmp_path / "iem.pkl"), str(tmp_path / "ckpts")
    make_synthetic_iemocap_pickle(pkl, n_train=4, n_test=2, min_len=3,
                                  max_len=8, seed=6)
    assert run_train_erc.main([
        "--device", "cpu", "--epochs", "1", "--data_dir", pkl,
        "--graph_type", graph_type, "--batch-size", "4", "--buckets", "8",
        "--edge_attn_type", "attn2", "--save_model_dir", save]) == 0
    assert "epoch: 0, train_loss: " in capsys.readouterr().out
    meta = ckpt_lib.read_meta(save)
    assert meta["config"]["graph_type"] == graph_type
    d = IEMOCAPDataset(pkl, train=False).dialogues()[0]
    utts = [(d.text[t], d.audio[t], d.visual[t], int(d.qmask[t].argmax()))
            for t in range(2)]
    lines = [json.dumps({"text": x.tolist(), "audio": a.tolist(),
                         "visual": v.tolist(), "speaker": s})
             for x, a, v, s in utts]
    monkeypatch.setattr("sys.stdin", io.StringIO("\n".join(lines) + "\n"))
    assert serve.main(["--load_model", save, "--device", "cpu",
                       "--buckets", "4"]) == 0
    out = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert out[0]["ready"] and len(out) == 3
    cfg = ExperimentConfig(**meta["config"])
    model, _ = ckpt_lib.restore_checkpoint(save, DialogueGNN.from_config(cfg))
    session = StreamingSession(model, cfg, buckets=(4,), device="cpu")
    for (x, a, v, s), got in zip(utts, out[1:]):
        _, logp = session.append(x, a, v, s)
        # the server rounds log-probs to 4 decimals
        np.testing.assert_allclose(got["log_probs"], logp, atol=5e-5 + 1e-6)


def test_sweep_runs_its_grid_on_another_family(tmp_path, capsys):
    pkl = str(tmp_path / "iem.pkl")
    make_synthetic_iemocap_pickle(pkl, n_train=4, n_test=2, min_len=3,
                                  max_len=8, seed=2)
    out = tmp_path / "sweep"
    assert sweep.main(["--dataset", "IEMOCAP", "--data_dir", pkl, "--limit",
                       "1", "--epochs", "1", "--batch-size", "4", "--device",
                       "cpu", "--graph_type", "DeepGCN", "--out_dir",
                       str(out)]) == 0
    row = json.loads((out / "summary.jsonl").read_text())
    first = list(sweep.combos("IEMOCAP"))[0]
    assert row["tag"] == "DeepGCN_" + sweep.combo_tag(first)
    assert row["graph_type"] == "DeepGCN"
    assert ckpt_lib.read_meta(str(out / row["tag"]), "final") == row
