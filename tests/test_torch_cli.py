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
    """Every option string of the JAX parser but the XLA/TPU knobs and the
    DailyDialogue word flags, with the same destination and default; the
    port adds ``--device`` only."""
    want, got = (_options(j_run_train_erc.build_parser()),
                 _options(run_train_erc.build_parser()))
    left_out = set(run_train_erc.JAX_ONLY_FLAGS) | set(
        run_train_erc.LATER_FLAGS)
    assert left_out <= set(want)
    assert set(got) == (set(want) - left_out) | {"--device"}
    for opt, action in got.items():
        if opt in want:
            assert action.dest == want[opt].dest, opt
            assert action.default == want[opt].default, opt
            assert action.type == want[opt].type, opt


def test_flags_unread_on_the_gdf_path_leave_the_config_as_it_was():
    parse = lambda argv: run_train_erc.config_from_args(
        run_train_erc.build_parser().parse_args(argv))
    base = parse(["--dataset", "MELD", "--Deep_GCN_nlayers", "64"])
    assert base.dataset == "MELD" and base.Deep_GCN_nlayers == 64
    assert parse([
        "--dataset", "MELD", "--Deep_GCN_nlayers", "64", "--use_gcn",
        "--graph_construct", "full", "--no_nodal_attention", "--use_topic",
        "--active_listener", "--attention", "simple", "--rec_dropout", "0.3",
        "--windowp", "3", "--windowf", "4", "--multiheads", "2",
        "--multi_modal", "--tensorboard", "--no_cuda"]) == base
    assert parse(["--sort_batches_by_length"]).sort_batches_by_length


@pytest.mark.parametrize("argv", [
    ["--dataset", "DailyDialogue"], ["--no_graph_model"],
    ["--no_multi_modal"], ["--av_using_lstm"],
    ["--edge_attn_type", "attn2"], ["--graph_type", "relation"],
    ["--graph_type", "GF2"], ["--base_model", "DialogRNN"],
    ["--mm_fusion_mthd", "gated"], ["--use_speaker"], ["--use_modal"]])
def test_family_selecting_values_name_the_later_slice(argv, tmp_path):
    with pytest.raises(NotImplementedError, match="later slice"):
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
    as its meta); the second skips both and adds no row."""
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
    with pytest.raises(NotImplementedError, match="later slice"):
        sweep.main([*argv, "--vmap"])
