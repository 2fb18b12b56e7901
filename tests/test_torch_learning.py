"""The port learns: ``tests/test_learning.py``'s whole run of the flagship
on the separable synthetic task, on the port's CPU plain path at the
parity defaults; the task's pickle byte for byte against the JAX
package's; and the sweep's command line with ``--vmap`` (its flags against
``mmdfn_tpu/cli/sweep.py``'s, one group trained, then skipped)."""

import argparse
import json

import pytest
import torch

from mmdfn_tpu.cli import sweep as j_sweep
from mmdfn_tpu.data.synthetic import \
    make_separable_iemocap_pickle as j_make_separable

from mmdfn_torch.cli import sweep
from mmdfn_torch.config import ExperimentConfig
from mmdfn_torch.data.datasets import IEMOCAPDataset
from mmdfn_torch.data.synthetic import (make_separable_iemocap_pickle,
                                        make_synthetic_iemocap_pickle)
from mmdfn_torch.runtime import checkpoint as ckpt_lib
from mmdfn_torch.train import Trainer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # small tensors: with several test workers on a few cores, one torch
    # thread per core makes every op wait for the others (a test of 0.7 s
    # alone took 120 s beside five other workers)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", [0, 11])
def test_separable_pickle_is_the_jax_packages(tmp_path, seed):
    a, b = tmp_path / "port.pkl", tmp_path / "jax.pkl"
    kw = dict(n_train=5, n_test=3, min_len=2, max_len=9, seed=seed)
    assert make_separable_iemocap_pickle(str(a), **kw) == \
        j_make_separable(str(b), **kw)
    assert a.read_bytes() == b.read_bytes()


def test_flagship_learns_separable_task(tmp_path):
    """IEMOCAP GDF, 16 GCNII layers with the reason-LSTM, class weights,
    focal loss, dropout 0.4, dual-patience selection, 12 epochs at B = 8:
    labels are a function of the features, so a correct pipeline reaches
    about 100 weighted F1 on both splits; a wiring, masking or dropout
    fault that shows only over a whole run stays near chance (about 17).
    About 40 s on one thread."""
    pkl = str(tmp_path / "sep.pkl")
    make_separable_iemocap_pickle(pkl, n_train=96, n_test=24, min_len=6,
                                  max_len=12, seed=11)
    train = IEMOCAPDataset(pkl, True).dialogues()
    test = IEMOCAPDataset(pkl, False).dialogues()
    cfg = ExperimentConfig(
        dataset="IEMOCAP", graph_type="GDF", reason_flag=True,
        class_weight=True, Deep_GCN_nlayers=16, speaker_weights="3-0-1",
        batch_size=8, buckets=(8,), lr=1e-3, epochs=12, patience=12)
    res = Trainer(cfg, device="cpu").fit(train, test, verbose=False)

    assert res.best_test_fscore >= 95.0, (
        f"the flagship did not learn the separable task: best test F1 "
        f"{res.best_test_fscore} — history {res.history}")
    # selection must read the test split: train F1 is high there too
    train_f_at_best = res.history[res.best_epoch]["train_fscore"]
    assert train_f_at_best >= 95.0, (
        f"train F1 at the best epoch only {train_f_at_best}: {res.history}")
    # and the task is not solved without training
    assert res.history[0]["train_fscore"] < 60.0, (
        "the task is solved before any training — not a learning test")


def _options(parser):
    return {opt: a for a in parser._actions for opt in a.option_strings}


def _jax_sweep_parser(monkeypatch):
    """``mmdfn_tpu/cli/sweep.py`` builds its parser inside ``main``: take
    it from there, before it parses anything."""
    seen = []

    def grab(self, args=None, namespace=None):
        seen.append(self)
        raise SystemExit(0)
    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(SystemExit):
            j_sweep.main([])
    return seen[0]


def test_sweep_parser_takes_every_jax_flag_with_its_default(monkeypatch):
    """Every option of the JAX sweep, with the same destination, type and
    default; the port adds ``--graph_type`` and ``--device`` only."""
    want = _options(_jax_sweep_parser(monkeypatch))
    got = _options(sweep.build_parser())
    assert set(got) == set(want) | {"--graph_type", "--device"}
    for opt, action in want.items():
        assert got[opt].dest == action.dest, opt
        assert got[opt].default == action.default, opt
        assert got[opt].type == action.type, opt
        assert got[opt].required == action.required, opt


def test_vmap_sweep_cli_trains_one_group_and_skips_it(tmp_path, capsys):
    """``--vmap --limit 2 --epochs 1`` twice on the CPU: the first run
    trains the two combinations as one group (16 layers, their layer
    count) and writes one summary row each; the second skips the finished
    group and rewrites the same rows."""
    pkl = str(tmp_path / "iem.pkl")
    make_synthetic_iemocap_pickle(pkl, n_train=4, n_test=2, min_len=3,
                                  max_len=8, seed=2)
    out = tmp_path / "sweep"
    argv = ["--vmap", "--dataset", "IEMOCAP", "--data_dir", pkl, "--limit",
            "2", "--epochs", "1", "--batch-size", "4", "--device", "cpu",
            "--out_dir", str(out)]
    assert sweep.main(argv) == 0
    first = capsys.readouterr().out
    assert "2 configs, one batched step" in first and "BEST:" in first
    summary = (out / "summary.jsonl").read_text()
    rows = [json.loads(l) for l in summary.splitlines()]
    todo = list(sweep.combos("IEMOCAP"))[:2]
    assert [r["tag"] for r in rows] == [sweep.combo_tag(c) for c in todo]
    assert all(r["best_epoch"] == 0 for r in rows)
    group = str(out / "group_Deep_GCN_nlayers16")
    meta = ckpt_lib.read_meta(group, "final")
    assert meta["best_test_fscore"] == [r["best_test_fscore"] for r in rows]
    assert sweep.main(argv) == 0
    assert "group already complete" in capsys.readouterr().out
    assert (out / "summary.jsonl").read_text() == summary
