"""The port's grouped sweep (``mmdfn_torch/train/vmap_sweep.py``) against
the JAX package's ``VmapSweep``: the partition of a grid into groups, the
refusals, a group sharded over two CPU ranks (held against the
one-process group in ``tests/test_torch_parallel.py``), a config in a
group against the same config trained alone
(bit for bit, dropout on too), resume, and one whole group run against
JAX's on bridged weights, epoch by epoch."""

import dataclasses

import pytest
import torch

from mmdfn_tpu.cli import sweep as j_sweep
from mmdfn_tpu.config import ExperimentConfig as JConfig
from mmdfn_tpu.train.vmap_sweep import VmapSweep as JVmapSweep
from mmdfn_tpu.train.vmap_sweep import group_combos as j_group_combos

from mmdfn_torch.cli import sweep
from mmdfn_torch.config import ExperimentConfig
from mmdfn_torch.data.datasets import IEMOCAPDataset
from mmdfn_torch.data.synthetic import make_synthetic_iemocap_pickle
from mmdfn_torch.parallel import workers
from mmdfn_torch.runtime import launch
from mmdfn_torch.train import Trainer
from mmdfn_torch.train.vmap_sweep import VmapSweep, group_combos
from mmdfn_torch.weights import build_model, params_from_jax


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # small tensors: with several test workers on a few cores, one torch
    # thread per core makes every op wait for the others (a test of 0.7 s
    # alone took 120 s beside five other workers)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """``tests/test_vmap_sweep.py``'s fixture."""
    path = str(tmp_path_factory.mktemp("d") / "iem.pkl")
    make_synthetic_iemocap_pickle(path, n_train=8, n_test=4, min_len=4,
                                  max_len=10, seed=7)
    return (path, IEMOCAPDataset(path, True).dialogues(),
            IEMOCAPDataset(path, False).dialogues())


BASE = dict(epochs=2, batch_size=4, Deep_GCN_nlayers=2, graph_type="GDF",
            reason_flag=True, class_weight=True, buckets=(16,), dropout=0.0,
            seed=2021)


def base_cfg(**over):
    return ExperimentConfig(**{**BASE, **over})


def _group(cfg, combos, **kw):
    return VmapSweep(cfg, combos, device="cpu", **kw)


EXAMPLE = [dict(Deep_GCN_nlayers=n, dropout=d, lr=lr, l2=1e-4, gamma=0.5)
           for n in (16, 32) for d in (0.2, 0.4) for lr in (1e-4, 3e-4)]


@pytest.mark.parametrize("grid,sizes", [
    ("example", [4, 4]), ("IEMOCAP", [16, 16]), ("MELD", [16, 16, 16])])
def test_group_combos_partitions_as_jax(grid, sizes):
    """Only the layer count splits a grid: the 8-combo example into 2
    groups of 4, IEMOCAP's 32 into 2 x 16, MELD's 48 into 3 x 16, as
    ``tests/test_vmap_sweep.py`` has it for JAX."""
    combos = EXAMPLE if grid == "example" else list(sweep.combos(grid))
    if grid != "example":
        assert combos == list(j_sweep.combos(grid))
    got, want = group_combos(combos), j_group_combos(combos)
    assert got == want
    assert [len(g) for _, g in got] == sizes
    assert all(set(s) == {"Deep_GCN_nlayers"} for s, _ in got)


def _refusal(make):
    with pytest.raises(ValueError) as err:
        make()
    return str(err.value)


GRU = dict(graph_model=False, base_model="GRU", reason_flag=False)


@pytest.mark.parametrize("over,combos,match", [
    ({}, [dict(lr=1e-4, l2=1e-4, alpha=0.1), dict(lr=1e-4, l2=1e-4,
                                                  alpha=0.3)], "alpha"),
    ({}, [dict(lr=1e-4, l2=1e-4), dict(lr=3e-4)], "'l2'"),
    (GRU, [dict(lr=1e-4, l2=1e-4, dropout=0.2),
           dict(lr=1e-4, l2=1e-4, dropout=0.4)], "dropout")],
    ids=["non-stackable", "missing-l2", "gru-dropout"])
def test_refusals_match_jax(over, combos, match):
    """A key outside lr/l2/gamma(/dropout) that varies, lr or l2 missing
    from some combo, a varying dropout on a non-graph baseline: refused
    with JAX's message."""
    got = _refusal(lambda: _group(base_cfg(**over), combos))
    want = _refusal(lambda: JVmapSweep(JConfig(**{**BASE, **over}), combos))
    assert match in got and got == want


def test_identical_keys_fold_into_the_shared_config(data):
    sweep_ = _group(base_cfg(), [dict(lr=1e-4, l2=1e-4, alpha=0.3),
                                 dict(lr=3e-4, l2=1e-4, alpha=0.3)])
    assert sweep_.cfg.alpha == 0.3
    assert [tr.cfg.lr for tr in sweep_.trainers] == [1e-4, 3e-4]
    # an identical dropout on a baseline folds, and no rate is stacked
    gru = _group(base_cfg(dropout=0.5, **GRU),
                 [dict(lr=1e-4, l2=1e-4, dropout=0.2),
                  dict(lr=3e-4, l2=1e-4, dropout=0.2)])
    assert gru.cfg.dropout == 0.2 and gru.droprate is None
    assert all(tr.cfg.dropout == 0.2 for tr in gru.trainers)
    # gamma is optional (the base config's), lr and l2 are each config's
    g = _group(base_cfg(), [dict(lr=1e-4, l2=1e-4, gamma=1.0),
                            dict(lr=3e-4, l2=2e-4)])
    assert [tr.cfg.gamma for tr in g.trainers] == [1.0, 0.5]
    assert [tr.optimizer.defaults["weight_decay"] for tr in g.trainers] == \
        [1e-4, 2e-4]
    # sharded over 2 data ranks (one config each), the group runs and
    # every rank returns the whole group's result
    _, train, test = data
    combos = [dict(lr=1e-4, l2=1e-4), dict(lr=3e-4, l2=1e-4)]
    res = launch.run(workers.sweep_group, 2, base_cfg(epochs=1), combos,
                     train, test, 2, device="cpu")
    assert res[0].combos == res[1].combos == combos
    assert res[0].history == res[1].history
    assert [len(h) for h in res[0].history] == [1, 1]


KEYS = ("epoch", "train_loss", "test_fscore", "test_acc", "test_loss")


@pytest.mark.parametrize("dropout", [0.0, 0.4])
def test_a_config_in_a_group_equals_it_trained_alone(data, dropout):
    """Each config's history and final weights equal the same combo's
    ``Trainer.fit``, bit for bit: the same code on the same seeds (with
    dropout on as well, since config k's step i draws from the seed its
    run alone draws from)."""
    _, train, test = data
    cfg = base_cfg(dropout=dropout)
    combos = [dict(lr=3e-3, l2=1e-4, gamma=0.5),
              dict(lr=1e-4, l2=2e-4, gamma=1.0)]
    group = _group(cfg, combos)
    res = group.run(train, test, verbose=False)
    assert len(res.best_test_fscore) == 2
    for k, combo in enumerate(combos):
        solo = Trainer(dataclasses.replace(cfg, **combo), device="cpu")
        r = solo.fit(train, test, verbose=False)
        assert [{x: h[x] for x in KEYS} for h in r.history] == \
            res.history[k], (k, combo)
        assert r.best_epoch == res.best_epoch[k]
        assert r.best_test_fscore == res.best_test_fscore[k]
        got = group.trainers[k].model.state_dict()
        for name, w in solo.model.state_dict().items():
            assert torch.equal(got[name], w), name


def test_mixed_dropout_group_equals_static_groups(data):
    """A group whose configs differ in dropout against groups with the
    rate folded into the shared config, slot for slot; a rate-0 config
    beside a rate-0.4 one as well."""
    _, train, test = data
    lrs = (3e-3, 1e-4)
    mixed = _group(base_cfg(dropout=0.4),
                   [dict(lr=lrs[0], l2=1e-4, dropout=0.2),
                    dict(lr=lrs[1], l2=1e-4, dropout=0.4)])
    assert mixed.droprate == [0.2, 0.4]
    got = mixed.run(train, test, verbose=False)
    for k, dp in enumerate((0.2, 0.4)):
        static = _group(base_cfg(dropout=dp),
                        [dict(lr=lr, l2=1e-4) for lr in lrs])
        assert static.droprate is None
        assert static.run(train, test, verbose=False).history[k] == \
            got.history[k]
    zmixed = _group(base_cfg(epochs=1, dropout=0.4),
                    [dict(lr=lrs[0], l2=1e-4, dropout=0.0),
                     dict(lr=lrs[1], l2=1e-4, dropout=0.4)])
    zstatic = _group(base_cfg(epochs=1, dropout=0.0),
                     [dict(lr=lr, l2=1e-4) for lr in lrs])
    assert zmixed.run(train, test, verbose=False).history[0] == \
        zstatic.run(train, test, verbose=False).history[0]


def test_configs_diverge(data):
    """Different lr/gamma give different training curves."""
    _, train, test = data
    res = _group(base_cfg(), [dict(lr=3e-3, l2=1e-4, gamma=0.5),
                              dict(lr=1e-5, l2=1e-4, gamma=0.5)]).run(
        train, test, verbose=False)
    assert res.history[0] != res.history[1]


def test_resume_reproduces_the_straight_run(data, tmp_path):
    """2 epochs, cut, resumed to 4 equals 4 straight epochs exactly; a
    finished group skips and returns its saved result."""
    from mmdfn_torch.runtime import checkpoint as ckpt_lib

    _, train, test = data
    combos = [dict(lr=3e-3, l2=1e-4, gamma=0.5),
              dict(lr=1e-4, l2=2e-4, gamma=1.0, dropout=0.4)]
    straight_group = _group(base_cfg(epochs=4), combos)
    straight = straight_group.run(train, test, verbose=False)

    d = str(tmp_path / "group")
    _group(base_cfg(epochs=2), combos).run(train, test, verbose=False,
                                           save_dir=d)
    # a real preemption dies mid-run with only 'last' on disk
    (tmp_path / "group" / "final.pt").unlink()
    resumed_group = _group(base_cfg(epochs=4), combos)
    resumed = resumed_group.run(train, test, verbose=False, save_dir=d,
                                resume=True)
    assert resumed.history == straight.history
    assert resumed.best_test_fscore == straight.best_test_fscore
    assert resumed.best_epoch == straight.best_epoch
    for a, b in zip(resumed_group.trainers, straight_group.trainers):
        for name, w in b.model.state_dict().items():
            assert torch.equal(a.model.state_dict()[name], w), name
        assert a.optimizer.state_dict()["state"][0]["step"] == \
            b.optimizer.state_dict()["state"][0]["step"]

    assert ckpt_lib.has_checkpoint(d, "final")
    again = _group(base_cfg(epochs=4), combos).run(
        train, test, verbose=False, save_dir=d, resume=True)
    assert again.history == straight.history
    assert again.best_test_fscore == straight.best_test_fscore


@pytest.mark.parametrize("cut", [False, True], ids=["final", "last"])
def test_resume_refuses_a_wrong_group(data, tmp_path, cut):
    """A checkpoint written for another combo group is refused, whether
    the group finished ('final') or was cut ('last')."""
    _, train, test = data
    d = str(tmp_path / "group")
    _group(base_cfg(epochs=1), [dict(lr=3e-3, l2=1e-4)]).run(
        train, test, verbose=False, save_dir=d)
    if cut:
        (tmp_path / "group" / "final.pt").unlink()
    with pytest.raises(ValueError, match="different combo group"):
        _group(base_cfg(epochs=1), [dict(lr=1e-5, l2=1e-4)]).run(
            train, test, verbose=False, save_dir=d, resume=True)


def test_a_frozen_config_takes_no_step(data):
    """Patience 1: a config at lr 0 (its F-score and loss never improve)
    freezes after epoch 1 while a config that improves trains on; the
    frozen one keeps its rows (no train loss) and Adam counts none of its
    skipped steps."""
    _, train, test = data
    group = _group(base_cfg(epochs=4, patience=1),
                   [dict(lr=3e-3, l2=1e-4), dict(lr=0.0, l2=0.0)])
    res = group.run(train, test, verbose=False)
    losses = [[r["train_loss"] for r in rows] for rows in res.history]
    assert len(losses[1]) > 2 and losses[1][2:] == [None] * (
        len(losses[1]) - 2)
    assert None not in losses[0][:len(losses[1])]
    for k, rows in enumerate(losses):
        steps = group.trainers[k].optimizer.state_dict()["state"][0]["step"]
        assert int(steps) == 2 * sum(x is not None for x in rows)


@pytest.fixture(scope="module")
def jax_group(data):
    """JAX's ``VmapSweep`` at dropout 0 (2 configs, 2 epochs) and its
    init, computed once: its compile stays out of the other cases."""
    from mmdfn_tpu.data.datasets import IEMOCAPDataset as JIEMOCAPDataset

    path = data[0]
    combos = [dict(lr=3e-3, l2=1e-4, gamma=0.5),
              dict(lr=1e-4, l2=2e-4, gamma=1.0)]
    group = JVmapSweep(JConfig(**BASE), combos)
    params = group.trainer.init_state().params
    res = group.run(JIEMOCAPDataset(path, True).dialogues(),
                    JIEMOCAPDataset(path, False).dialogues(), verbose=False)
    return combos, params, res


def test_group_matches_jax_epoch_by_epoch(data, jax_group):
    """The first whole-run comparison of the port with JAX: the port's
    group from JAX's init (bridged) against JAX's group, every epoch's
    test F-score and accuracy equal, the losses within 1e-3 absolute
    (JAX's own budget for its vmapped against static runs is 2e-3)."""
    _, train, test = data
    combos, params, want = jax_group
    model = build_model(base_cfg(), params_from_jax(params))
    got = _group(base_cfg(), combos, model=model).run(train, test,
                                                      verbose=False)
    assert got.best_epoch == want.best_epoch
    assert got.best_test_fscore == want.best_test_fscore
    assert got.best_test_acc == want.best_test_acc
    for g_rows, w_rows in zip(got.history, want.history):
        assert len(g_rows) == len(w_rows) == 2
        for g, w in zip(g_rows, w_rows):
            assert g["epoch"] == w["epoch"]
            assert g["test_fscore"] == w["test_fscore"], (g, w)
            assert g["test_acc"] == w["test_acc"], (g, w)
            assert abs(g["train_loss"] - w["train_loss"]) <= 1e-3, (g, w)
            assert abs(g["test_loss"] - w["test_loss"]) <= 1e-3, (g, w)
