"""The port's grouped sweep (``mmdfn_torch/train/vmap_sweep.py``: one
batched step over the stacked configurations) against the JAX package's
``VmapSweep``: the partition of a grid into groups, the refusals, a group
sharded over two CPU ranks (held against the one-process group in
``tests/test_torch_parallel.py``), a config in a group against the same
config trained alone (bit for bit, dropout on too), resume, one whole
group run against JAX's on bridged weights, epoch by epoch; the batched
train and eval steps against JAX's vmapped steps, the stacked Adam
against torch Adam, each kernel's vmap rule, and every model the group
takes through the batched step."""

import dataclasses
from functools import partial

import pytest
import torch

import jax

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


# ---------------------------------------------------------------------------
# the batched step: K configurations as one step over stacked parameters

STEP_COMBOS = [dict(lr=3e-3, l2=1e-4, gamma=0.5),
               dict(lr=1e-3, l2=2e-4, gamma=1.0),
               dict(lr=1e-4, l2=0.0, gamma=0.5)]


@pytest.fixture(scope="module")
def jax_steps(data, jax_group):
    """JAX's vmapped train step twice and its eval step, K = 3 (mixed lr,
    l2, gamma; dropout 0), from its stacked init (``init_states``: the
    group's one init, ``jax_group``'s, broadcast): the init, the losses of
    each step, the stacked parameters after them, the eval losses and the
    log-probs of the stacked model on the first batch."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mmdfn_tpu.data.batching import BucketBatcher as JBatcher
    from mmdfn_tpu.data.datasets import IEMOCAPDataset as JIEMOCAPDataset
    from mmdfn_tpu.train.trainer import prepare_inputs as j_prepare
    from mmdfn_tpu.train.vmap_sweep import _adam_init

    cfg = JConfig(**BASE)
    group = JVmapSweep(cfg, STEP_COMBOS)
    init = jax.tree_util.tree_map(np.asarray, jax_group[1])
    K = len(STEP_COMBOS)
    params = fast_jit(lambda init: jax.tree_util.tree_map(
        lambda p: jnp.broadcast_to(p[None], (K,) + p.shape), init))(init)
    m, v, _ = fast_jit(_adam_init)(params)
    opt = (m, v, jnp.zeros((K,), jnp.float32))
    batches = list(JBatcher(JIEMOCAPDataset(data[0], True).dialogues(),
                            cfg.batch_size, cfg.info["n_speakers"],
                            cfg.buckets, shuffle=True,
                            seed=cfg.seed).epoch(0))[:2]
    losses, denoms = [], []
    for i, b in enumerate(batches):
        params, opt, loss, _ = group._train_step(
            params, opt, j_prepare(cfg, b), jax.random.PRNGKey(i),
            jnp.zeros(len(STEP_COMBOS)))
        losses.append(np.asarray(loss))
        # Adam's denominator sqrt(v_hat) of this step (step 1: |g + l2 p|),
        # copied before the next step donates the state
        denoms.append(jax.tree_util.tree_map(
            lambda v: np.sqrt(np.array(v, copy=True) / (1 - 0.999 ** (i + 1))),
            opt[1]))
    inputs = j_prepare(cfg, batches[0])
    eval_loss, _ = group._eval_step(params, inputs)
    logp = fast_jit(jax.vmap(lambda p: group.trainer.model.apply(
        {"params": p}, inputs["text"], inputs["qmask"], inputs["umask"],
        inputs["audio"], inputs["visual"], deterministic=True)))(params)
    stacked = jax.tree_util.tree_map(np.asarray, params)
    return (init, [b.label for b in batches], losses, stacked,
            np.asarray(eval_loss), np.asarray(logp), denoms)


def _port_batches(train, n=2):
    from mmdfn_torch.data.batching import BucketBatcher
    from mmdfn_torch.train.trainer import prepare_inputs

    cfg = base_cfg()
    return [(b, prepare_inputs(b, torch.device("cpu"))) for b in list(
        BucketBatcher(train, cfg.batch_size, cfg.info["n_speakers"],
                      cfg.buckets, shuffle=True, seed=cfg.seed).epoch(0))[:n]]


# the gradient gap, as a share of each tensor's gradient scale, that the
# parameter check allows Adam to amplify (the worst seen is 1.5e-6)
GRAD_GAP = 2e-6


def test_batched_train_and_eval_steps_match_jax(data, jax_steps):
    """The port's batched train step (one vmapped forward and backward of
    K = 3 stacked configurations, one stacked Adam update) from JAX's
    stacked init against JAX's vmapped ``_train_step``, 2 steps: losses
    within 1e-5 relative; each configuration's parameters within 1e-5 of
    each tensor's max |.|, plus, element by element, what Adam's step
    makes of a gradient gap of ``GRAD_GAP`` of the gradient's scale there
    (lr GRAD_GAP max(den) / den at each step, den JAX's sqrt(v_hat); at
    step 1 den is |g + l2 p|): the two sides order their sums differently,
    and where den is small Adam's step moves by a percent of lr (239 of
    1.28 M elements at lr 3e-3 lie beyond 1e-5 of scale, the worst 5.6e-5,
    all where den is under 1.3% of its tensor's largest).  At most 1 in
    1000 elements lie beyond 1e-5 of scale, and none beyond a tenth of the
    configuration's lr.  Then the batched eval step's log-probs within
    1e-4 of JAX's and its losses within 1e-5 relative of ``_eval_step``'s."""
    import jax
    import numpy as np

    _, train, _ = data
    init, labels, want_losses, want_params, want_eval, want_logp, denoms = \
        jax_steps
    cfg = base_cfg()
    group = _group(cfg, STEP_COMBOS,
                   model=build_model(cfg, params_from_jax(init)))
    batches = _port_batches(train)
    for (b, _), lab in zip(batches, labels):
        assert (b.label == lab).all()
    for i, (_, inputs) in enumerate(batches):
        got = group.step(inputs, 0, i, [True] * len(STEP_COMBOS))
        np.testing.assert_allclose([float(l) for l in got], want_losses[i],
                                   rtol=1e-5)
    for k, combo in enumerate(STEP_COMBOS):
        want = params_from_jax(jax.tree_util.tree_map(lambda x: x[k],
                                                      want_params))
        got = group.trainers[k].model.state_dict()
        dens = [params_from_jax(jax.tree_util.tree_map(lambda x: x[k], d))
                for d in denoms]
        n = beyond = 0
        for name, w in want.items():
            w = torch.as_tensor(np.asarray(w))
            err = (got[name] - w).abs()
            # Adam's step lr m / (den + 1e-8) turns a gradient gap of G of
            # the gradient's scale into lr G max(den) / den: the elements
            # where JAX's den is small take that much beyond 1e-5 of scale
            amp = sum(combo["lr"] * float(den.max()) / (den + 1e-8)
                      for den in (torch.as_tensor(np.asarray(d[name]))
                                  for d in dens))
            bar = 1e-5 * float(w.abs().max()) + GRAD_GAP * amp
            assert bool((err <= bar).all()), (k, name, float(
                ((err - bar) / amp).max()))
            assert float(err.max()) <= 0.1 * combo["lr"], (k, name)
            n += err.numel()
            beyond += int((err > 1e-5 * float(w.abs().max())).sum())
        assert beyond <= n // 1000, (k, beyond, n)
    with torch.no_grad():
        loss, logp = group._batched(batches[0][1], train=False)
    np.testing.assert_allclose(logp.numpy(), want_logp, atol=1e-4)
    np.testing.assert_allclose(loss.numpy(), want_eval, rtol=1e-5)


def test_stacked_adam_equals_torch_adam_on_each_slice():
    """``StackedAdam`` over K = 3 stacked parameters (per-config lr, l2,
    one of them 0) equals ``torch.optim.Adam`` on each configuration
    alone, bit for bit, over 3 steps; a configuration frozen for a step
    keeps its parameters, moments and step count; each configuration's
    state reads back in torch Adam's layout and loads into a fresh stack."""
    from mmdfn_torch.train.optim import StackedAdam

    g = torch.Generator().manual_seed(0)
    shapes = [(7, 5), (11,)]
    K, lr, l2 = 3, [3e-3, 1e-4, 1e-3], [1e-4, 2e-4, 0.0]
    init = [torch.randn(K, *s, generator=g) for s in shapes]
    stack = StackedAdam([p.clone().requires_grad_() for p in init], lr, l2)
    solos = []
    for k in range(K):
        ps = [p[k].clone().requires_grad_() for p in init]
        solos.append((ps, torch.optim.Adam(ps, lr=lr[k], weight_decay=l2[k])))
    for step in range(3):
        grads = [torch.randn(K, *s, generator=g) for s in shapes]
        active = [True, step != 1, True]
        before = [(p.detach()[1].clone(), m[1].clone(), v[1].clone())
                  for p, m, v in zip(stack.params, stack.exp_avg,
                                     stack.exp_avg_sq)]
        t_before = stack.steps[:, 1].copy()
        for p, gr in zip(stack.params, grads):
            p.grad = gr.clone()
        stack.step(active)
        for k, (ps, opt) in enumerate(solos):
            if active[k]:
                for p, gr in zip(ps, grads):
                    p.grad = gr[k].clone()
                opt.step()
        if not active[1]:
            for (p, m, v), a, b, c in zip(before, stack.params, stack.exp_avg,
                                          stack.exp_avg_sq):
                assert torch.equal(p, a.detach()[1])
                assert torch.equal(m, b[1]) and torch.equal(v, c[1])
            assert (stack.steps[:, 1] == t_before).all()
    fresh = StackedAdam([p.clone() for p in init], lr, l2)
    for k, (ps, opt) in enumerate(solos):
        for a, b in zip(stack.params, ps):
            assert torch.equal(a.detach()[k], b.detach()), k
        want, got = opt.state_dict(), stack.config_state_dict(k)
        assert got["param_groups"] == want["param_groups"]
        for i, st in want["state"].items():
            for name, v in st.items():
                assert torch.equal(got["state"][i][name], v), (k, i, name)
        fresh.load_config_state_dict(k, want)
    assert (fresh.steps == stack.steps).all()
    for a, b in zip(fresh.exp_avg_sq, stack.exp_avg_sq):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kernels", ["A and C", "B and D"])
def test_kernel_batching_rules_make_one_call_equal_to_solo_calls(
        kernels, monkeypatch):
    """Each kernel wrapper under ``torch.func.vmap`` over K = 3
    configurations (on the CPU: the plain version with a config axis)
    makes one call, whose outputs and gradients equal K solo calls bit
    for bit; kernels B and D with the rates {0, 0.2, 0.4} in that one
    call, and kernel B's serve forward under no_grad as well."""
    from torch.func import vmap

    from mmdfn_torch.nn.drop_override import make_drop_rate
    from mmdfn_torch.ops import bigru, gcnii

    g = torch.Generator().manual_seed(3)
    r = lambda *s: torch.randn(*s, generator=g) * 0.3
    K, B, L, H = 3, 3, 7, 100
    calls = []
    mod = bigru if kernels == "A and C" else gcnii
    inner = mod._forward
    monkeypatch.setattr(mod, "_forward", lambda *a, **kw: (
        calls.append(a[0].dim()), inner(*a, **kw))[1])
    if kernels == "A and C":
        mask = (torch.rand(B, L, generator=g) > 0.3).float()
        args = [r(K, B, L, 3 * H), r(K, B, L, 3 * H), r(K, 3 * H, H),
                r(K, 3 * H), r(K, 3 * H, H), r(K, 3 * H)]
        f = lambda xf, xb, wf, bf, wb, bb: bigru.bigru_layer_fwd(
            xf, xb, wf.t(), bf, wb.t(), bb, mask)
        solo = lambda k, a: f(*a)
        rate, dims = (), (0,) * 6
        dy = (r(K, B, L, H), r(K, B, L, H))
    else:
        N, nl = 11, 3
        rates = [0.0, 0.2, 0.4]
        theta = torch.log(0.5 / torch.arange(1, nl + 1) + 1.0)
        seed = torch.tensor([12345], dtype=torch.int64)
        h0 = torch.relu(r(K, B, N, H))
        args = [torch.rand(K, B, N, N, generator=g) / N, h0 * 1.25, h0,
                r(K, nl, 2 * H, H), r(K, H, 4 * H), r(K, H, 4 * H),
                r(K, 4 * H)]
        f = lambda adj, h, h0, W, ih, hh, b, rate=0.0: gcnii.gcnii_stack_fwd(
            adj, h, h0, W, theta, ih, hh, b, alpha=0.2, reason=True,
            rate=rate, seed=seed if isinstance(rate, tuple) or rate
            else None)
        solo = lambda k, a: f(*a, rate=rates[k])
        rate, dims = (make_drop_rate(rates),), (0,) * 8
        dy = r(K, B, N, H)
    args = [t.requires_grad_() for t in args]
    out = vmap(f, in_dims=dims)(*args, *rate)
    grads = torch.autograd.grad(out, args, dy)
    assert calls == [4], calls       # one call, with the config axis
    calls.clear()
    for k in range(K):
        a = [t[k].detach().requires_grad_() for t in args]
        want = solo(k, a)
        want_g = torch.autograd.grad(want, a, tuple(d[k] for d in dy)
                                     if isinstance(dy, tuple) else dy[k])
        for x, y in zip(out if isinstance(out, tuple) else (out,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(x[k], y), k
        for x, y in zip(grads, want_g):
            assert torch.equal(x[k], y), k
    calls.clear()
    with torch.no_grad():
        serve = vmap(f, in_dims=(0,) * len(args))(*args)
        assert calls == [4], calls
        for k in range(K):
            want = f(*(t[k] for t in args))
            for x, y in zip(serve if isinstance(serve, tuple) else (serve,),
                            want if isinstance(want, tuple) else (want,)):
                assert torch.equal(x[k], y), k


# every model the group takes (TFN's head, whose solo step alone takes
# 10 s on the CPU at these sizes, is left out): (id, config, bit for bit)
FAMILIES = [
    ("GDF", dict(graph_type="GDF", reason_flag=True), True),
    ("GF", dict(graph_type="GF"), True),
    ("GF2", dict(graph_type="GF2"), True),
    ("DeepGCN", dict(graph_type="DeepGCN", reason_flag=True), True),
    ("GCN3", dict(graph_type="GCN3"), True),
    ("relation", dict(graph_type="relation"), True),
    ("None", dict(graph_type="None"), True),
    ("mfn", dict(graph_type="GDF", mm_fusion_mthd="mfn"), False),
    ("gated", dict(graph_type="DeepGCN", mm_fusion_mthd="gated"), False),
    ("lmf_only", dict(graph_type="DeepGCN", mm_fusion_mthd="lmf_only"), True),
    ("early_fusion", dict(graph_type="DeepGCN", mm_fusion_mthd="concat",
                          reason_flag=True), True),
    ("single_relation", dict(graph_type="relation", multi_modal=False,
                             modals="l"), True),
    ("single_relation_dialogrnn", dict(graph_type="relation",
                                       multi_modal=False, modals="l",
                                       base_model="DialogRNN"), False),
    ("GRU", dict(graph_model=False, base_model="GRU"), True),
    ("LSTM", dict(graph_model=False, base_model="LSTM"), True),
    ("DialogRNN", dict(graph_model=False, base_model="DialogRNN"), False),
]


@pytest.mark.parametrize("kw,exact", [f[1:] for f in FAMILIES],
                         ids=[f[0] for f in FAMILIES])
def test_every_model_the_group_takes_runs_the_batched_step(data, kw, exact):
    """One batched step of a group of 2 (dropout 0.2 and 0.4 on the graph
    path, a dropout per configuration) against each configuration's solo
    step from the same weights on the same batch and seed: loss and every
    gradient bit for bit, except where the model applies ``torch.sigmoid``
    or ``tanh`` to a whole contiguous tensor (the MFN and gated heads'
    gates, the DialogueRNN's cells): there the CPU kernel's vectorised
    loop and its scalar tail fall on other elements once two
    configurations are stacked, a last-bit difference (loss within 1e-6
    relative, each gradient within 1e-5 of its max |.|).  Then one batched
    eval step gives each configuration finite metrics."""
    import math

    from mmdfn_torch.data.batching import BucketBatcher
    from mmdfn_torch.train.trainer import prepare_inputs

    _, train, _ = data
    cfg = ExperimentConfig(batch_size=4, Deep_GCN_nlayers=2, buckets=(16,),
                           dropout=0.3, seed=2021, **kw)
    combos = [dict(lr=3e-3, l2=1e-4, gamma=0.5),
              dict(lr=1e-4, l2=2e-4, gamma=1.0)]
    if cfg.graph_model:
        combos = [dict(c, dropout=d) for c, d in zip(combos, (0.2, 0.4))]
    group = _group(cfg, combos)
    batch = next(iter(BucketBatcher(train, 4, 2, (16,), shuffle=True,
                                    seed=2021).epoch(0)))
    inputs = prepare_inputs(batch, torch.device("cpu"))
    losses = group.step(inputs, 0, 0, [True, True])
    for k, combo in enumerate(combos):
        cfg_k = dataclasses.replace(group.cfg, **combo)
        solo = Trainer(cfg_k, device="cpu",
                       model=build_model(cfg_k, group._init))
        loss, _ = solo.train_step(inputs, solo.step_seed(0, 0))
        grads = [(n, p.grad, group.params[n].grad[k])
                 for n, p in solo.model.named_parameters()
                 if p.grad is not None]
        if exact:
            assert torch.equal(losses[k], loss), k
            for n, a, b in grads:
                assert torch.equal(a, b), (k, n)
        else:
            assert abs(float(losses[k] - loss)) <= 1e-6 * abs(float(loss))
            for n, a, b in grads:
                assert float((a - b).abs().max()) <= 1e-5 * float(
                    a.abs().max()), (k, n)
    for metrics in group.evaluate([(batch, inputs)]).values():
        assert math.isfinite(metrics.loss) and 0.0 <= metrics.fscore <= 100
