"""The port's multi-device layer against the JAX package's: the node-sharded
products and GCNII stack (``parallel/graph_parallel.py``), ``MMGCN`` with
the sharded product, the data-parallel ``Trainer`` and its 2 x 2 (data x
model) step, the data-parallel ``DailyTrainer``, the sharded ``VmapSweep``,
the training CLI over two ranks, and the dropout seeds of data and model
ranks.

The port's side runs on CPU ranks over gloo (``runtime/launch.py``; the
rank functions are ``mmdfn_torch/parallel/workers.py``, so no rank imports
JAX), the JAX side on the 8-device virtual CPU mesh of
``tests/conftest.py``.  One group of ranks runs several checks: a group of
2 for the products, ``MMGCN``, the data-parallel steps and the sweep, and
one of 4 for the 2 x 2 steps.  Both groups start with the module, in
threads of this process, beside the three compiles of JAX's meshed steps,
so that the ranks run while JAX compiles."""

import json
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmdfn_tpu.config import ExperimentConfig as JConfig
from mmdfn_tpu.models.mm_gcn import MMGCN as JMMGCN
from mmdfn_tpu.parallel import sharded_gcnii_stack as j_sharded_gcnii_stack
from mmdfn_tpu.parallel import sharded_spmm as j_sharded_spmm
from mmdfn_tpu.parallel import sharded_spmm_batched as j_sharded_spmm_batched
from mmdfn_tpu.runtime.mesh import make_mesh as j_make_mesh
from mmdfn_tpu.tools.import_torch_checkpoint import state_dict_to_params
from mmdfn_tpu.train import Trainer as JTrainer
from mmdfn_tpu.train.daily_trainer import DailyTrainer as JDailyTrainer

from mmdfn_torch.cli import run_train_erc
from mmdfn_torch.config import ExperimentConfig
from mmdfn_torch.data.batching import BucketBatcher, TokenBucketBatcher
from mmdfn_torch.data.datasets import DailyDialogueDataset, IEMOCAPDataset
from mmdfn_torch.data.synthetic import (make_synthetic_daily_pickle,
                                        make_synthetic_iemocap_pickle)
from mmdfn_torch.models import from_config
from mmdfn_torch.parallel import workers
from mmdfn_torch.runtime import checkpoint as ckpt_lib
from mmdfn_torch.runtime import launch
from mmdfn_torch.train.vmap_sweep import VmapSweep
from mmdfn_torch.weights import build_model, gcnii_from_jax, params_from_jax


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # small tensors: with several test workers on a few cores, one torch
    # thread per core makes every op wait for the others; spawned ranks
    # take this process's count over the ranks (at least one)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


NL, B, L = 2, 4, 8
KW = dict(dataset="IEMOCAP", graph_type="GDF", reason_flag=True,
          Deep_GCN_nlayers=NL, dropout=0.0, batch_size=B, class_weight=True,
          buckets=(L,))
SEEDS = [0, 1]
DAILY_KW = dict(dataset="DailyDialogue", base_model="GRU", batch_size=B,
                buckets=(12,), vocab_size=80, max_words=14, embedding_dim=16,
                cnn_filters=8, cnn_output_size=24, windowp=3, windowf=3,
                dropout=0.0, rec_dropout=0.0)
COMBOS = [dict(lr=1e-3, l2=1e-4, dropout=0.0),
          dict(lr=3e-3, l2=1e-4, dropout=0.4),
          dict(lr=1e-3, l2=2e-4, gamma=1.0, dropout=0.4)]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """6 training dialogues in batches of 4: the second batch holds 2
    dialogues and 2 rows of padding, so data rank 1's block of it is
    padding alone."""
    path = str(tmp_path_factory.mktemp("iem") / "iem.pkl")
    make_synthetic_iemocap_pickle(path, n_train=6, n_test=3, min_len=3,
                                  max_len=L, seed=4)
    train = IEMOCAPDataset(path, train=True).dialogues()
    test = IEMOCAPDataset(path, train=False).dialogues()
    batches = list(BucketBatcher(train, B, 2, (L,)).epoch(0))
    assert len(batches) == 2 and batches[1].umask[2:].sum() == 0
    return path, train, test, batches


@pytest.fixture(scope="module")
def daily(tmp_path_factory):
    """DailyDialogue at small word-level widths: 6 training dialogues in
    batches of 4 (data rank 1's block of the second is padding alone),
    uniform JAX weights from a seed and the port's model on them, its
    TextCNN's fixed 0.5 dropout set to 0 as JAX's deterministic step
    has it."""
    path = str(tmp_path_factory.mktemp("daily") / "daily.pkl")
    make_synthetic_daily_pickle(path, n_per_split=(6, 3, 4), min_len=3,
                                max_len=10, max_words=12, vocab_size=80,
                                seed=3)
    cfg = ExperimentConfig(**DAILY_KW)
    batches = list(TokenBucketBatcher(
        DailyDialogueDataset("train", path).dialogues(), B, cfg.max_words,
        cfg.buckets, n_speakers=cfg.info["n_speakers"]).epoch(0))
    assert len(batches) == 2 and batches[1].umask[2:].sum() == 0
    jtr = JDailyTrainer(JConfig(**DAILY_KW))
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map(
        lambda s: rng.uniform(-0.1, 0.1, s.shape).astype(s.dtype),
        jax.eval_shape(lambda: jtr._init_variables(
            jax.random.PRNGKey(0), jtr._example_inputs()))["params"])
    model = from_config(cfg)
    model.cnn_feat_extractor.dropout = 0.0
    model.load_state_dict(params_from_jax(params))
    return batches, params, model


def _products_inputs():
    rng = np.random.default_rng(0)
    N, H, nl = 24, 16, 3
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    ins = dict(adj=f(N, N) / N, h=np.abs(f(N, H)), h0=np.abs(f(N, H)),
               W=f(nl, 2 * H, H) * 0.3, W_plain=f(nl, H, H) * 0.3,
               theta=np.log(0.5 / np.arange(1, nl + 1) + 1.0)
               .astype(np.float32), alpha=0.2,
               adj_b=[f(3, n, n) for n in (24, 21)],
               h_b=[f(3, n, H) for n in (24, 21)],
               g_b=[f(3, n, H) for n in (24, 21)])
    return ins


def _mmgcn_inputs():
    rng = np.random.default_rng(1)
    Bm, Lm = 2, 8                  # N = 3 * 8 = 24
    feats = {m: rng.standard_normal((Bm, Lm, 200)).astype(np.float32)
             for m in "avl"}
    umask = np.ones((Bm, Lm), np.float32)
    umask[1, 5:] = 0.0
    qmask = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (Bm, Lm))]
    qmask *= umask[..., None]
    kw = dict(n_dim=200, nlayers=3, nhidden=100, reason_flag=True)
    jmodel = JMMGCN(**kw, nclass=6, dropout=0.0)
    jparams = jmodel.init(jax.random.PRNGKey(0),
                          {m: jnp.asarray(v) for m, v in feats.items()},
                          jnp.asarray(qmask), jnp.asarray(umask),
                          deterministic=True)["params"]
    sd = {k: v.contiguous()
          for k, v in gcnii_from_jax(jparams["graph_net"], "graph_net.")
          .items()}
    return kw, jmodel, jparams, sd, feats, qmask, umask


def _duplicated(batch):
    """The batch with its first half copied over its second, so that both
    data ranks of a 2-rank mesh hold the same dialogues."""
    import dataclasses
    h = batch.umask.shape[0] // 2
    return dataclasses.replace(batch, **{
        k: np.concatenate([getattr(batch, k)[:h]] * 2)
        for k in ("text", "audio", "visual", "qmask", "umask", "label")})


def _jobs2(data, daily):
    """The group of 2 CPU ranks: the products and MMGCN on a (1, 2) mesh,
    two data-parallel steps on (2, 1), the training forward at dropout
    0.4 on duplicated data, the sweep's group sharded over 2, and two
    data-parallel DailyDialogue steps."""
    _, train, test, batches = data
    mm = _mmgcn_inputs()
    cfg = ExperimentConfig(**KW)
    return [
        (workers.graph_products, _products_inputs()),
        (workers.mmgcn_forward, dict(kwargs=mm[0], state_dict=mm[3],
                                     feats=mm[4], qmask=mm[5],
                                     umask=mm[6])),
        (workers.trainer_steps, dict(cfg=cfg, n_data=2, n_model=1,
                                     batches=batches, seeds=SEEDS)),
        (workers.trainer_steps, dict(
            cfg=ExperimentConfig(**{**KW, "dropout": 0.4}), n_data=2,
            n_model=1, batches=[_duplicated(batches[0])], seeds=[],
            logits_seed=7)),
        (workers.sweep_group, dict(
            base_cfg=ExperimentConfig(**{**KW, "epochs": 2}),
            combos=COMBOS, train=train, test=test, n_data=2)),
        (workers.trainer_steps, dict(
            cfg=ExperimentConfig(**DAILY_KW), n_data=2, n_model=1,
            batches=daily[0], seeds=SEEDS, model=daily[2])),
    ]


def _jobs4(data):
    """The group of 4 CPU ranks on a (2, 2) mesh: two steps at dropout 0,
    and the training forward at dropout 0.4 on duplicated data."""
    batches = data[3]
    return [
        (workers.trainer_steps, dict(cfg=ExperimentConfig(**KW), n_data=2,
                                     n_model=2, batches=batches,
                                     seeds=SEEDS)),
        (workers.trainer_steps, dict(
            cfg=ExperimentConfig(**{**KW, "dropout": 0.4}), n_data=2,
            n_model=2, batches=[_duplicated(batches[0])], seeds=[],
            logits_seed=7)),
    ]


@pytest.fixture(scope="module")
def groups(data, daily):
    """Futures of the two groups' results (2 ranks, 4 ranks), of JAX's
    two steps on its (2, 1) and (2, 2) meshes, and of its DailyDialogue
    steps on (2, 1)."""
    with ThreadPoolExecutor(5) as pool:
        yield (pool.submit(launch.run, workers.run_jobs, 2,
                           _jobs2(data, daily), device="cpu"),
               pool.submit(launch.run, workers.run_jobs, 4, _jobs4(data),
                           device="cpu"),
               pool.submit(_jax_steps, KW, j_make_mesh(n_data=2), data[3]),
               pool.submit(_jax_steps, KW, j_make_mesh(n_data=2, n_model=2),
                           data[3]),
               pool.submit(_jax_daily_steps, j_make_mesh(n_data=2),
                           daily[0], daily[1]))


def _by_model_rank(results, job):
    parts = sorted((r[job]["rank"], r[job]) for r in results)
    return [p for _, p in parts]


def test_sharded_products_and_stack_match_jax(groups):
    """``sharded_spmm``, ``sharded_spmm_batched`` (N = 24 and a ragged 21)
    and ``sharded_gcnii_stack`` (variant and not) on 2 model ranks against
    JAX's on a model-axis-2 mesh; the hook's gradients of ``adj`` and
    ``h`` against the dense ``bmm``'s, on every rank."""
    ins = _products_inputs()
    mesh = j_make_mesh(n_data=1, n_model=2)
    J = jnp.asarray
    want_spmm = j_sharded_spmm(mesh, J(ins["adj"]), J(ins["h"]))
    want_stack = {key: j_sharded_gcnii_stack(
        mesh, J(ins["adj"]), J(ins["h"]), J(ins["h0"]), J(W),
        J(ins["theta"]), alpha=ins["alpha"], variant=variant)
        for key, W, variant in (("stack", ins["W"], True),
                                ("stack_plain", ins["W_plain"], False))}
    want_batched = [j_sharded_spmm_batched(mesh, J(a), J(x))
                    for a, x in zip(ins["adj_b"], ins["h_b"])]
    ranks = _by_model_rank(groups[0].result(), 0)
    got = np.concatenate([r["spmm"] for r in ranks])
    np.testing.assert_allclose(got, np.asarray(want_spmm), atol=1e-5)
    for key, want in want_stack.items():
        got = np.concatenate([r[key] for r in ranks])
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5,
                                   err_msg=key)
    for c, want in enumerate(want_batched):
        want = np.asarray(want)
        for r in ranks:
            (y, dadj, dh), (yd, dadj_d, dh_d) = (r["batched"][c]["hook"],
                                                 r["batched"][c]["dense"])
            np.testing.assert_allclose(y, want, atol=1e-5)
            np.testing.assert_allclose(y, yd, atol=1e-5)
            np.testing.assert_allclose(dadj, dadj_d, atol=1e-5)
            np.testing.assert_allclose(dh, dh_d, atol=1e-5)


def test_mmgcn_with_the_sharded_product_matches_jax_dense(groups):
    """``MMGCN`` (MM-DFN's core, reason-LSTM, 3 layers) with its GCNII
    stack through the node-sharded product on 2 model ranks against JAX's
    dense ``MMGCN`` on bridged weights; both ranks give the whole output."""
    kw, jmodel, jparams, _, feats, qmask, umask = _mmgcn_inputs()
    want = np.asarray(jmodel.apply(
        {"params": jparams}, {m: jnp.asarray(v) for m, v in feats.items()},
        jnp.asarray(qmask), jnp.asarray(umask), deterministic=True))
    for r in groups[0].result():
        np.testing.assert_allclose(r[1], want, atol=2e-5)


def _jax_steps(cfg_kw, mesh, batches):
    """Two steps of JAX's meshed ``Trainer`` (its model apply, loss and
    Adam, the inputs sharded by its ``_put``) from the port's seeded
    weights, bridged: the losses, the first step's gradients and the
    tree template."""
    cfg = ExperimentConfig(**cfg_kw)
    jtr = JTrainer(JConfig(**cfg_kw), mesh=mesh)
    shapes = jax.eval_shape(lambda: jtr._init_variables(
        jax.random.PRNGKey(0), jtr._example_inputs()))["params"]
    template = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes)
    params = state_dict_to_params(
        {k: v.numpy() for k, v in build_model(cfg).state_dict().items()},
        template)
    losses, grads = _run_jax_steps(jtr, params, batches)
    return losses, grads, template


def _run_jax_steps(jtr, params, batches):
    """JAX's step (model apply, loss, Adam) on each batch from ``params``,
    the inputs sharded by the trainer's ``_put``: the losses and the first
    step's gradients."""
    import optax

    state = (params, jtr.tx.init(params))

    # XLA's CPU backend at its lowest optimisation level: the same
    # operations, compiled in about two thirds of the time
    @partial(jax.jit, compiler_options=dict(
        xla_backend_optimization_level=0,
        xla_llvm_disable_expensive_passes=True))
    def jstep(state, inputs):
        p, opt = state
        loss, grads = jax.value_and_grad(lambda q: jtr._loss(
            jtr._apply_model(q, inputs, True), inputs["label"],
            inputs["umask"]))(p)
        updates, opt = jtr.tx.update(grads, opt, p)
        return (optax.apply_updates(p, updates), opt), loss, grads

    losses = []
    for i, b in enumerate(batches):
        state, loss, g = jstep(state, jtr._put(jtr._prepare(b)))
        losses.append(float(loss))
        if i == 0:
            grads = g
    return losses, grads


def _jax_daily_steps(mesh, batches, params):
    """Two steps of JAX's ``DailyTrainer`` on ``mesh`` from ``params``:
    the losses and the first step's gradients in the port's names."""
    jtr = JDailyTrainer(JConfig(**DAILY_KW), mesh=mesh)
    losses, grads = _run_jax_steps(jtr, params, batches)
    return losses, params_from_jax(grads)


def _hold_to_jax(results, job, jax_steps):
    """Every rank's losses (job ``job`` of a group's ``results`` future)
    within 1e-5 relative of JAX's (``jax_steps``, a future of
    :func:`_jax_steps`), its first-step gradients within 1e-4 of each JAX
    gradient's max abs, and every rank's gradients equal to rank 0's;
    returns the ranks' results."""
    jlosses, jgrads, template = jax_steps.result()
    want = jax.tree_util.tree_leaves_with_path(jgrads)
    results = [r[job] for r in results.result()]
    for r in results:
        np.testing.assert_allclose(r["losses"], jlosses, rtol=1e-5)
        got = dict(jax.tree_util.tree_leaves_with_path(
            state_dict_to_params(r["grads"], template)))
        assert len(got) == len(want)
        for path, w in want:
            w = np.asarray(w)
            scale = max(np.abs(w).max(), 1e-12)
            err = np.abs(got[path] - w).max()
            assert err <= 1e-4 * scale, (jax.tree_util.keystr(path), err)
        for n, g in r["grads"].items():
            np.testing.assert_array_equal(g, results[0]["grads"][n])
    return results


def test_data_parallel_trainer_matches_jax_meshed_trainer(groups):
    """The flagship (GDF, reason-LSTM, class weights, focal loss) at
    dropout 0 on 2 data ranks: two steps against JAX's ``Trainer`` on a
    2-device data mesh.  The second batch leaves data rank 1 a block of
    padding alone, which must add nothing but still take part."""
    results = _hold_to_jax(groups[0], 2, groups[2])
    assert [(r["data_rank"], r["model_rank"]) for r in results] == \
        [(0, 0), (1, 0)]


def test_data_parallel_daily_trainer_matches_jax_meshed_daily_trainer(
        groups):
    """DailyDialogue's ``DailyTrainer`` (token batches, the GRU base, the
    focal loss over the whole batch's mask) at dropout 0 on 2 data ranks:
    two steps against JAX's ``DailyTrainer`` on a 2-device data mesh, the
    TextCNN's table among the gradients.  The second batch leaves data
    rank 1 a block of padding alone."""
    jlosses, want = groups[4].result()
    results = [r[5] for r in groups[0].result()]
    assert [r["data_rank"] for r in results] == [0, 1]
    for r in results:
        np.testing.assert_allclose(r["losses"], jlosses, rtol=1e-5)
        assert r["grads"].keys() == want.keys()
        for n, w in want.items():
            w = w.numpy()
            scale = max(np.abs(w).max(), 1e-12)
            err = np.abs(r["grads"][n] - w).max()
            assert err <= 1e-4 * scale, (n, err)
            np.testing.assert_array_equal(r["grads"][n],
                                          results[0]["grads"][n])


def _step_with_a_parameter_out_of_the_graph(cfg, batch):
    from mmdfn_torch.runtime.mesh import make_mesh
    from mmdfn_torch.train import Trainer

    tr = Trainer(cfg, device="cpu", mesh=make_mesh(1))
    tr.model.register_parameter("unused", torch.nn.Parameter(torch.zeros(1)))
    tr.train_step(tr._put(batch), 0)


def test_a_parameter_without_a_gradient_fails_the_data_parallel_step(data):
    """The gradients' flat all-reduce needs every trained parameter's
    gradient on every rank: a parameter the step leaves without one fails
    the step by name (here on a group of one rank, in this process)."""
    with pytest.raises(RuntimeError,
                       match=r"no gradient reached \['unused'\]"):
        launch.run(_step_with_a_parameter_out_of_the_graph, 1,
                   ExperimentConfig(**KW), data[3][0])


def test_data_and_model_parallel_step_matches_jax_2x2(groups):
    """The same two steps on a 2 x 2 (data x model) mesh of 4 ranks, the
    GCNII stack node-sharded over each model pair, against JAX's
    ``Trainer`` on a 2 x 2 mesh."""
    results = _hold_to_jax(groups[1], 0, groups[3])
    assert sorted((r["data_rank"], r["model_rank"]) for r in results) == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    # the node-sharded stack runs its plain version: no kernel counted
    assert all(r["launches"]["gcnii_fwd"] == 0 for r in results)


def test_dropout_masks_differ_over_data_ranks_and_agree_over_model_ranks(
        groups):
    """At dropout 0.4, on data ranks that hold the same dialogues, the
    training forward differs between the two data ranks (each folds its
    rank into the step seed) and is the same, bit for bit, on the two
    model ranks of a data rank; data rank 0's draws are the seed's own."""
    dp = [r[3] for r in groups[0].result()]
    assert not np.allclose(dp[0]["logits"], dp[1]["logits"])
    by = {(r[1]["data_rank"], r[1]["model_rank"]): r[1]["logits"]
          for r in groups[1].result()}
    for d in (0, 1):
        np.testing.assert_array_equal(by[(d, 0)], by[(d, 1)])
    assert not np.allclose(by[(0, 0)], by[(1, 0)])
    # the two meshes draw data rank 0's masks from the same seed
    np.testing.assert_allclose(by[(0, 0)], dp[0]["logits"], atol=1e-5)


def test_sharded_sweep_equals_the_one_process_group(groups, data):
    """A group of K = 3 configs (dropout 0 and 0.4, lr, l2, gamma) over 2
    data ranks (2 configs and 1): every config's history and selection
    equal the one-process group's, bit for bit, on both ranks."""
    _, train, test, _ = data
    want = VmapSweep(ExperimentConfig(**{**KW, "epochs": 2}), COMBOS,
                     device="cpu").run(train, test, verbose=False)
    for r in groups[0].result():
        got = r[4]
        assert got.combos == want.combos
        assert got.history == want.history
        assert got.best_epoch == want.best_epoch
        assert got.best_test_fscore == want.best_test_fscore


def test_training_cli_over_two_ranks_writes_one_servable_checkpoint(
        data, tmp_path, monkeypatch, capfd):
    """``--device cpu --n_data_devices 2``: one epoch over two ranks, its
    lines printed once (by the first rank), one ``best`` checkpoint whose
    keys carry no wrapper prefix, restored into a plain model and served
    by ``cli/serve.py``."""
    import io

    from mmdfn_torch.cli import serve
    from mmdfn_torch.models import DialogueGNN

    pkl, save = data[0], str(tmp_path / "ckpts")
    assert run_train_erc.main([
        "--device", "cpu", "--epochs", "1", "--data_dir", pkl,
        "--Deep_GCN_nlayers", str(NL), "--reason_flag", "--batch-size",
        str(B), "--buckets", str(L), "--save_model_dir", save,
        "--n_data_devices", "2"]) == 0
    assert capfd.readouterr().out.count("epoch: 0, train_loss: ") == 1
    blob = torch.load(f"{save}/best.pt", weights_only=True)
    assert not [k for k in blob["model"] if k.startswith("module.")]
    cfg = ExperimentConfig(**blob["meta"]["config"])
    model, _ = ckpt_lib.restore_checkpoint(save, DialogueGNN.from_config(cfg))
    assert model.state_dict().keys() == blob["model"].keys()
    d = data[2][0]
    lines = [json.dumps({"text": d.text[t].tolist(),
                         "audio": d.audio[t].tolist(),
                         "visual": d.visual[t].tolist(),
                         "speaker": int(d.qmask[t].argmax())})
             for t in range(2)]
    monkeypatch.setattr("sys.stdin", io.StringIO("\n".join(lines) + "\n"))
    assert serve.main(["--load_model", save, "--device", "cpu",
                       "--buckets", "4"]) == 0
    out = [json.loads(l) for l in capfd.readouterr().out.splitlines()]
    assert out[0]["ready"] and len(out) == 3
    assert all(np.isfinite(o["log_probs"]).all() for o in out[1:])
