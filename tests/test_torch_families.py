"""Every multimodal graph family of the port against the JAX package: the
log-probs of each family and fusion head on bridged weights, the weight
bridge's round trip through ``mmdfn_tpu``'s reference-checkpoint importer,
three ``Trainer`` steps of GF2, DeepGCN, relation and 'None', and the
adjacency constructions the families add, each with its gradient."""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from mmdfn_tpu.config import ExperimentConfig as JConfig
from mmdfn_tpu.graph import adjacency as jadj
from mmdfn_tpu.models.dialogue_gnn import DialogueGNN as JDialogueGNN
from mmdfn_tpu.tools.import_torch_checkpoint import state_dict_to_params
from mmdfn_tpu.train import Trainer as JTrainer
from mmdfn_tpu.train.trainer import prepare_inputs as j_prepare_inputs

from mmdfn_torch.config import ExperimentConfig
from mmdfn_torch.data.batching import BucketBatcher
from mmdfn_torch.data.datasets import IEMOCAPDataset
from mmdfn_torch.data.synthetic import make_synthetic_iemocap_pickle
from mmdfn_torch.graph import adjacency as padj
from mmdfn_torch.train import Trainer
from mmdfn_torch.train.trainer import prepare_inputs
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


NL = 2    # GCNII layers of GF, GDF and DeepGCN; GF2 has its fixed 64
# XLA's CPU backend at its lowest optimisation level: the same operations,
# compiled in about two thirds of the time
fast_jit = partial(jax.jit, compiler_options=dict(
    xla_backend_optimization_level=0, xla_llvm_disable_expensive_passes=True))
DIMS = {"IEMOCAP": (100, 1582, 342, 2), "MELD": (600, 300, 342, 9)}


def _batch(rng, dataset, lengths, L):
    D_t, D_a, D_v, P = DIMS[dataset]
    B = len(lengths)
    umask = (np.arange(L)[None] < np.asarray(lengths)[:, None]).astype(
        np.float32)
    feats = [(rng.standard_normal((B, L, D)) * umask[..., None]).astype(
        np.float32) for D in (D_t, D_a, D_v)]
    qmask = np.eye(P, dtype=np.float32)[rng.integers(0, P, (B, L))]
    return feats, qmask * umask[..., None], umask


# family or head -> its config; each family in its default wiring, and the
# options and heads spread over them.  "jax first": the JAX package's
# importer has no mapping for the case's parameters (MMGCN's embeddings,
# attn2's SimpleAttention) or maps one it lacks (attn3 has none), so the
# weights go JAX -> port only; every other case also goes port -> JAX
# through it.  GF2's "single" and "window" graphs are held to JAX by the
# adjacency test below.
CASES = {
    "GF2": dict(graph_type="GF2"),
    "GF2-fc-no_residue": dict(graph_type="GF2", graph_construct="fc",
                              use_residue=False),
    "DeepGCN": dict(graph_type="DeepGCN"),
    "DeepGCN-reason-gated": dict(graph_type="DeepGCN", reason_flag=True,
                                 mm_fusion_mthd="gated"),
    "GCN3": dict(graph_type="GCN3"),
    "GCN3-lmf_only": dict(graph_type="GCN3", mm_fusion_mthd="lmf_only"),
    "relation": dict(graph_type="relation"),
    "relation-use_gcn-MELD": dict(graph_type="relation", use_gcn=True,
                                  dataset="MELD", windowp=2, windowf=-1),
    "relation-attn2-mfn": dict(graph_type="relation", edge_attn_type="attn2",
                               mm_fusion_mthd="mfn"),
    "relation-attn3-concat_only": dict(graph_type="relation",
                                       edge_attn_type="attn3",
                                       mm_fusion_mthd="concat_only"),
    "None": dict(graph_type="None"),
    "None-base_None-mfn_only": dict(graph_type="None", base_model="None",
                                    mm_fusion_mthd="mfn_only"),
    "GF-speaker-modal-mfn": dict(graph_type="GF", use_speaker=True,
                                 use_modal=True, mm_fusion_mthd="mfn"),
    "GDF-av_using_lstm": dict(graph_type="GDF", reason_flag=True,
                              av_using_lstm=True),
    # TFN's fusion tensor is 101^3 floats an utterance and its first layer
    # 309 M weights (1.2 GB): one dialogue of 4 turns
    "None-tfn_only": dict(graph_type="None", mm_fusion_mthd="tfn_only"),
}
JAX_FIRST = {"relation-attn2-mfn", "relation-attn3-concat_only",
             "GF-speaker-modal-mfn"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_family_logprobs_and_weight_bridge_match_jax(case):
    kw = dict(Deep_GCN_nlayers=NL, **CASES[case])
    cfg = ExperimentConfig(**kw)
    jm = JDialogueGNN.from_config(JConfig(**kw))
    rng = np.random.default_rng(len(case))
    lengths, L = ([4], 4) if "tfn" in case else ([8, 5], 8)
    (text, audio, visual), qmask, umask = _batch(rng, cfg.dataset, lengths,
                                                 L)
    args = (text, qmask, umask, audio, visual)
    model = build_model(cfg).eval()
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), *args, deterministic=True))["params"]
    if case in JAX_FIRST:
        params = jax.tree_util.tree_map(lambda s: rng.uniform(
            -0.1, 0.1, s.shape).astype(s.dtype), shapes)
        model.load_state_dict(params_from_jax(params))
    else:
        template = jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, s.dtype), shapes)
        # the port's state_dict under the reference's keys, read by the
        # JAX package's importer: every leaf of the JAX tree written
        params = state_dict_to_params(
            {k: v.numpy() for k, v in model.state_dict().items()}, template)
    # and back: the bridge gives the port's weights, key for key
    back, sd = params_from_jax(params), model.state_dict()
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    want = np.asarray(fast_jit(lambda p, *a: jm.apply(
        {"params": p}, *a, deterministic=True))(params, *args))
    with torch.inference_mode():
        got = model(*map(torch.from_numpy, args)).numpy()
    valid = umask > 0
    # f32 on both sides; summation order only (GF2: 64 layers)
    np.testing.assert_allclose(got[valid], want[valid], atol=1e-4)


@pytest.mark.parametrize("kw", [
    dict(graph_type="GF2", mm_fusion_mthd="mfn"),
    dict(graph_type="DeepGCN", mm_fusion_mthd="mfn"),
    dict(graph_type="GCN3", modals="al", mm_fusion_mthd="tfn_only")])
def test_heads_refuse_widths_they_do_not_take(kw):
    """The reference cannot run these either: MFN takes 3 x 300 features,
    and TFN and LMF fuse three modalities."""
    with pytest.raises(ValueError, match="mm_fusion_mthd"):
        build_model(ExperimentConfig(Deep_GCN_nlayers=NL, **kw))


@pytest.fixture(scope="module")
def pickle_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("iem") / "iem.pkl")
    make_synthetic_iemocap_pickle(path, n_train=7, n_test=3, min_len=3,
                                  max_len=12, seed=4)
    return path


@pytest.mark.parametrize("graph_type", ["GF2", "DeepGCN", "relation",
                                        "None"])
def test_three_trainer_steps_match_the_jax_trainer(pickle_path, graph_type):
    """Each family at dropout 0 (class weights, focal loss, Adam with
    coupled L2), B = 2, L <= 12, from the port's seeded weights bridged
    into the JAX tree: three steps' losses and the first step's gradients
    against the JAX ``Trainer``'s own model apply, loss and optimiser.
    GF2's entry h and anchor h0 are the same encoded nodes, so the port's
    stack backward returns two gradients for them that autograd adds."""
    kw = dict(dataset="IEMOCAP", graph_type=graph_type, Deep_GCN_nlayers=NL,
              reason_flag=graph_type == "DeepGCN", dropout=0.0, batch_size=2,
              class_weight=True, buckets=(12,))
    tr = Trainer(ExperimentConfig(**kw), device="cpu")
    jtr = JTrainer(JConfig(**kw))
    shapes = jax.eval_shape(lambda: jtr._init_variables(
        jax.random.PRNGKey(0), jtr._example_inputs()))["params"]
    template = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes)
    params = state_dict_to_params(
        {k: v.numpy() for k, v in tr.model.state_dict().items()}, template)
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
    key = jax.random.PRNGKey(0)
    jlosses, losses = [], []
    for i, b in enumerate(batches):
        state, jloss, jg = jstep(state, j_prepare_inputs(jtr.cfg, b),
                                 jax.random.fold_in(key, i))
        jlosses.append(float(jloss))
        loss, _ = tr.train_step(prepare_inputs(b, tr.device), seed=i)
        losses.append(float(loss))
        if i == 0:
            jgrads = jg
            grads = {k: p.grad.numpy().copy()
                     for k, p in tr.model.named_parameters()}
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    got = dict(jax.tree_util.tree_leaves_with_path(
        state_dict_to_params(grads, template)))
    want = jax.tree_util.tree_leaves_with_path(jgrads)
    assert len(got) == len(want)
    for path, w in want:
        w = np.asarray(w)
        scale = max(np.abs(w).max(), 1e-12)
        err = np.abs(got[path] - w).max()
        assert err <= 1e-4 * scale, (jax.tree_util.keystr(path), err, scale)


def _graphs(name):
    """(the port's graph function, the JAX one) of (feats list, qmask,
    umask)."""
    if name == "mm_big-arccos":
        kw = dict(variant="arccos", cross_constant=0.99999)
        return (lambda f, q, u: padj.mm_big_adjacency(f, u, **kw),
                lambda f, q, u: jadj.mm_big_adjacency(f, u, **kw))
    if name == "mm_big-angular-weighted":
        return (lambda f, q, u: padj.mm_big_adjacency(f, u, modal_weight=0.7),
                lambda f, q, u: jadj.mm_big_adjacency(f, u, modal_weight=0.7))
    if name.startswith("mm_wo_speaker"):
        scheme = name.split("-")[1]
        return (lambda f, q, u: padj.mm_wo_speaker_adjacency(
                    f, u, scheme=scheme),
                lambda f, q, u: jadj.mm_wo_speaker_adjacency(
                    f, u, scheme=scheme))
    if name == "gcnii_block":
        return (lambda f, q, u: padj.gcnii_block_adjacency(f[0], u),
                lambda f, q, u: jadj.gcnii_block_adjacency(f[0], u))
    return (lambda f, q, u: padj.directed_speaker_adjacency(f[0], q, u),
            lambda f, q, u: jadj.directed_speaker_adjacency(
                f[0], q, u, normalize=False))


@pytest.mark.parametrize("name,speakers", [
    ("mm_big-arccos", 2), ("mm_big-angular-weighted", 2),
    ("mm_wo_speaker-single", 2), ("mm_wo_speaker-window", 2),
    ("mm_wo_speaker-fc", 2), ("gcnii_block", 2), ("directed_speaker", 2),
    ("directed_speaker", 9)])
def test_adjacency_graphs_and_their_gradients_match_jax(name, speakers):
    rng = np.random.default_rng(speakers)
    # L past the cross-modal window of 10 on both sides
    B, L, D = 3, 24, 6
    umask = (np.arange(L)[None] < np.array([[24], [13], [1]])).astype(
        np.float32)
    feats = [(rng.standard_normal((B, L, D)) * umask[..., None]).astype(
        np.float32) for _ in range(3)]
    feats[0][0, 3] = feats[0][0, 5]          # a cosine of exactly 1
    qmask = np.eye(speakers, dtype=np.float32)[
        rng.integers(0, speakers, (B, L))] * umask[..., None]
    port, ref = _graphs(name)
    N = (3 if name.startswith("mm_") else 1) * L
    R = rng.standard_normal((B, N, N)).astype(np.float32)

    jref = lambda fs: ref(fs, jnp.asarray(qmask), jnp.asarray(umask))
    want, jgrads = fast_jit(lambda fs: (jref(fs), jax.grad(
        lambda f: jnp.sum(jref(f) * R))(fs)))([jnp.asarray(f) for f in feats])
    want = np.asarray(want)
    ts = [torch.from_numpy(f).requires_grad_() for f in feats]
    got = port(ts, torch.from_numpy(qmask), torch.from_numpy(umask))
    # f32 cosines on both sides; arccos' slope near +/-1 (self-similarity,
    # a planted pair of equal rows) amplifies their last-bit rounding:
    # 1e-5 as in test_torch_data.py's adjacency test for 1 - arccos/pi,
    # pi times that for GF2's raw arccos (a lone utterance's self-cosine
    # rounds to 1 + 1.2e-7 in torch and to 1 in JAX: 1.33e-5 here)
    tol = 1e-5 * (np.pi if name == "mm_big-arccos" else 1.0)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=tol)
    (got * torch.from_numpy(R)).sum().backward()
    for t, g in zip(ts, jgrads):
        g = np.asarray(g)
        if t.grad is None:               # an input the graph never reads
            assert not np.any(g)
            continue
        scale = max(np.abs(g).max(), 1.0)
        np.testing.assert_allclose(t.grad.numpy(), g, atol=1e-4 * scale)


def test_a_config_saved_before_the_family_fields_loads_with_defaults(
        tmp_path):
    """A checkpoint written before the family fields existed (its saved
    config lacks them) restores with their defaults: the GDF model."""
    import dataclasses

    from mmdfn_torch.runtime import checkpoint as ckpt_lib
    from mmdfn_torch.weights import load_served

    cfg = ExperimentConfig(Deep_GCN_nlayers=1, reason_flag=True)
    old = {k: v for k, v in dataclasses.asdict(cfg).items()
           if k not in ("multi_modal", "graph_model", "graph_construct",
                        "use_gcn", "nodal_attention", "av_using_lstm",
                        "windowp", "windowf", "edge_attn_type")}
    model = build_model(cfg)
    ckpt_lib.save_checkpoint(str(tmp_path), model,
                             meta={"epoch": 0, "config": old})
    got, served, epoch = load_served(str(tmp_path))
    assert got == cfg and epoch == 0
    for k, v in model.state_dict().items():
        assert torch.equal(served.state_dict()[k], v)
